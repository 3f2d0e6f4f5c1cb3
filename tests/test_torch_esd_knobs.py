"""The port's ESD knobs (``train/esd.py``, ``train/trainer.py``) against the
JAX package's, on tiny-xl (64px, Euler-A, ``max_denoising_steps`` 3, fp32)
from the same UNet weights, LoRA factors, prompt embeddings and random draws
— the port's draws derived from the JAX keys as the JAX step derives them:

* ``samples_per_step`` 2: fused on the row axis (batch 1, with
  ``dynamic_crops`` and ``train.cfg`` 2) and the one-sample loop (batch 2);
  loss, grad norm and every factor within 2e-4 (``share_warmup``,
  ``fuse_teacher_student``, ``pipeline_warmup`` and the checkpointed
  student: ``tests/test_torch_esd_fuse_pipeline.py``);
* the JAX refusals of invalid combinations raise the same exception type.

``draw_time_ids``, the resolution buckets, the knobs through the trainer,
``profile_dir``, ``pipeline_warmup`` at lr 0 and the checkpointed student:
``tests/test_torch_esd_knobs_port.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from test_torch_train import MAX_STEPS, STEP_TOL, slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTE = dict(student_overlay=True, overlay_warmup=False)  # the trainers' default LoRA route
SIZE = 64


def _noise(key, n, shape):
    """The per-step scheduler noise of a loop of ``n`` steps from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype=jnp.float32)))
    return torch.from_numpy(np.stack(out)) if out else torch.zeros((0,) + shape)


def _crop_uniforms(key):
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 7), 3)
    return [float(jax.random.uniform(k)) for k in (k1, k2, k3)]


def _sample_draws(key, schedule, n_pairs, b=1, crops=False):
    """One sample's draws as ``warm_draw`` makes them from ``key``."""
    k_pair, k_t, k_noise, k_warm = jax.random.split(key, 4)
    pair = int(jax.random.randint(k_pair, (), 0, n_pairs))
    t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS))
    lat0 = np.array(jsampling.get_initial_latents(k_noise, schedule, b, SIZE, SIZE))
    tids = torch.from_numpy(tesd.draw_time_ids(*_crop_uniforms(key), SIZE, SIZE)) if crops else None
    return tesd.Draws(pair, t_to, torch.from_numpy(lat0), _noise(k_warm, t_to, lat0.shape), tids)


def _fused_draws(key, schedule, n_pairs, s, crops=False, share=False):
    """S samples' draws as ``fused_samples_loss`` makes them from ``key``."""
    pairs, t_to, lat = [], [], []
    for k in jax.random.split(key, s):
        k_pair, k_t, k_noise, _ = jax.random.split(k, 4)
        pairs.append(int(jax.random.randint(k_pair, (), 0, n_pairs)))
        t_to.append(int(jax.random.randint(k_t, (), 1, MAX_STEPS)))
        lat.append(np.array(jsampling.get_initial_latents(k_noise, schedule, 1, SIZE, SIZE))[0])
    lat = np.stack(lat)
    tids = None
    if crops:
        tids = torch.from_numpy(np.concatenate([tesd.draw_time_ids(*_crop_uniforms(k), SIZE, SIZE)
                                                for k in jax.random.split(key, s)]))
    noise = _noise(jax.random.fold_in(key, 1), max(t_to), (1 if share else s,) + lat.shape[1:])
    return tesd.FusedDraws(pairs, t_to, torch.from_numpy(lat), noise, tids)


class Pair:
    """A JAX step and a port step of one ESD configuration, from the same
    state (``slice_setup``)."""

    def __init__(self, setup, lr=1e-2, train_cfg=1.0, merge_fn=None, **knobs):
        model, self.params, port, self.jsites, jlp, self.tsites, self.jbank, self.tbank = setup
        jsched = jscheduler("euler_a")
        self.schedule = jsched.set_timesteps(MAX_STEPS)
        add = jsampling.get_add_time_ids(SIZE, SIZE)
        jknobs = {("remat_unet" if k == "remat_student" else k): v for k, v in knobs.items()}
        jknobs.setdefault("remat_unet", False)
        ecfg = dict(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=SIZE, width=SIZE, **ROUTE)
        self.jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", lr, 10), grad_clip_norm=0.2)

        def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
            return model.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

        self.jstep = jesd.make_esd_train_step(unet_apply, self.jsites, jsched, self.schedule, self.jopt,
                                              jesd.ESDConfig(**ecfg, **jknobs), add_time_ids=jnp.asarray(add))
        self.tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(self.jsites, jlp), self.tsites)
        for leaf in self.tlp.values():
            for t in leaf.values():
                t.requires_grad_(True)
        tsched = tscheduler("euler_a")
        self.topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", lr, 10), grad_clip_norm=0.2)
        self.tstep = tesd.make_esd_train_step(port, self.tsites, self.tlp, tsched, tsched.set_timesteps(MAX_STEPS),
                                              self.topt, tesd.ESDConfig(**ecfg, **knobs),
                                              add_time_ids=torch.from_numpy(add), merge_fn=merge_fn)
        self.tstate = self.topt.init(toptim.flat_params(self.tsites, self.tlp))
        self.lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
        self.jstate = self.jopt.init(self.lp)
        self.before = tlora.state_dict_numpy(self.tsites, self.tlp)

    def check(self, jm, tm, i):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
        want = jlora.state_dict_numpy(self.jsites, self.lp)
        got = tlora.state_dict_numpy(self.tsites, self.tlp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=f"step {i}: {k}")

    def moved(self) -> float:
        got = tlora.state_dict_numpy(self.tsites, self.tlp)
        return max(np.abs(got[k] - self.before[k]).max() for k in got)

    def run(self, draws_of, seeds=(11, 12)):
        for i, seed in enumerate(seeds):
            key = jax.random.PRNGKey(seed)
            self.lp, self.jstate, jm = self.jstep(self.params, self.lp, self.jstate, key, self.jbank)
            tm = self.tstep(self.tstate, self.tbank, draws=draws_of(key, self.schedule))
            self.check(jm, tm, i)
        assert self.moved() > 5e-3  # two lr-1e-2 Adam steps: the comparison is not of frozen factors


def test_fused_samples_with_crops_and_cfg_match_jax(slice_setup):
    """samples_per_step 2, batch 1: the rows of one masked warm-up, one
    teacher and one student call; each sample's own crop; train.cfg 2."""
    pair = Pair(slice_setup, train_cfg=2.0, samples_per_step=2, dynamic_crops=True)
    pair.run(lambda key, sch: _fused_draws(key, sch, 2, 2, crops=True))


def test_sample_loop_with_batch_two_matches_jax(slice_setup):
    """samples_per_step 2, batch 2: the mean of two one-sample losses (JAX
    vmaps them), each sample's draws from its own key."""
    pair = Pair(slice_setup, samples_per_step=2, batch_size=2)
    pair.run(lambda key, sch: [_sample_draws(k, sch, 2, b=2) for k in jax.random.split(key, 2)])


@pytest.mark.parametrize("knobs", [
    dict(fuse_teacher_student=True, train_cfg_scale=2.0),
    dict(fuse_teacher_student=True, samples_per_step=2),
    dict(share_warmup=True),
    dict(share_warmup=True, samples_per_step=2, batch_size=2),
    dict(pipeline_warmup=True, samples_per_step=2),
    dict(student_overlay=False, overlay_warmup=True),
], ids=["fuse-cfg", "fuse-samples", "share-one-sample", "share-batch-two", "pipeline-samples",
        "overlay-warmup-merged-student"])
def test_invalid_combinations_raise_what_jax_raises(slice_setup, knobs):
    model, params, port, jsites, _, tsites, _, _ = slice_setup
    sched = jscheduler("euler_a")
    base = dict(max_denoising_steps=MAX_STEPS, height=SIZE, width=SIZE)
    jcfg = jesd.ESDConfig(**{"student_overlay": True, **base, **knobs})
    with pytest.raises(ValueError) as jerr:
        jesd.make_esd_train_step(lambda *a, **k: None, jsites, sched, sched.set_timesteps(MAX_STEPS),
                                 joptim.get_optimizer("sgd", joptim.get_lr_schedule("constant", 1e-3, 10)), jcfg,
                                 add_time_ids=jnp.zeros((1, 6)))
    tlp = tlora.init_lora_params(tsites)
    tsched = tscheduler("euler_a")
    with pytest.raises(ValueError) as terr:
        tesd.make_esd_train_step(port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS),
                                 toptim.get_optimizer("sgd", toptim.get_lr_schedule("constant", 1e-3, 10)),
                                 tesd.ESDConfig(**{"student_overlay": True, **base, **knobs}),
                                 add_time_ids=torch.zeros((1, 6)))
    assert str(terr.value) == str(jerr.value)
    # fuse_teacher_student over DoRA's merge
    with pytest.raises(ValueError, match="LoRA overlay only"):
        tesd.make_esd_train_step(port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS),
                                 toptim.get_optimizer("sgd", toptim.get_lr_schedule("constant", 1e-3, 10)),
                                 tesd.ESDConfig(**base, student_overlay=False, fuse_teacher_student=True),
                                 merge_fn=tdora.merge_lora_params)
