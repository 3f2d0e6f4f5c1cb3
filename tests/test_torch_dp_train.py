"""Data-parallel ESD steps of the port (``train/esd.py`` with a mesh,
``parallel/mesh.py``) in a 2-rank gloo world on the CPU, against the JAX
package's sharded step (``shard_samples`` on a 2-device CPU mesh) fed the
same draws, and against the port's one-process step: tiny-xl (64px,
Euler-A, ``max_denoising_steps`` 3, fp32), ``samples_per_step`` 4, two
steps of plain SGD (Adam's first steps move each factor by ±lr whatever
the size of its gradient, so a gradient that sums to nearly 0 flips with
the order of the sum; SGD's update is the gradient itself); loss, grad norm
and every factor within 2e-4 on every rank.

* the fused samples (batch 1) with ``dynamic_crops`` and ``train.cfg`` 2;
* ``share_warmup`` with ``dynamic_crops`` (every rank keeps the step's one
  chain and its own snapshot depths);
* the one-sample loop (batch 2), in ``tests/test_torch_dp_train_loop.py``
  with this file's helpers.

Each rank draws nothing of its own: it is handed the whole step's draws,
as a rank draws all of them from the one seed, and takes its share."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.parallel import mesh as jmesh
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
import _torch_mesh_workers as W
from test_torch_esd_knobs import SIZE, _fused_draws, _sample_draws
from test_torch_train import MAX_STEPS, STEP_TOL, slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

RANKS, SAMPLES = 2, 4
# plain SGD: the tiny step's gradient norm is ~1e-5, so this moves the factors by ~1e-2
OPT = ("sgd", ("constant", 1e4, 10), {})
ROUTE = dict(student_overlay=True, overlay_warmup=False)  # the trainers' default LoRA route
SEEDS = (11, 12)
# name -> (train.cfg, knobs, draws from a key and the schedule)
CASES = {
    "fused_crops_cfg": (2.0, dict(dynamic_crops=True),
                        lambda key, sch: _fused_draws(key, sch, 2, SAMPLES, crops=True)),
    "loop_batch_two": (1.0, dict(batch_size=2),
                       lambda key, sch: [_sample_draws(k, sch, 2, b=2) for k in jax.random.split(key, SAMPLES)]),
    "share_crops": (1.0, dict(share_warmup=True, dynamic_crops=True),
                    lambda key, sch: _fused_draws(key, sch, 2, SAMPLES, crops=True, share=True)),
}
HERE = ("fused_crops_cfg", "share_crops")  # this file's cases; the other runs in test_torch_dp_train_loop.py


def _factors(jsites, tsites, jlp):
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    return tlp


def _ecfg(name):
    train_cfg, knobs, _ = CASES[name]
    return dict(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=SIZE, width=SIZE,
                samples_per_step=SAMPLES, **ROUTE, **knobs)


def run_world(slice_setup, out, names) -> tuple:
    """The two steps of the cases ``names`` in one 2-rank world: the draws,
    and each rank's results by case."""
    model, params, port, jsites, jlp, tsites, jbank, tbank = slice_setup
    schedule = jscheduler("euler_a").set_timesteps(MAX_STEPS)
    draws = {name: [CASES[name][2](jax.random.PRNGKey(seed), schedule) for seed in SEEDS] for name in names}
    tsched = tscheduler("euler_a")
    add = torch.from_numpy(jsampling.get_add_time_ids(SIZE, SIZE))
    jobs = {name: ("sliders_conceptmod_tpu_torch.train.esd:make_esd_train_step",
                   (port, tsites, _factors(jsites, tsites, jlp), tsched, tsched.set_timesteps(MAX_STEPS)), (),
                   dict(add_time_ids=add), "sliders_conceptmod_tpu_torch.train.esd:ESDConfig", _ecfg(name), OPT,
                   tbank, draws[name], RANKS) for name in names}
    tmesh.spawn_world(W.esd_steps, (str(out), jobs), RANKS, device="cpu")
    return draws, W.load(out, RANKS)


@pytest.fixture(scope="module")
def world(slice_setup, tmp_path_factory):
    return run_world(slice_setup, tmp_path_factory.mktemp("dp"), HERE)


@pytest.mark.parametrize("name", HERE)
def test_dp_steps_match_the_jax_sharded_step_and_one_process(slice_setup, world, name):
    check_case(slice_setup, world, name)


def check_case(slice_setup, world, name: str) -> None:
    """The world's two steps of ``name`` against JAX's sharded step and the
    port's one-process step on the same draws."""
    model, params, port, jsites, jlp, tsites, jbank, tbank = slice_setup
    draws, ranks = world
    jsched = jscheduler("euler_a")
    schedule = jsched.set_timesteps(MAX_STEPS)
    add = jsampling.get_add_time_ids(SIZE, SIZE)
    ecfg = _ecfg(name)

    def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
        return model.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

    # JAX: the sample axis sharded over a 2-device data axis
    jopt = joptim.get_optimizer(OPT[0], joptim.get_lr_schedule(*OPT[1]))
    m = jmesh.make_mesh(data=RANKS, model=1, devices=jax.devices()[:RANKS])
    jstep = jesd.make_esd_train_step(unet_apply, jsites, jsched, schedule, jopt,
                                     jesd.ESDConfig(**ecfg, remat_unet=False, shard_samples=True, mesh=m),
                                     add_time_ids=jnp.asarray(add))
    lp = jax.tree.map(jnp.array, jlp)
    jstate = jopt.init(lp)
    jmetrics = []
    for seed in SEEDS:
        lp, jstate, jm = jstep(params, lp, jstate, jax.random.PRNGKey(seed), jbank)
        jmetrics.append((float(jm["loss"]), float(jm["grad_norm"])))
    want = jlora.state_dict_numpy(jsites, lp)

    # the port in one process
    tsched = tscheduler("euler_a")
    one_lp = _factors(jsites, tsites, jlp)
    topt = toptim.get_optimizer(OPT[0], toptim.get_lr_schedule(*OPT[1]))
    one = tesd.make_esd_train_step(port, tsites, one_lp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
                                   tesd.ESDConfig(**ecfg), add_time_ids=torch.from_numpy(add))
    state = topt.init(toptim.flat_params(tsites, one_lp))
    one_metrics = [one(state, tbank, draws=copy.deepcopy(d)) for d in draws[name]]
    one_metrics = [(float(x["loss"]), float(x["grad_norm"])) for x in one_metrics]

    one_sd = tlora.state_dict_numpy(tsites, one_lp)
    for r in ranks:
        assert not r["jax_loaded"]
        got_metrics = [(x["loss"], x["grad_norm"]) for x in r[name]["metrics"]]
        for (gl, gn), (jl, jn), (ol, on) in zip(got_metrics, jmetrics, one_metrics):
            np.testing.assert_allclose(gl, jl, rtol=STEP_TOL, atol=1e-7)
            np.testing.assert_allclose(gn, jn, rtol=STEP_TOL)
            np.testing.assert_allclose(gl, ol, rtol=STEP_TOL, atol=1e-7)
        got = tlora.state_dict_numpy(tsites, r[name]["factors"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(got[k], one_sd[k], atol=STEP_TOL, rtol=0, err_msg=k)
    before = jlora.state_dict_numpy(jsites, jlp)
    assert max(np.abs(want[k] - before[k]).max() for k in want) > 5e-3  # the factors moved
