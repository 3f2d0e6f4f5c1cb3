"""The port's ESD knobs without a JAX model (``tests/test_torch_esd_knobs.py``
holds the JAX step parities), on the port's tiny-xl (seeded random weights,
64px, Euler-A, fp32):

* ``draw_time_ids`` on JAX's uniforms equals JAX's ``draw_time_ids``;
* the resolution buckets and a 50-step bucket sequence equal JAX's, and
  ``trainer.train`` with ``dynamic_resolution`` trains over them;
* ``samples_per_step`` with ``share_warmup``, ``fuse_teacher_student`` and
  ``pipeline_warmup`` train through ``trainer.train``; ``tpu.profile_dir``
  writes a Chrome trace on the CPU;
* ``pipeline_warmup`` at lr 0 gives the unpipelined losses bit for bit;
* the checkpointed student gives the plain student's step (≤ 1e-6) on the
  overlay, merged, fused and DoRA routes.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import loop_utils as jloop
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion import sampling as tsampling
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import loop_utils as tloop
from sliders_conceptmod_tpu_torch.train import optim as toptim
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from test_torch_esd_knobs import ROUTE, SIZE, _crop_uniforms, _sample_draws
from test_torch_train import MAX_STEPS, SETTINGS
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_setup():
    """The port's tiny-xl UNet and towers (seeded random weights), LoRA
    sites over every attention, factors with non-zero ups, a prompt bank."""
    _, tes, unet, _ = tfactory.load_models_xl("tiny-xl", device="cpu")
    sites = tlora.create_sites(unet, rank=2, alpha=1.0, train_method="full")
    g = torch.Generator().manual_seed(1)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    bank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                  lambda p: tuple(t[0] for t in tfactory.encode_prompts_xl(tes, [p])))
    return unet, sites, lp, bank


def _port_step(setup, lr=1e-2, merge=None, **knobs):
    """A port step alone over ``setup``'s factors (fresh copies)."""
    port, tsites, lp, _ = setup
    tlp = {n: {k: t.clone() for k, t in leaf.items()} for n, leaf in lp.items()}
    if merge is tdora.merge_lora_params:
        with torch.no_grad():
            for site, _, w in tlora.site_weights(port, tsites):
                tlp[site.lora_name]["dora_scale"] = tdora._col_norm(w).clone()
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    sched = tscheduler("euler_a")
    opt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", lr, 10), grad_clip_norm=0.2)
    cfg = tesd.ESDConfig(max_denoising_steps=MAX_STEPS, height=SIZE, width=SIZE, **knobs)
    step = tesd.make_esd_train_step(port, tsites, tlp, sched, sched.set_timesteps(MAX_STEPS), opt, cfg,
                                    add_time_ids=torch.from_numpy(tsampling.get_add_time_ids(SIZE, SIZE)),
                                    merge_fn=merge)
    return step, opt.init(toptim.flat_params(tsites, tlp)), tlp, sched.set_timesteps(MAX_STEPS)


def test_draw_time_ids_on_jax_uniforms_equals_jax():
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        for h, w in ((64, 64), (512, 512), (1024, 768), (448, 320)):
            want = np.asarray(jesd.draw_time_ids(jax.random.fold_in(key, 7), h, w))
            np.testing.assert_array_equal(tesd.draw_time_ids(*_crop_uniforms(key), h, w), want)


@pytest.mark.parametrize("resolution", [64, 256, 512, 768, 1024])
def test_resolution_buckets_and_sequence_equal_jax(resolution):
    for seed in (0, 7):
        jb, jpick = jloop.resolution_bucket_picker(True, resolution, seed)
        tb, tpick = tloop.resolution_bucket_picker(True, resolution, seed)
        assert tb == [tuple(b) for b in jb] == tsampling.dynamic_resolution_buckets(resolution)
        assert [tpick(i) for i in range(50)] == [jpick(i) for i in range(50)]
    assert tloop.resolution_bucket_picker(False, resolution, 0) == ([(resolution, resolution)], None)


def _tiny_config(path, iterations=3):
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-tiny-xl.yaml"))
    cfg.prompts_file = os.path.join(REPO, cfg.prompts_file)
    cfg.save.path, cfg.save.per_steps, cfg.train.iterations = str(path), 200, iterations
    cfg.logging.verbose = False
    return cfg


def test_trainer_trains_over_the_resolution_buckets_with_crops(tmp_path):
    """dynamic_resolution at 256px: each iteration's bucket (in the jsonl)
    is JAX's picker's; dynamic_crops redraws the crop; losses finite."""
    cfg = _tiny_config(tmp_path, iterations=4)
    prompts = [tprompts.PromptSettings.from_dict(dict(p.model_dump(), resolution=256, dynamic_resolution=True,
                                                      dynamic_crops=True))
               for p in tprompts.load_prompts_from_yaml(cfg.prompts_file)]
    res = ttrainer.train(cfg, prompts, rank=2, device="cpu", save_file=False)
    buckets, pick = jloop.resolution_bucket_picker(True, 256, cfg.tpu.seed)
    assert [(r["height"], r["width"]) for r in res.metrics] == [tuple(buckets[pick(i)]) for i in range(4)]
    assert all(np.isfinite(res.losses))


def test_trainer_knobs_train_and_profile_dir_writes_a_trace(tmp_path):
    """fused samples with share_warmup, fuse_teacher_student and
    pipeline_warmup through trainer.train; profile_dir writes a Chrome trace
    of the loop."""
    prompts = tprompts.load_prompts_from_yaml(_tiny_config(tmp_path).prompts_file)
    for name, knobs in (("share", dict(samples_per_step=2, share_warmup=True)),
                        ("fuse", dict(fuse_teacher_student=True)),
                        ("pipe", dict(pipeline_warmup=True, profile_dir=str(tmp_path / "trace")))):
        cfg = _tiny_config(tmp_path / name, iterations=2)
        for k, v in knobs.items():
            setattr(cfg.tpu, k, v)
        res = ttrainer.train(cfg, prompts, rank=2, device="cpu", save_file=False)
        assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    trace = json.loads((tmp_path / "trace" / f"{cfg.save.name}_trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)  # the UNet's ops are in the trace


def test_pipeline_warmup_at_lr_zero_gives_the_unpipelined_losses(port_setup):
    """With lr 0 the factors never move, so the pipelined sequence is the
    unpipelined one, bit for bit (JAX asserts the same)."""
    losses = {}
    for pipelined in (False, True):
        step, state, _, _ = _port_step(port_setup, lr=0.0, pipeline_warmup=pipelined, **ROUTE)
        rng = tesd.TrainRNG(3, "cpu")
        if pipelined:
            step.init_carry(port_setup[-1], rng)
        losses[pipelined] = [float(step(state, port_setup[-1], rng)["loss"]) for _ in range(3)]
    assert losses[True] == losses[False]


@pytest.mark.parametrize("route", [dict(student_overlay=True, overlay_warmup=False),
                                   dict(student_overlay=False, overlay_warmup=None), "fuse", "dora"],
                         ids=["overlay", "merged", "fuse_teacher_student", "dora"])
def test_checkpointed_student_gives_the_plain_gradients(port_setup, route):
    """``remat_student`` (the default above 512px): the same loss, gradient
    norm and updated factors as the plain student (fp32, ≤ 1e-6)."""
    knobs = dict(fuse_teacher_student=True, **ROUTE) if route == "fuse" else (
        dict(student_overlay=False) if route == "dora" else route)
    merge = tdora.merge_lora_params if route == "dora" else None
    draws = _sample_draws(jax.random.PRNGKey(11), jscheduler("euler_a").set_timesteps(MAX_STEPS), 2)
    out = {}
    for remat in (False, True):
        step, state, tlp, _ = _port_step(port_setup, merge=merge, remat_student=remat, **knobs)
        assert step.cfg.remat is remat
        m = step(state, port_setup[-1], draws=draws)
        out[remat] = (float(m["loss"]), float(m["grad_norm"]),
                      {n: {k: t.detach().clone() for k, t in leaf.items()} for n, leaf in tlp.items()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6, abs=0)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-6, abs=0)
    for n, leaf in out[False][2].items():
        for k, t in leaf.items():
            torch.testing.assert_close(out[True][2][n][k], t, atol=1e-6, rtol=0)
    assert tesd.ESDConfig(height=1024, width=1024).remat and not tesd.ESDConfig(height=512, width=512).remat
