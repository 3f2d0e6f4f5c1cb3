"""Data-parallel ESD steps of the SD3, Flux and Stable Cascade families
(``train/esd_sd3.py``, ``esd_flux.py``, ``esd_cascade.py`` with a mesh) in
a 2-rank gloo world on the CPU (SD3 here; Flux and Cascade in
``tests/test_torch_family_dp_flux_cascade.py``, with this file's helpers), against the JAX package's sharded steps
(``shard_samples`` on a 2-device CPU mesh; mirrors
``tests/test_family_dp.py``) fed the same draws, and against the port's
one-process steps: the tiny models (fp32), ``samples_per_step`` 4, two
steps of plain SGD; loss, grad norm and every factor within 2e-4 on every
rank.

* SD3, and SD3 with ``share_warmup`` (every rank keeps the one chain and
  its own snapshot depths);
* Flux (batch 2: 8 rows, one micro-step per optimizer step);
* Stable Cascade with ``share_warmup``, on its default merged student.

The cases of a file run in one world (``tests/_torch_mesh_workers.py``, no
JAX)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cascade_assets as CA
import test_torch_flux_esd as FX
import test_torch_sd3_esd as S3
import _torch_mesh_workers as W
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import flow_match as jflow
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.parallel import mesh as jmesh
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import esd_cascade as jesc
from sliders_conceptmod_tpu.train import esd_flux as jesdf
from sliders_conceptmod_tpu.train import esd_sd3 as jesd3
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _sd3_assets import STEP_TOL
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

RANKS, SAMPLES = 2, 4
SEEDS = (11, 12)
T = "sliders_conceptmod_tpu_torch.train."


def _up_factors(jlp):
    """Non-zero up factors, so the first step's gradient reaches the downs too."""
    rng = np.random.default_rng(5)
    return {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
                for k, v in leaf.items()} for n, leaf in jlp.items()}


def _port_factors(jsites, tsites, jlp):
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    return tlp


def _banks(settings, emb, from_dict=tprompts.PromptSettings.from_dict):
    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in settings],
                                   lambda p: tuple(jnp.asarray(a) for a in emb(p)))
    tbank = tesd.build_prompt_bank([from_dict(s) for s in settings],
                                   lambda p: tuple(torch.from_numpy(a) for a in emb(p)))
    return jbank, tbank


def _sd3(share: bool):
    model, params, port = S3.random_mmdit()
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jlp = _up_factors(jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jbank, tbank = _banks(S3.SETTINGS, S3.emb)
    cfg = dict(max_denoising_steps=S3.MAX_STEPS, train_cfg_scale=1.0, height=64, width=64, samples_per_step=SAMPLES,
               share_warmup=share)
    opt = ("sgd", ("constant", 60.0, 10), {})
    draws = [S3._draws(jax.random.PRNGKey(s), len(S3.SETTINGS), SAMPLES, share) for s in SEEDS]

    def jax_step(m):
        jcfg = jesd3.SD3ESDConfig(**cfg, remat=False, shard_samples=True, mesh=m)
        jopt = joptim.get_optimizer(opt[0], joptim.get_lr_schedule(*opt[1]))
        step = jesd3.make_sd3_esd_train_step(lambda p, *a: model.apply({"params": p}, *a), jsites,
                                             jflow.FlowMatchScheduler(shift=3.0).set_timesteps(S3.MAX_STEPS), jopt,
                                             jcfg, merge_fn=jlora.merge_lora_params, student_overlay=True,
                                             overlay_warmup=False)
        return jopt, lambda lp, st, key: step(params, lp, st, key, jbank)

    job = (T + "esd_sd3:make_sd3_esd_train_step",
           (port, tsites, _port_factors(jsites, tsites, jlp),
            tflow.FlowMatchScheduler(shift=3.0).set_timesteps(S3.MAX_STEPS)), (),
           dict(merge_fn=tlora.merge_lora_params), T + "esd_sd3:SD3ESDConfig",
           dict(cfg, remat=False, student_overlay=True, overlay_warmup=False), opt, tbank, draws, RANKS)
    return jsites, jlp, tsites, jax_step, job


def _flux():
    model, params, port = FX.random_flux()
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jlp = _up_factors(jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jbank, tbank = _banks(FX.SETTINGS, FX.emb)
    assert FX.tcli.accumulation_steps(FX.BATCH, SAMPLES) == 1
    jsched, tsched = FX._schedules()
    cfg = dict(batch_size=FX.BATCH, height=FX.SIZE, width=FX.SIZE, latent_channels=4, vae_scale=FX.VAE_SCALE,
               samples_per_step=SAMPLES)
    opt = ("sgd", ("constant", 150.0, 10), {})
    draws = [FX._draws(jax.random.PRNGKey(s), len(FX.SETTINGS), SAMPLES) for s in SEEDS]

    def jax_step(m):
        jopt = joptim.get_optimizer(opt[0], joptim.get_lr_schedule(*opt[1]))
        step = jesdf.make_flux_esd_train_step(lambda p, *a: model.apply({"params": p}, *a), jsites, jsched, jopt,
                                              jesdf.FluxESDConfig(remat=False, shard_samples=True, mesh=m, **cfg),
                                              merge_fn=jlora.merge_lora_params, student_overlay=True)
        return jopt, lambda lp, st, key: step(params, lp, st, key, jbank)

    job = (T + "esd_flux:make_flux_esd_train_step", (port, tsites, _port_factors(jsites, tsites, jlp), tsched), (),
           dict(merge_fn=tlora.merge_lora_params), T + "esd_flux:FluxESDConfig",
           dict(cfg, remat=False, student_overlay=True), opt, tbank, draws, RANKS)
    return jsites, jlp, tsites, jax_step, job


def _cascade():
    jbank, tbank, (empty_text, empty_pooled) = CA.banks()
    model, params, port = CA.random_prior()
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"])
    jlp = _up_factors(jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"])
    cfg = dict(max_denoising_steps=CA.MAX_STEPS, height=CA.SIZE, width=CA.SIZE, samples_per_step=SAMPLES,
               share_warmup=True)
    opt = (CA.OPT, ("constant", CA.LR, 10), {})
    draws = [CA.jax_draws(jax.random.PRNGKey(s), len(CA.SETTINGS), SAMPLES) for s in SEEDS]
    jsched, tsched = jscheduler("euler_a"), tscheduler("euler_a")

    def jax_step(m):
        jopt = joptim.get_optimizer(opt[0], joptim.get_lr_schedule(*opt[1]))
        step = jesc.make_cascade_esd_train_step(
            lambda p, *a: model.apply({"params": p}, *a), jsites, jsched, jsched.set_timesteps(CA.MAX_STEPS), jopt,
            jesc.CascadeESDConfig(**cfg, remat=False, shard_samples=True, mesh=m), empty_text=jnp.asarray(empty_text),
            empty_pooled=jnp.asarray(empty_pooled), clip_image_dim=16, merge_fn=jlora.merge_lora_params)
        jparams = jax.tree.map(jnp.asarray, params)
        return jopt, lambda lp, st, key: step(jparams, lp, st, key, jbank, None)

    job = (T + "esd_cascade:make_cascade_esd_train_step",
           (port, tsites, _port_factors(jsites, tsites, jlp), tsched, tsched.set_timesteps(CA.MAX_STEPS)),
           (torch.from_numpy(empty_text), torch.from_numpy(empty_pooled), 16), dict(merge_fn=tlora.merge_lora_params),
           T + "esd_cascade:CascadeESDConfig", dict(cfg, remat=False), opt, tbank, draws, RANKS)
    return jsites, jlp, tsites, jax_step, job


FAMILIES = {"sd3": lambda: _sd3(False), "sd3_share": lambda: _sd3(True)}


def run_world(families: dict, out) -> tuple:
    """Every case's two steps in one 2-rank world: (the cases, each rank's results)."""
    cases = {name: make() for name, make in families.items()}
    tmesh.spawn_world(W.esd_steps, (str(out), {name: c[4] for name, c in cases.items()}), RANKS, device="cpu")
    return cases, W.load(out, RANKS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(FAMILIES, tmp_path_factory.mktemp("family_dp"))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_dp_matches_the_jax_sharded_step_and_one_process(world, name):
    check_case(world, name)


def check_case(world, name: str) -> None:
    """The world's steps of ``name`` against JAX's sharded steps and the
    port's one-process steps on the same draws."""
    cases, ranks = world
    jsites, jlp, tsites, jax_step, job = cases[name]
    jopt, jstep = jax_step(jmesh.make_mesh(data=RANKS, model=1, devices=jax.devices()[:RANKS]))
    lp = jax.tree.map(jnp.array, jlp)
    jstate = jopt.init(lp)
    want_metrics = []
    for seed in SEEDS:
        lp, jstate, jm = jstep(lp, jstate, jax.random.PRNGKey(seed))
        want_metrics.append((float(jm["loss"]), float(jm["grad_norm"])))
    want = jlora.state_dict_numpy(jsites, lp)

    # the port's one-process step on the same draws
    make, pre, post, kw, cfg, cfg_kwargs, opt_spec, tbank, draws = job[:9]
    pre = copy.deepcopy(pre)
    topt = W._optimizer(opt_spec)
    step = W._fn(make)(*pre, topt, W._fn(cfg)(**cfg_kwargs), *post, **kw)
    state = topt.init(toptim.flat_params(tsites, pre[2]))
    one_metrics = [step(state, tbank, draws=copy.deepcopy(d)) for d in draws]
    one = tlora.state_dict_numpy(tsites, pre[2])
    for r in ranks:
        assert not r["jax_loaded"]
        got = r[name]
        for m, (jl, jn), om in zip(got["metrics"], want_metrics, one_metrics):
            np.testing.assert_allclose(m["loss"], jl, rtol=STEP_TOL, atol=1e-7)
            np.testing.assert_allclose(m["grad_norm"], jn, rtol=STEP_TOL)
            np.testing.assert_allclose(m["loss"], float(om["loss"]), rtol=STEP_TOL, atol=1e-7)
        factors = tlora.state_dict_numpy(tsites, got["factors"])
        for k in want:
            np.testing.assert_allclose(factors[k], want[k], atol=STEP_TOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(factors[k], one[k], atol=STEP_TOL, rtol=0, err_msg=k)
    before = jlora.state_dict_numpy(jsites, jlp)
    assert max(np.abs(want[k] - before[k]).max() for k in want) > 5e-3  # the factors moved
