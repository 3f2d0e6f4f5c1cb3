"""The int8 base in the port's ESD trainer and serving against the JAX
package's, on the CPU (fp32):

* one tiny-xl (Euler-A) and one tiny-SD (DDIM) ESD step from the same
  weights, factors, prompt embeddings and draws on the int8 routes:
  ``quantize_base`` (the int8 base, weight-only teacher and student, the
  overlay warm-up on it) against JAX's step over ``make_quant_apply``, and the
  dual tree (``w8a8_warmup`` over a full-precision base: the warm-up alone on
  an int8 copy with W8A8) against JAX's step with ``warm_apply`` and
  ``warm_params``; loss, grad norm and every factor within 2e-4;
* the student checkpointed (as above 512px) recomputes through the
  QuantLinears: the same loss and gradients as without;
* the trainer through ``trainer.train`` on every int8 route (tiny-xl and
  tiny SD), and JAX's refusals of the trainer and of the step word for word.

Serving and the sweep over the int8 base are tests/test_torch_quant_serve.py.

Tiny widths hold no Linear of 65,536 elements, so both packages quantize
with a limit of 1 element here (the JAX package's own tests do the same)."""

import functools
import os
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu.train import trainer as jtrainer
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from test_torch_quant import _quantized_port
from test_torch_sd_esd import SETTINGS as SD_SETTINGS
from test_torch_sd_esd import _jax_draws as sd_jax_draws
from test_torch_sd_train import _random_unet
from test_torch_train import CTX, MAX_STEPS, SEQ, STEP_TOL, _jax_draws, _tiny_config, slice_setup  # noqa: F401
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ["quantize_base", "dual_tree"]


@pytest.fixture
def min_elems_1(monkeypatch):
    """Both packages quantize every Linear / Dense of the tiny models."""
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    for name in ("quantize_host_tree", "quantize_init", "quantize_params"):
        monkeypatch.setattr(jquant, name, functools.partial(getattr(jquant, name), min_elems=1))


def _sd_setup():
    model, params, port = _random_unet("tiny", seed=4)
    rng = np.random.default_rng(5)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, train_method="full")
    jlp = jlora.init_lora_params(jax.random.PRNGKey(1), jsites)
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, train_method="full")

    def emb(prompt):
        r = np.random.default_rng(zlib.crc32(prompt.encode()))
        return 0.5 * r.standard_normal((SEQ, CTX)).astype(np.float32)

    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SD_SETTINGS],
                                   lambda p: (jnp.asarray(emb(p)), None))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SD_SETTINGS],
                                   lambda p: (torch.from_numpy(emb(p)), None))
    return model, params, port, jsites, jlp, tsites, jbank, tbank


def _step_pair(setup, family, route, remat=False):
    """(JAX step and its frozen trees, the port's step, its factors and state)
    on an int8 route."""
    model, params, port, jsites, jlp, tsites, jbank, tbank = setup
    jparams = jax.tree.map(jnp.asarray, params)
    qtree, scales = jquant.quantize_params(jparams, min_elems=1)
    plain = functools.partial(lambda p, *a, **k: model.apply({"params": p}, *a, **k))
    weight_only = jquant.make_quant_apply(model, scales, jnp.float32)
    w8a8 = jquant.make_quant_apply(model, scales, jnp.float32, act_quant=True)
    if route == "quantize_base":
        japply, jwarm, base, warm_params = weight_only, None, qtree, None
        unet, warm_unet = _quantized_port(port, qtree), None
    else:
        japply, jwarm, base, warm_params = plain, w8a8, jparams, qtree
        unet, warm_unet = port, tquant.quantized_copy(port, act_quant=True, min_elems=1)
    sched_name = "euler_a" if family == "xl" else "ddim"
    jsched = jscheduler(sched_name)
    jschedule = jsched.set_timesteps(MAX_STEPS)
    add = jsampling.get_add_time_ids(64, 64) if family == "xl" else None
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    jstep = jesd.make_esd_train_step(
        japply, jsites, jsched, jschedule, jopt,
        jesd.ESDConfig(max_denoising_steps=MAX_STEPS, height=64, width=64, batch_size=1, student_overlay=True,
                       overlay_warmup=True, remat_unet=False),
        add_time_ids=None if add is None else jnp.asarray(add), warm_apply=jwarm)

    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    tsched = tscheduler(sched_name)
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    tstep = tesd.make_esd_train_step(
        unet, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
        tesd.ESDConfig(max_denoising_steps=MAX_STEPS, height=64, width=64, student_overlay=True,
                       overlay_warmup=True, remat_student=remat),
        add_time_ids=None if add is None else torch.from_numpy(add), warm_unet=warm_unet)
    return (jstep, jopt, base, warm_params, jschedule), (tstep, topt, tlp)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", ["xl", "sd"])
def test_int8_esd_step_matches_jax(slice_setup, family, route):
    setup = slice_setup if family == "xl" else _sd_setup()
    jsites, jlp, tsites, jbank, tbank = setup[3], setup[4], setup[5], setup[6], setup[7]
    (jstep, jopt, base, warm_params, jschedule), (tstep, topt, tlp) = _step_pair(setup, family, route)
    tstate = topt.init(toptim.flat_params(tsites, tlp))
    lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
    jstate = jopt.init(lp)
    before = tlora.state_dict_numpy(tsites, tlp)
    key = jax.random.PRNGKey(11)
    draws = (_jax_draws if family == "xl" else sd_jax_draws)(key, jschedule, 2)
    extra = () if warm_params is None else (warm_params,)
    lp, jstate, jm = jstep(base, lp, jstate, key, jbank, *extra)
    tm = tstep(tstate, tbank, draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
    want, got = jlora.state_dict_numpy(jsites, lp), tlora.state_dict_numpy(tsites, tlp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=k)
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 5e-3  # the factors moved


def test_checkpointed_student_recomputes_through_quant_linear(slice_setup):
    """The student under ``torch.utils.checkpoint`` (the trainer's setting
    above 512px) over the int8 base: loss and gradients as without."""
    out = []
    for remat in (False, True):
        _, (tstep, _, tlp) = _step_pair(slice_setup, "xl", "quantize_base", remat=remat)
        spy = types.SimpleNamespace(init=lambda p: {}, global_norm=toptim.Optimizer.global_norm,
                                    step=lambda params, grads, state, g_norm=None: out.append(grads))
        tstep.optimizer = spy
        draws = _jax_draws(jax.random.PRNGKey(12), tscheduler("euler_a").set_timesteps(MAX_STEPS), 2)
        out.append(float(tstep({}, slice_setup[7], draws=draws)["loss"]))
    grads_a, loss_a, grads_b, loss_b = out
    assert loss_a == loss_b
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [dict(quantize_base=True), dict(w8a8_warmup=True),
                                   dict(quantize_base=True, w8a8_warmup=True)],
                         ids=["quantize_base", "dual_tree", "both"])
@pytest.mark.parametrize("yaml_name", ["config-tiny-xl.yaml", "config-tiny.yaml"])
def test_trainer_trains_on_the_int8_routes(tmp_path, monkeypatch, min_elems_1, knobs, yaml_name):
    """``trainer.train`` on every int8 route: the student and the warm-up see
    the UNets the route names, the slider saves the reference keys and the
    factors move."""
    built = []
    real = tesd.ESDStep.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        built.append((self.unet, None if self.warm_unet is self.unet else self.warm_unet))

    monkeypatch.setattr(tesd.ESDStep, "__init__", spy)
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", yaml_name))
    cfg.prompts_file = os.path.join(REPO, cfg.prompts_file)
    cfg.save.path, cfg.save.per_steps, cfg.train.iterations = str(tmp_path), 0, 2
    cfg.logging.verbose = False
    for k, v in knobs.items():
        setattr(cfg.tpu, k, v)
    prompts = tprompts.load_prompts_from_yaml(cfg.prompts_file)
    res = ttrainer.train(cfg, prompts, rank=2, device="cpu")
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    (unet, warm), = built
    assert tquant.is_quantized(unet) == bool(knobs.get("quantize_base"))
    if knobs.get("w8a8_warmup"):
        wq = [m for m in warm.modules() if isinstance(m, tquant.QuantLinear)]
        assert wq and all(m.act_quant for m in wq)
        assert not any(m.act_quant for m in unet.modules() if isinstance(m, tquant.QuantLinear))
    else:
        assert warm is None
    ups = [leaf["up"] for leaf in res.lora_params.values()]
    assert all(u.abs().max() > 0 for u in ups)
    assert (tmp_path / f"{cfg.save.name}_last.safetensors").exists()


REFUSALS = [
    (dict(quantize_base=True), "dora"),
    (dict(w8a8_warmup=True), "dora"),
    (dict(w8a8_warmup=True, student_overlay=False), "lora"),
    (dict(w8a8_warmup=True, overlay_warmup=False), "lora"),
    (dict(quantize_base=True, overlay_warmup=False), "lora"),
    (dict(quantize_base=True, student_overlay=False), "lora"),
]


@pytest.mark.parametrize("knobs,peft_type", REFUSALS)
def test_trainer_refusals_match_jax(tmp_path, knobs, peft_type):
    jcfg = jconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-tiny-xl.yaml"))
    tcfg = _tiny_config(tmp_path)
    for cfg in (jcfg, tcfg):
        for k, v in knobs.items():
            setattr(cfg.tpu, k, v)
        cfg.save.path = str(tmp_path)
    jprompt = [jprompts.PromptSettings(target="person", resolution=64)]
    tprompt = [tprompts.PromptSettings(target="person", resolution=64)]
    with pytest.raises((NotImplementedError, ValueError)) as want:
        jtrainer.train(jcfg, jprompt, rank=2, peft_type=peft_type, save_file=False)
    with pytest.raises((NotImplementedError, ValueError)) as got:
        ttrainer.train(tcfg, tprompt, rank=2, peft_type=peft_type, save_file=False, device="cpu")
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_step_refusals_match_jax(slice_setup):
    model, params, port, jsites, _, tsites, *_ = slice_setup
    apply = lambda p, *a, **k: model.apply({"params": p}, *a, **k)  # noqa: E731
    sched = jscheduler("euler_a")
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-3, 10))
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-3, 10))
    tsched = tscheduler("euler_a")
    tlp = tlora.init_lora_params(tsites)
    for route in (dict(student_overlay=False), dict(student_overlay=True, overlay_warmup=False)):
        with pytest.raises(ValueError) as want:
            jesd.make_esd_train_step(apply, jsites, sched, sched.set_timesteps(MAX_STEPS), jopt,
                                     jesd.ESDConfig(max_denoising_steps=MAX_STEPS, remat_unet=False, **route),
                                     warm_apply=apply)
        with pytest.raises(ValueError) as got:
            tesd.make_esd_train_step(port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
                                     tesd.ESDConfig(max_denoising_steps=MAX_STEPS, **route), warm_unet=port)
        assert str(got.value) == str(want.value)
