"""The port's Flux ESD step (``train/esd_flux.py``) and trainer
(``cli/train_lora_flux.py``) against the JAX package's
``make_flux_esd_train_step`` under ``optax.MultiSteps``.

* two optimizer steps of four micro-steps each (batch 2: an effective batch
  of 8) on the tiny Flux transformer (fp32, 32px, 8 flow steps, μ from the
  token count) from the same weights, LoRA factors, prompt embeddings and
  random draws (derived from each JAX micro-step key): every micro-step's
  loss and grad norm, and every factor after every micro-step, within 2e-4
  — the factors move on the fourth and eighth micro-steps only;
* routes: the overlay student, the merged student (the default; the port's
  blocks checkpointed), DoRA (merged), ``samples_per_step`` 2 (two
  micro-steps per optimizer step) and the int8 base (every Dense
  quantized, the overlay student);
* ``MultiSteps`` against optax's over two accumulation cycles;
* the CLI through ``main`` on ``data/config-tiny-flux.yaml``: the JAX
  trainer's key set and micro-step count, a resume from the middle of an
  accumulation bit for bit, the parser and save name of the JAX CLI, its
  refusals; ``mesh_model`` 2 in one process trains the one-device step.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.cli import train_lora_flux as jcli
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import flow_match as jflow
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import esd_flux as jesdf
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.cli import train_lora_flux as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import esd_flux as tesdf
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _flux_assets import STEP_TOL, emb, random_flux
from test_torch_quant import _quantized_port
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, VAE_SCALE, BATCH = 32, 2, 2
SETTINGS = [
    dict(target="person", positive="person, very old", unconditional="person, young", neutral="person",
         action="enhance", guidance_scale=4, resolution=SIZE, batch_size=BATCH),
    dict(target="sky", positive="blue sky", negative="grey sky", action="erase", guidance_scale=2.0,
         resolution=SIZE, batch_size=BATCH),
]


def _draws(key, n_pairs, samples):
    """The port's draws from a JAX micro-step key, as the JAX step draws them."""
    keys = [key] if samples == 1 else list(jax.random.split(key, samples))
    out = []
    for k in keys:
        k_pair, k_noise = jax.random.split(k, 2)
        lat = np.array(jax.random.normal(k_noise, (BATCH, 4, SIZE // VAE_SCALE, SIZE // VAE_SCALE), jnp.float32))
        out.append(tesdf.Draw(int(jax.random.randint(k_pair, (), 0, n_pairs)), torch.from_numpy(lat)))
    return out


def _schedules():
    g = SIZE // VAE_SCALE // 2
    mu = jflow.calculate_shift(g * g)
    return (jflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(8, mu=mu),
            tflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(8, mu=tflow.calculate_shift(g * g)))


def _inner(mod):
    return mod.get_optimizer("adamw", mod.get_lr_schedule("cosine", 1e-2, 50, 1e-6), weight_decay=1e-6,
                             grad_clip_value=1.0)


@pytest.fixture
def min_elems_1(monkeypatch):
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    for name in ("quantize_host_tree", "quantize_init", "quantize_params"):
        monkeypatch.setattr(jquant, name, functools.partial(getattr(jquant, name), min_elems=1))


# (route, peft, samples_per_step, port remat)
CASES = [("overlay", "lora", 1, False), ("merged", "lora", 1, True), ("merged", "dora", 1, False),
         ("overlay", "lora", 2, False), ("int8", "lora", 1, True)]


@pytest.mark.parametrize("route,peft,samples,remat", CASES)
def test_two_optimizer_steps_match_jax_multisteps(route, peft, samples, remat, min_elems_1):
    jpeft, tpeft = (jdora, tdora) if peft == "dora" else (jlora, tlora)
    model, params, port = random_flux()
    rng = np.random.default_rng(5)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jlp = (jdora.init_lora_params(jax.random.PRNGKey(1), jsites, base_params=params) if peft == "dora"
           else jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]
    base, tmodel, japply = params, port, (lambda p, *a: model.apply({"params": p}, *a))
    if route == "int8":
        base, scales = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_elems=1)
        japply = jquant.make_quant_apply(model, scales, jnp.float32)
        tmodel = _quantized_port(port, base)

    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SETTINGS],
                                   lambda p: tuple(jnp.asarray(a) for a in emb(p)))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                   lambda p: tuple(torch.from_numpy(a) for a in emb(p)))
    k = tcli.accumulation_steps(BATCH, samples)
    assert k == math.ceil(8 / (BATCH * samples))
    jsched, tsched = _schedules()
    jopt = optax.MultiSteps(_inner(joptim), every_k_schedule=k)
    cfg = dict(batch_size=BATCH, height=SIZE, width=SIZE, latent_channels=4, vae_scale=VAE_SCALE,
               samples_per_step=samples)
    overlay = route in ("overlay", "int8")
    jstep = jesdf.make_flux_esd_train_step(japply, jsites, jsched, jopt, jesdf.FluxESDConfig(remat=False, **cfg),
                                           merge_fn=jpeft.merge_lora_params, student_overlay=overlay)
    tlp = tpeft.load_weights_from_tensors(jpeft.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    topt = toptim.MultiSteps(_inner(toptim), k)
    tstep = tesdf.make_flux_esd_train_step(tmodel, tsites, tlp, tsched, topt,
                                           tesdf.FluxESDConfig(remat=remat, student_overlay=overlay, **cfg),
                                           merge_fn=tpeft.merge_lora_params)
    tstate = topt.init(toptim.flat_params(tsites, tlp))
    lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
    jstate = jopt.init(lp)
    before = tpeft.state_dict_numpy(tsites, tlp)
    prev = before
    for i in range(2 * k):
        key = jax.random.PRNGKey(100 + i)
        lp, jstate, jm = jstep(base, lp, jstate, key, jbank)
        tm = tstep(tstate, tbank, draws=_draws(key, len(SETTINGS), samples))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
        assert tstate["mini_step"] == int(jstate.mini_step) and tstate["gradient_step"] == int(jstate.gradient_step)
        want, got = jpeft.state_dict_numpy(jsites, lp), tpeft.state_dict_numpy(tsites, tlp)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=STEP_TOL, rtol=0, err_msg=f"micro-step {i}: {name}")
        moved = any(not np.array_equal(got[n], prev[n]) for n in got)
        assert moved == ((i + 1) % k == 0), i
        prev = got
    assert max(np.abs(got[n] - before[n]).max() for n in got) > 1e-3  # the factors moved


def test_multisteps_matches_optax_over_two_cycles():
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal((5,)).astype(np.float32)]
    jopt = optax.MultiSteps(_inner(joptim), every_k_schedule=3)
    jp = [jnp.asarray(a) for a in p0]
    jstate = jopt.init(jp)
    topt = toptim.MultiSteps(_inner(toptim), 3)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tstate = topt.init(tp)
    for i in range(6):
        g = [(3 * rng.standard_normal(a.shape)).astype(np.float32) for a in p0]
        u, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, u)
        assert topt.step(tp, [torch.from_numpy(x) for x in g], tstate) == ((i + 1) % 3 == 0)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
        for a, b in zip(jstate.acc_grads, tstate["acc_grads"]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
        assert (tstate["mini_step"], tstate["gradient_step"]) == (int(jstate.mini_step), int(jstate.gradient_step))
        assert tstate["inner"]["count"] == int(jstate.gradient_step)


def test_step_refuses_dora_on_the_overlay():
    _, _, port = random_flux()
    sites = tdora.create_sites(port, rank=2, target_replace=["Attention"], delimiter="-")
    lp = tdora.init_lora_params(sites, port)
    _, sched = _schedules()
    with pytest.raises(ValueError):
        tesdf.make_flux_esd_train_step(port, sites, lp, sched, toptim.MultiSteps(_inner(toptim), 2),
                                       tesdf.FluxESDConfig(student_overlay=True), merge_fn=tdora.merge_lora_params)


# ---------------------------------------------------------------------------
# the trainer through the CLI
# ---------------------------------------------------------------------------


def _tiny_yaml(tmp_path, iterations=2, per_steps=3, **tpu):
    """data/config-tiny-flux.yaml saving under ``tmp_path`` every ``per_steps``
    micro-steps."""
    text = open(os.path.join(REPO, "data", "config-tiny-flux.yaml")).read()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{os.path.join(REPO, "data", "prompts-tiny.yaml")}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"')
    text = text.replace("per_steps: 200", f"per_steps: {per_steps}")
    text = text.replace("iterations: 1", f"iterations: {iterations}")
    text = text.replace("verbose: true", "verbose: false")
    text += "".join(f"  {k}: {str(v).lower()}\n" for k, v in tpu.items())
    (tmp_path / "config.yaml").write_text(text)
    return str(tmp_path / "config.yaml")


def test_cli_trains_tiny_flux_and_saves_the_jax_key_set(tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "1", "--rank", "2", "--device", "cpu"]
    done = []
    res = tcli.train(*_cfg_and_prompts(argv), rank=2, device="cpu", on_step_complete=done.append)
    assert len(res.losses) == 2 * 8 + 1 and all(np.isfinite(res.losses))  # batch 1: 8 micro-steps per step, +1
    assert done == [1, 2]
    out = tmp_path / "out" / "tinyflux_slider_alpha1.0_rank2_full"
    assert sorted(os.listdir(out)) == sorted(
        [f"tinyflux_slider_alpha1.0_rank2_full_{i}steps.safetensors" for i in (3, 6, 9, 12, 15)]
        + [f"tinyflux_slider_alpha1.0_rank2_full_{s}" for s in ("last.safetensors", "metrics.jsonl", "resume.pt")])
    saved = tst.load_file(str(out / "tinyflux_slider_alpha1.0_rank2_full_last.safetensors"))
    _, _, jtr, _ = jfactory.load_models_flux("tiny-flux")
    jsites = jlora.create_sites(jtr.params, rank=2, alpha=1.0, target_replace=["Attention"], train_method="full",
                                delimiter="-")
    assert set(saved) == {f"{s.lora_name}.{k}" for s in jsites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    assert all(v.abs().max() > 0 for k, v in saved.items() if k.endswith("lora_up.weight"))


def _cfg_and_prompts(argv):
    args = tcli.build_parser().parse_args(argv)
    config = tconfig.load_config_from_yaml(args.config_file)
    tcli._decorate(config, args.alpha, args.rank)
    return config, tprompts.load_prompts_from_yaml(config.prompts_file, [])


def test_cli_resumes_mid_accumulation_bit_for_bit(tmp_path):
    """A run stopped at micro-step 10 (the third micro-step of the second
    optimizer step) and resumed ends where the uninterrupted run ends."""
    argv = ["--config_file", _tiny_yaml(tmp_path, iterations=2, per_steps=9), "--alpha", "1", "--rank", "2",
            "--device", "cpu"]
    full = tcli.main(tcli.build_parser().parse_args(argv))
    out = tmp_path / "out" / "tinyflux_slider_alpha1.0_rank2_full"
    last = tst.load_file(str(out / "tinyflux_slider_alpha1.0_rank2_full_last.safetensors"))
    state = torch.load(str(out / "tinyflux_slider_alpha1.0_rank2_full_resume.pt"), weights_only=False)
    assert state["step"] == 10 and state["opt_state"]["mini_step"] == 2 and state["opt_state"]["gradient_step"] == 1
    assert any(g.abs().max() > 0 for g in state["opt_state"]["acc_grads"])
    os.replace(out, tmp_path / "first")
    resumed = tcli.main(tcli.build_parser().parse_args(argv + ["--resume_from", str(tmp_path / "first")]))
    assert resumed.losses == full.losses[10:]
    again = tst.load_file(str(out / "tinyflux_slider_alpha1.0_rank2_full_last.safetensors"))
    for key, v in last.items():
        assert torch.equal(again[key], v), key


def test_cli_parser_save_name_and_refusals_match_the_jax_cli(monkeypatch, tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "0.5", "--rank", "8", "--name", "old",
            "--attributes", "male, female"]
    got, want = {}, {}
    monkeypatch.setattr(jcli, "train", lambda config, prompts, **kw: want.update(c=config, p=prompts, kw=kw))
    monkeypatch.setattr(tcli, "train", lambda config, prompts, **kw: got.update(c=config, p=prompts, kw=kw))
    jcli.main(jcli.build_parser().parse_args(argv))
    tcli.main(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert (got["c"].save.name, got["c"].save.path) == (want["c"].save.name, want["c"].save.path)
    assert [p.model_dump() for p in got["p"]] == [p.model_dump() for p in want["p"]]
    jargs, targs = jcli.build_parser().parse_args(argv), tcli.build_parser().parse_args(argv)
    for flag in ("config_file", "alpha", "rank", "name", "attributes", "peft_type", "resume_from"):
        assert getattr(targs, flag) == getattr(jargs, flag), flag
    monkeypatch.undo()
    prompts = tprompts.load_prompts_from_yaml(os.path.join(REPO, "data", "prompts-tiny.yaml"), [])
    for tpu, peft, exc in (({"quantize_base": True}, "dora", NotImplementedError),
                           ({"w8a8_warmup": True}, "lora", NotImplementedError),
                           ({"quantize_base": True, "student_overlay": False}, "lora", ValueError)):
        cfg = tconfig.load_config_from_yaml(_tiny_yaml(tmp_path, **tpu))
        with pytest.raises(exc):
            tcli.train(cfg, prompts, rank=2, peft_type=peft, device="cpu")
    # meshes are ported (tests/test_torch_mesh_trainers.py); in one process, as on one JAX device,
    # mesh_model 2 asks for no world and trains the one-device step
    runs = []
    for tpu in ({}, {"mesh_model": 2}):
        cfg = tconfig.load_config_from_yaml(_tiny_yaml(tmp_path, **tpu))
        cfg.train.iterations = 1
        runs.append(tcli.train(cfg, prompts, rank=2, device="cpu", save_file=False).losses)
    assert runs[1] == runs[0]
