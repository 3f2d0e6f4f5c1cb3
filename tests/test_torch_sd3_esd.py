"""The port's SD3 ESD step (``train/esd_sd3.py``) against the JAX package's
``make_sd3_esd_train_step``: two steps on the tiny MMDiT (fp32, 64px,
``max_denoising_steps`` 4) from the same weights, LoRA factors, prompt
embeddings and random draws (derived from the JAX step key); loss, grad
norm and every factor within 2e-4.

* routes: the default (overlay student, merged warm-up), the overlay
  throughout, the merged student, and DoRA (merged);
* ``train.cfg`` 7.0 (the 4-row teacher, the slider on in the student's uncond
  row) and 1.0 (cond rows only);
* ``samples_per_step`` 2, with and without ``share_warmup``;
* the port's student with its blocks checkpointed (the JAX step's remat off:
  the numbers are the same);
* the CLI through ``main`` on ``data/config-tiny-sd3.yaml``: the saved key
  set is the JAX trainer's, a resumed run is bit-identical; its parser and
  save name are the JAX CLI's; the JAX trainer's refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.cli import train_lora_sd3 as jcli
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import flow_match as jflow
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import esd_sd3 as jesd3
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import train_lora_sd3 as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import esd_sd3 as tesd3
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _sd3_assets import STEP_TOL, emb, random_mmdit
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_STEPS = 4
SETTINGS = [
    dict(target="person", positive="person, very old", unconditional="person, young", neutral="person",
         action="enhance", guidance_scale=4, resolution=64),
    dict(target="sky", positive="blue sky", negative="grey sky", action="erase", guidance_scale=2.0, resolution=64),
]


def _draws(key, n_pairs, samples, share):
    """The port's draws from the JAX step key, as the JAX step draws them."""
    keys = [key] if samples == 1 else list(jax.random.split(key, samples))
    out = []
    for k in keys:
        k_pair, k_t, k_noise = jax.random.split(k, 3)
        pair = int(jax.random.randint(k_pair, (), 0, n_pairs))
        t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS))
        lat0 = np.array(jax.random.normal(k_noise, (1, 16, 8, 8), jnp.float32))
        out.append(tesd3.Draw(pair, t_to, torch.from_numpy(lat0)))
    return out


# (train.cfg, (student_overlay, overlay_warmup), peft, samples_per_step, share_warmup, port remat)
CASES = [
    (7.0, (True, False), "lora", 1, False, True),
    (1.0, (True, False), "lora", 1, False, False),
    (7.0, (True, True), "lora", 1, False, False),
    (7.0, (False, None), "lora", 1, False, True),
    (1.0, (False, None), "dora", 1, False, False),
    (7.0, (True, False), "lora", 2, False, False),
    (1.0, (True, False), "lora", 2, True, False),
]


@pytest.mark.parametrize("train_cfg,route,peft,samples,share,remat", CASES)
def test_sd3_esd_steps_match_jax(train_cfg, route, peft, samples, share, remat):
    jpeft, tpeft = (jdora, tdora) if peft == "dora" else (jlora, tlora)
    student_overlay, overlay_warmup = route
    model, params, port = random_mmdit()
    rng = np.random.default_rng(5)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jlp = (jdora.init_lora_params(jax.random.PRNGKey(1), jsites, base_params=params) if peft == "dora"
           else jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    # non-zero up factors, so the first step's gradient reaches the downs too
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]

    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SETTINGS],
                                   lambda p: tuple(jnp.asarray(a) for a in emb(p)))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                   lambda p: tuple(torch.from_numpy(a) for a in emb(p)))
    jschedule = jflow.FlowMatchScheduler(shift=3.0).set_timesteps(MAX_STEPS)
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    jcfg = jesd3.SD3ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=64, width=64,
                              remat=False, samples_per_step=samples, share_warmup=share)

    def apply(p, *a):
        return model.apply({"params": p}, *a)

    jstep = jesd3.make_sd3_esd_train_step(apply, jsites, jschedule, jopt, jcfg, merge_fn=jpeft.merge_lora_params,
                                          student_overlay=student_overlay, overlay_warmup=overlay_warmup)
    tlp = tpeft.load_weights_from_tensors(jpeft.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    tstep = tesd3.make_sd3_esd_train_step(
        port, tsites, tlp, tflow.FlowMatchScheduler(shift=3.0).set_timesteps(MAX_STEPS), topt,
        tesd3.SD3ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=64, width=64,
                           remat=remat, samples_per_step=samples, share_warmup=share,
                           student_overlay=student_overlay, overlay_warmup=overlay_warmup),
        merge_fn=tpeft.merge_lora_params)
    tstate = topt.init(toptim.flat_params(tsites, tlp))

    lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
    jstate = jopt.init(lp)
    before = tpeft.state_dict_numpy(tsites, tlp)
    for i, seed in enumerate((11, 12)):
        key = jax.random.PRNGKey(seed)
        draws = _draws(key, len(SETTINGS), samples, share)
        lp, jstate, jm = jstep(params, lp, jstate, key, jbank)
        tm = tstep(tstate, tbank, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
        want = jpeft.state_dict_numpy(jsites, lp)
        got = tpeft.state_dict_numpy(tsites, tlp)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=f"step {i}: {k}")
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 5e-3  # the factors moved


def test_step_refusals_match_jax():
    _, _, port = random_mmdit()
    sites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    lp = tlora.init_lora_params(sites)
    sched = tflow.FlowMatchScheduler().set_timesteps(4)
    opt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10))
    for cfg, kw in ((tesd3.SD3ESDConfig(share_warmup=True), {}),
                    (tesd3.SD3ESDConfig(student_overlay=False, overlay_warmup=True), {}),
                    (tesd3.SD3ESDConfig(student_overlay=False), {"warm_transformer": port}),
                    (tesd3.SD3ESDConfig(student_overlay=True, overlay_warmup=False), {"warm_transformer": port})):
        with pytest.raises(ValueError):
            tesd3.make_sd3_esd_train_step(port, sites, lp, sched, opt, cfg, **kw)


# ---------------------------------------------------------------------------
# the trainer through the CLI
# ---------------------------------------------------------------------------


def _tiny_yaml(tmp_path, **tpu):
    """data/config-tiny-sd3.yaml saving under ``tmp_path`` every 2 steps."""
    text = open(os.path.join(REPO, "data", "config-tiny-sd3.yaml")).read()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{os.path.join(REPO, "data", "prompts-tiny.yaml")}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"').replace("per_steps: 200", "per_steps: 2")
    text = text.replace("verbose: true", "verbose: false")
    text += "".join(f"  {k}: {str(v).lower()}\n" for k, v in tpu.items())
    (tmp_path / "config.yaml").write_text(text)
    return str(tmp_path / "config.yaml")


def test_cli_trains_tiny_sd3_saves_the_jax_key_set_and_resumes_bit_identically(tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "1", "--rank", "2", "--device", "cpu"]
    res = tcli.main(tcli.build_parser().parse_args(argv))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    assert {r["timesteps_to"] for r in res.metrics} <= set(range(1, MAX_STEPS))
    out = tmp_path / "out" / "tinysd3_slider_alpha1.0_rank2_full"
    assert sorted(os.listdir(out)) == [f"tinysd3_slider_alpha1.0_rank2_full_{s}" for s in (
        "2steps.safetensors", "last.safetensors", "metrics.jsonl", "resume.pt")]
    saved = tst.load_file(str(out / "tinysd3_slider_alpha1.0_rank2_full_last.safetensors"))
    _, _, jtr, _ = jfactory.load_models_sd3("tiny-sd3")
    jsites = jlora.create_sites(jtr.params, rank=2, alpha=1.0, target_replace=["Attention"], train_method="full",
                                delimiter="-")
    assert set(saved) == {f"{s.lora_name}.{k}" for s in jsites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    assert all(v.abs().max() > 0 for k, v in saved.items() if k.endswith("lora_up.weight"))

    os.replace(out, tmp_path / "first")
    resumed = tcli.main(tcli.build_parser().parse_args(argv + ["--resume_from", str(tmp_path / "first")]))
    assert resumed.losses == res.losses[3:]
    again = tst.load_file(str(out / "tinysd3_slider_alpha1.0_rank2_full_last.safetensors"))
    for k, v in saved.items():
        assert torch.equal(again[k], v), k


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
                           ({"w8a8_warmup": True}, "dora", NotImplementedError),
                           ({"w8a8_warmup": True, "student_overlay": False}, "lora", ValueError),
                           ({"w8a8_warmup": True, "overlay_warmup": False}, "lora", ValueError)):
        cfg = tconfig.load_config_from_yaml(_tiny_yaml(tmp_path, **tpu))
        with pytest.raises(exc):
            tcli.train(cfg, prompts, rank=2, peft_type=peft, device="cpu")
