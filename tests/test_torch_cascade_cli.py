"""The port's Stable Cascade trainer against the JAX package's:

* ``samples_per_step`` 2, with and without ``share_warmup`` (the port runs
  the samples one after the other and accumulates; JAX vmaps them): two
  steps on the tiny prior within 2e-4 (``tests/_cascade_assets.py``);
* the CLI through ``main`` on ``data/config-tiny-cascade.yaml``: the saved
  ``.pt`` key set is the JAX trainer's, a resumed run is bit-identical; its
  parser and save name are the JAX CLI's, and a bare integer ``--device`` is
  a CUDA ordinal;
* ``train_lora`` returns the reference-schema state dict;
* the trainer's refusals: JAX's words for ``quantize_base``,
  ``w8a8_warmup`` with DoRA and ``overlay_warmup``; meshes are ported
  (queue 1, item 12): ``mesh_data`` 2 in one process trains the one-device
  step.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.cli import train_lora_cascade as jcli
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.cli import train_lora_cascade as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from _cascade_assets import check_two_steps
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("share", [False, True])
def test_two_samples_per_step_match_jax(share):
    check_two_steps("euler_a", "merged", samples=2, share=share)


def _tiny_yaml(tmp_path, **tpu):
    """data/config-tiny-cascade.yaml saving under ``tmp_path`` every 2 steps."""
    text = open(os.path.join(REPO, "data", "config-tiny-cascade.yaml")).read()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{os.path.join(REPO, "data", "prompts-tiny.yaml")}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"').replace("per_steps: 200", "per_steps: 2")
    text = text.replace("verbose: true", "verbose: false")
    text += "".join(f"  {k}: {str(v).lower()}\n" for k, v in tpu.items())
    (tmp_path / "config.yaml").write_text(text)
    return str(tmp_path / "config.yaml")


def _jax_keys(rank: int = 2):
    """The JAX trainer's saved key set on the tiny family (c3lier, full)."""
    _, _, prior, _ = jfactory.load_models_cascade("tiny-cascade")
    sites = jlora.create_sites(prior.params, rank=rank, target_replace=list(jlora.DEFAULT_TARGET_REPLACE)
                               + jlora.UNET_TARGET_REPLACE_MODULE_CONV, train_method="full")
    assert len(sites) == 16
    return {f"{s.lora_name}.{k}" for s in sites for k in ("lora_down.weight", "lora_up.weight", "alpha")}


def test_cli_trains_tiny_cascade_saves_the_jax_key_set_and_resumes_bit_identically(tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "1", "--rank", "2", "--device", "cpu"]
    res = tcli.main(tcli.build_parser().parse_args(argv))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    out = tmp_path / "out" / "tinycascade_slider_alpha1.0_rank2_full"
    assert sorted(os.listdir(out)) == [f"tinycascade_slider_alpha1.0_rank2_full_{s}" for s in (
        "2steps.pt", "last.pt", "metrics.jsonl", "resume.pt")]
    saved = torch.load(str(out / "tinycascade_slider_alpha1.0_rank2_full_last.pt"))
    assert set(saved) == _jax_keys()
    assert all(v.dtype == torch.float32 for v in saved.values())
    assert all(v.abs().max() > 0 for k, v in saved.items() if k.endswith("lora_up.weight"))

    os.replace(out, tmp_path / "first")
    resumed = tcli.main(tcli.build_parser().parse_args(argv + ["--resume_from", str(tmp_path / "first")]))
    assert resumed.losses == res.losses[3:]
    again = torch.load(str(out / "tinycascade_slider_alpha1.0_rank2_full_last.pt"))
    for k, v in saved.items():
        assert torch.equal(again[k], v), k


def test_cli_parser_and_save_name_match_the_jax_cli(monkeypatch, tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "0.5", "--rank", "8", "--name", "old",
            "--attributes", "male, female"]
    got, want = {}, {}
    monkeypatch.setattr(jcli, "train", lambda config, prompts, **kw: want.update(c=config, p=prompts, kw=kw))
    monkeypatch.setattr(tcli, "train", lambda config, prompts, **kw: got.update(c=config, p=prompts, kw=kw))
    jcli.main(jcli.build_parser().parse_args(argv))
    tcli.main(tcli.build_parser().parse_args(argv + ["--device", "1"]))
    assert (got["c"].save.name, got["c"].save.path) == (want["c"].save.name, want["c"].save.path)
    assert (got["c"].network.alpha, got["c"].network.rank) == (want["c"].network.alpha, want["c"].network.rank)
    assert [p.model_dump() for p in got["p"]] == [p.model_dump() for p in want["p"]]
    assert got["kw"]["device"] == "1" and tcli.torch_device(got["kw"]["device"]) == "cuda:1"
    jargs, targs = jcli.build_parser().parse_args(argv), tcli.build_parser().parse_args(argv)
    for flag in ("config_file", "alpha", "rank", "name", "attributes", "peft_type", "resume_from"):
        assert getattr(targs, flag) == getattr(jargs, flag), flag
    assert targs.device == "cuda"


def test_train_lora_returns_the_reference_state_dict(tmp_path, monkeypatch):
    (tmp_path / "data").mkdir()
    text = open(os.path.join(REPO, "data", "config-tiny-cascade.yaml")).read()
    (tmp_path / "data" / "config-tiny-cascade.yaml").write_text(
        text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"').replace("verbose: true", "verbose: false"))
    shutil.copy(os.path.join(REPO, "data", "prompts-tiny.yaml"), tmp_path / "data" / "prompts-tiny.yaml")
    monkeypatch.chdir(tmp_path)
    done = []
    sd = tcli.train_lora(target="", positive="pixel art", negative="sketch", unconditional="", rank=2, steps=2,
                         resolution=64, config_file="data/config-tiny-cascade.yaml", device="cpu",
                         on_step_complete=done.append)
    assert done == [0, 1]
    assert set(sd) == _jax_keys()
    assert all(isinstance(v, np.ndarray) and np.isfinite(v).all() for v in sd.values())
    spec = tprompts.load_prompts_from_yaml(str(tmp_path / "data" / "prompts-api.yaml"))[0]
    assert (spec.neutral, spec.guidance_scale, spec.action) == ("", 4, "enhance")
    assert not (tmp_path / "out").exists() or not any(p.suffix == ".pt" for p in (tmp_path / "out").rglob("*"))


def _refusal(train, cfg, prompts, peft):
    with pytest.raises((NotImplementedError, ValueError)) as e:
        train(cfg, prompts, rank=2, peft_type=peft)
    return e.type, str(e.value)


@pytest.mark.parametrize("tpu,peft", [
    ({"quantize_base": True}, "lora"),
    ({"w8a8_warmup": True}, "dora"),
    ({"student_overlay": True, "overlay_warmup": True}, "lora"),
    ({"overlay_warmup": True}, "lora"),
    ({"student_overlay": True}, "dora"),
], ids=["quantize_base", "w8a8_dora", "overlay_warmup", "overlay_warmup_merged", "overlay_dora"])
def test_trainer_refusals_match_jax_word_for_word(tmp_path, tpu, peft):
    path = _tiny_yaml(tmp_path, **tpu)
    want = _refusal(jcli.train, jconfig.load_config_from_yaml(path),
                    jprompts.load_prompts_from_yaml(os.path.join(REPO, "data", "prompts-tiny.yaml"), []), peft)
    got = _refusal(lambda *a, **k: tcli.train(*a, device="cpu", **k), tconfig.load_config_from_yaml(path),
                   tprompts.load_prompts_from_yaml(os.path.join(REPO, "data", "prompts-tiny.yaml"), []), peft)
    assert got == want


def test_meshes_cite_item_12(tmp_path):
    """Meshes are ported (item 12; tests/test_torch_mesh_trainers.py spawns
    the Cascade CLI's data axis). One sample per step and no model axis ask
    for no mesh — JAX's ``training_mesh_from_config`` returns None — so
    ``mesh_data: 2`` in one process trains the one-device step."""
    prompts = tprompts.load_prompts_from_yaml(os.path.join(REPO, "data", "prompts-tiny.yaml"), [])
    runs = []
    for tpu in ({}, {"mesh_data": 2}):
        (tmp_path / str(len(runs))).mkdir()
        cfg = tconfig.load_config_from_yaml(_tiny_yaml(tmp_path / str(len(runs)), **tpu))
        cfg.train.iterations = 2
        runs.append(tcli.train(cfg, prompts, rank=2, device="cpu", save_file=False))
    assert runs[1].losses == runs[0].losses
    for n, leaf in runs[0].lora_params.items():
        for k, t in leaf.items():
            assert torch.equal(runs[1].lora_params[n][k], t)
