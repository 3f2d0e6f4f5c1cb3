"""The port's notrigger CLI (``cli/train_notrigger.py``) against the JAX
package's, on the tiny-xl CLIP towers (``tests/test_torch_notrigger.py``
holds the towers and the step parity):

* the parser's flags and defaults, and the save names ``main`` makes;
* the written file's keys (JAX's, in ``save.precision``) and its load
  through ``adapters/slider_file.py::load_slider_file`` as a text-encoder
  part of the tower it was trained in, as LoRA or DoRA;
* a resume from the ``{name}_{clip_index}_resume.pt`` continues bit for bit;
* the early exit fires on a stalled logger;
* unknown models raise (FLUX.1 trains since its slice), and the int8
  knobs raise JAX's message.
"""

import os

import pytest
import torch

from sliders_conceptmod_tpu.cli import train_notrigger as jcli
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import slider_file as tsfile
from sliders_conceptmod_tpu_torch.cli import train_notrigger as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.train import loop_utils as tloop
from sliders_conceptmod_tpu_torch.train import notrigger as tnt
from test_torch_notrigger import LR, NEG, POS, towers  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parser_and_save_names_equal_jax(monkeypatch):
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jacts = {a.dest: (a.default, a.required, a.nargs) for a in jp._actions if a.dest not in ("help", "device")}
    tacts = {a.dest: (a.default, a.required, a.nargs) for a in tp._actions if a.dest not in ("help", "device")}
    assert tacts == jacts and tacts["peft_type"][0] == "dora" and tacts["clip_index"][1]
    assert tp.parse_args(["--config_file", "c", "--alpha", "1", "--clip_index", "0"]).device == "cuda"
    argv = ["--config_file", os.path.join(REPO, "data", "config-notrigger-xl.yaml"), "--alpha", "2", "--rank", "8",
            "--clip_index", "1", "--positive", "very", "happy", "--negative", "sad", "--name", "nt"]
    seen = {}

    def capture(which):
        def fake_train(config, **kw):
            seen[which] = (config.save.name, config.save.path, config.network.alpha, config.network.rank,
                           {k: v for k, v in kw.items() if k not in ("device",)})
        return fake_train

    monkeypatch.setattr(jcli, "train", capture("jax"))
    monkeypatch.setattr(tcli, "train", capture("port"))
    jcli.main(jp.parse_args(argv))
    tcli.main(tp.parse_args(argv + ["--device", "cpu"]))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == "nt_alpha2.0_rank8_noxattn" and seen["port"][4]["positive"] == "very happy"


def _config(path, iterations=3, per_steps=1000, precision="bfloat16"):
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-notrigger-xl.yaml"))
    cfg.save.path, cfg.save.per_steps, cfg.save.precision = str(path), per_steps, precision
    cfg.train.iterations, cfg.train.precision, cfg.train.lr = iterations, "fp32", LR
    return cfg


@pytest.mark.parametrize("clip_index,peft", [(0, "dora"), (1, "lora")])
def test_written_file_has_jax_keys_and_loads_as_a_text_encoder_part(towers, tmp_path, clip_index, peft):
    """The file of the port's trainer (``--model tiny``) against the JAX
    trainer's over the same towers: the same keys in ``save.precision``;
    the port's ``load_slider_file`` binds it to the right tower with the
    adapter it was trained as."""
    jcfg = jconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-notrigger-xl.yaml"))
    jcfg.save.path, jcfg.train.iterations, jcfg.train.precision = str(tmp_path / "jax"), 2, "fp32"
    jcli.train(jcfg, positive=POS, negative=NEG, clip_index=clip_index, peft_type=peft, model="tiny")
    tcli.train(_config(tmp_path / "port", iterations=2), positive=POS, negative=NEG, clip_index=clip_index,
               peft_type=peft, model="tiny", device="cpu")
    name = f"notrigger_slider_{clip_index}_last.safetensors"
    want = tst.load_file(str(tmp_path / "jax" / name))
    got = tst.load_file(str(tmp_path / "port" / name))
    assert set(got) == set(want) and all(got[k].dtype == want[k].dtype == torch.bfloat16 for k in got)
    assert all(k.startswith(f"lora_te{clip_index + 1}_text_model_encoder_layers_") for k in got)
    parts = tsfile.load_slider_file(str(tmp_path / "port" / name), text_encoders=[t.model for t in towers[1]])
    assert [p.index for p in parts.te_parts] == [clip_index] and parts.unet is None
    assert parts.te_parts[0].peft is (tdora if peft == "dora" else tlora)
    with parts.merged_text_encoders(1.0):
        pass


def test_resume_continues_bit_for_bit(tmp_path):
    full = _config(tmp_path / "full", iterations=4, per_steps=2, precision="fp32")
    tcli.train(full, positive=POS, negative=NEG, clip_index=0, peft_type="dora", model="tiny", device="cpu")
    assert sorted(os.listdir(tmp_path / "full")) == [
        "notrigger_slider_0_2steps.safetensors", "notrigger_slider_0_last.safetensors",
        "notrigger_slider_0_resume.pt", "notrigger_slider_metrics.jsonl"]
    resumed = _config(tmp_path / "resumed", iterations=4, per_steps=2, precision="fp32")
    tcli.train(resumed, positive=POS, negative=NEG, clip_index=0, peft_type="dora", model="tiny", device="cpu",
               resume_from=str(tmp_path / "full"))
    a = tst.load_file(str(tmp_path / "full" / "notrigger_slider_0_last.safetensors"))
    b = tst.load_file(str(tmp_path / "resumed" / "notrigger_slider_0_last.safetensors"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_early_exit_fires_on_a_stalled_logger(tmp_path, monkeypatch):
    """The reference's stall check (every 800 steps past 1000): with the
    logger's loss stuck, the run stops at step 2400, after the check at
    1600 saw the same loss."""
    def cheap_step(*a, **k):
        return lambda opt_state: {"loss": torch.zeros(())}

    monkeypatch.setattr(tnt, "make_notrigger_step", cheap_step)
    monkeypatch.setattr(tloop.MetricsLogger, "current_loss", lambda self: 0.5)
    done = []
    tcli.train(_config(tmp_path, iterations=5000), positive=POS, clip_index=1, peft_type="lora", model="tiny",
               device="cpu", save_file=False, on_step_complete=done.append)
    assert done[-1] == 2399 and len(done) == 2400


def test_refusals():
    cfg = _config("/nonexistent")
    for model in ("FLUX.2", "flux"):  # SD3 and FLUX.1 train since their slices (tests/test_torch_flux_io.py)
        with pytest.raises(NotImplementedError, match="not supported"):
            tcli.train(cfg, positive=POS, clip_index=0, model=model, device="cpu")
    with pytest.raises(NotImplementedError, match="not supported"):
        tcli.train(cfg, positive=POS, clip_index=0, model="SD2", device="cpu")
    cfg.tpu.quantize_base = True
    jcfg = jconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-notrigger-xl.yaml"))
    jcfg.tpu.quantize_base = True
    with pytest.raises(NotImplementedError) as jerr:
        jcli.train(jcfg, positive=POS, clip_index=0, model="tiny")
    with pytest.raises(NotImplementedError) as terr:
        tcli.train(cfg, positive=POS, clip_index=0, model="tiny", device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="at least one"):
        tcli.train(_config("/nonexistent"), positive="", clip_index=0, model="tiny", device="cpu")
