"""The port's parity harness (``eval/parity.py``), ``utils/debug.py`` and the
kernels' build directory (``tpu.compilation_cache_dir``,
``serve.py --compilation_cache_dir``) against the JAX package on the CPU.

* ``probe_inputs`` is bit-equal to JAX's for both families and seeds.
* ``dump`` of the port and JAX's ``dump_jax_activations`` over one tiny SD
  diffusers directory (the tiny UNet at SD1.5's cross-attention width 768,
  which the probes' context has; the tiny CLIP tower; fp32) pass ``compare``
  at the fp32 bound 2e-4, and ``compare`` fails a perturbed or a partial
  dump; the CLI writes the same keys.
* ``check_trainable`` and ``check_dtypes`` print JAX's counts for the same
  LoRA tree (and the same UNet); ``flush`` is a no-op on the CPU.
* ``apply_tpu_runtime_flags`` moves the kernels' build directory, and the
  trainers and ``serve.py`` call it before anything else."""

import contextlib
import dataclasses
import io
import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.eval import parity as jparity
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.utils import debug as jdebug
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.eval import parity as tparity
from sliders_conceptmod_tpu_torch.io import ldm_export as tle
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import save_file
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from sliders_conceptmod_tpu_torch.utils import debug as tdebug
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
@pytest.mark.parametrize("seed", [0, 3])
def test_probe_inputs_bit_equal(family, seed):
    got, want = tparity.probe_inputs(family, seed), jparity.probe_inputs(family, seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _component(root: Path, name: str, sd: dict, config: dict) -> None:
    (root / name).mkdir(parents=True)
    (root / name / "config.json").write_text(json.dumps(config))
    save_file(sd, str(root / name / "model.safetensors"))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A tiny SD diffusers directory: the tiny UNet at cross-attention width
    768 and the tiny CLIP tower (seeded, written by the port)."""
    root = tmp_path_factory.mktemp("parity") / "tiny-sd-dir"
    ucfg, tcfg = UNetConfig.tiny(cross_attention_dim=768), CLIPTextConfig.tiny()
    unet = tfactory.build_module(lambda: UNet2DConditionModel(ucfg), "cpu", torch.float32, 1)
    te = tfactory.build_module(lambda: CLIPTextEncoder(tcfg), "cpu", torch.float32, 0)
    _component(root, "unet", unet.state_dict(), dataclasses.asdict(ucfg))
    _component(root, "text_encoder", tle.export_clip_text(te.state_dict(), prefix=""),
               {k: getattr(tcfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                                              "num_attention_heads", "max_position_embeddings", "hidden_act")})
    return root


def test_port_dump_matches_jax_dump(tiny_dir, tmp_path, capsys):
    jparity.dump_jax_activations(str(tiny_dir), "sd15", str(tmp_path / "jax.npz"))
    tparity.main(["dump", "--model_dir", str(tiny_dir), "--family", "sd15", "--out", str(tmp_path / "port.npz"),
                  "--device", "cpu"])
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files) == ["text_last_hidden", "text_penultimate", "unet_out"]
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype == np.float32, k
    assert tparity.compare(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"), atol=2e-4)
    assert jparity.compare(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"), atol=2e-4)
    np.savez(tmp_path / "moved.npz", **{k: b[k] * (1.01 if k == "unet_out" else 1.0) for k in b.files})
    assert not tparity.compare(str(tmp_path / "jax.npz"), str(tmp_path / "moved.npz"), atol=2e-4)
    np.savez(tmp_path / "part.npz", unet_out=b["unet_out"])
    assert not tparity.compare(str(tmp_path / "jax.npz"), str(tmp_path / "part.npz"), atol=2e-4)
    with pytest.raises(SystemExit) as exit_code:
        tparity.main(["compare", "--a", str(tmp_path / "jax.npz"), "--b", str(tmp_path / "port.npz"), "--atol",
                      "2e-4"])
    assert exit_code.value.code == 0
    assert "PARITY OK" in capsys.readouterr().out
    assert "diffusers" in tparity.TORCH_REFERENCE_SNIPPET  # kept as text: nothing imports diffusers


def _printed(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_debug_prints_jax_counts():
    _, _, junet, _ = jfactory.load_models_xl("tiny-xl")
    jsites = jlora.create_sites(junet.params, rank=2, alpha=1.0, train_method="full")
    jlp = jlora.init_lora_params(jax.random.PRNGKey(0), jsites)
    unet = UNet2DConditionModel(UNetConfig.tiny_xl())
    assert not load_jax_params(unet, to_numpy_tree(junet.params))
    tsites = tlora.create_sites(unet, rank=2, alpha=1.0, train_method="full")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    got, want = _printed(tdebug.check_trainable, tlp), _printed(jdebug.check_trainable, jlp)
    assert got.splitlines()[-1] == want.splitlines()[-1]  # "... N trainable leaves, M params"
    assert [line.split()[1] for line in got.splitlines()[:-1]] == [line.split()[1] for line in want.splitlines()[:-1]]
    assert _printed(tdebug.check_dtypes, tlp) == _printed(jdebug.check_dtypes, jlp)
    assert _printed(tdebug.check_dtypes, unet) == _printed(jdebug.check_dtypes, junet.params)
    tdebug.flush()  # the CPU: nothing to free


@pytest.fixture
def restore_build_dir():
    before = fa.BUILD_DIR
    yield
    fa.set_build_dir(before)


class _Stop(Exception):
    pass


def _stop(*a, **k):
    raise _Stop


def test_compilation_cache_dir_moves_the_build_directory(tmp_path, monkeypatch, restore_build_dir):
    assert fa.BUILD_DIR.name == "kernels"
    tdebug.apply_tpu_runtime_flags(None)
    tdebug.apply_tpu_runtime_flags(tconfig.TPUConfig())  # unset: the default stays
    assert fa.BUILD_DIR.name == "kernels"
    tdebug.apply_tpu_runtime_flags(tconfig.TPUConfig(compilation_cache_dir=str(tmp_path / "a"),
                                                     persistent_cache_min_compile_seconds=0.0))
    assert fa.BUILD_DIR == tmp_path / "a" and fa._library_path("fwd").parent == tmp_path / "a"
    # serve.py --compilation_cache_dir, before the service is made
    monkeypatch.setattr(tserve, "service_settings", _stop)
    with pytest.raises(_Stop):
        tserve.main(["--slider", "s.safetensors", "--compilation_cache_dir", str(tmp_path / "b")])
    assert fa.BUILD_DIR == tmp_path / "b"
    # the trainers: the tpu: block's directory, before anything else
    config = tconfig.load_config_from_yaml(os.path.join(os.path.dirname(__file__), "..", "data",
                                                        "config-tiny-xl.yaml"))
    config.tpu.compilation_cache_dir = str(tmp_path / "c")
    monkeypatch.setattr(ttrainer, "check_supported", _stop)
    with pytest.raises(_Stop):
        ttrainer.train(config, [], device="cpu")
    assert fa.BUILD_DIR == tmp_path / "c"
