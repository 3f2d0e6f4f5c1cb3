"""The int8 artifact (``io/quant_cache.py``), ``cli/quantize_checkpoint.py``
and the int8 SDXL sweep against the JAX package's, on the CPU (fp32):

* an artifact written by JAX ``save_quantized`` loads in the port, and the
  port's loads in JAX ``load_quantized``: the same keys, tensors (int8 codes
  and fp32 scales bit for bit, every other leaf at its dtype) and metadata;
  a tiny-xl artifact as ``--base`` gives both packages' loaders the same
  UNet (forward within 2e-4);
* both packages' ``quantize_checkpoint`` CLIs over the same JAX-written tiny
  single files (``tests/_sweep_cli_assets.py``) write the same artifact, and
  ``--family flux`` writes the tiny Flux transformer.

The int8 sweep and serving are tests/test_torch_quant_serve.py.

Tiny widths hold no Linear of 65,536 elements, so both packages quantize
with a limit of 1 element here (the JAX package's own tests do the same)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sweep_cli_assets as A
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.cli import quantize_checkpoint as jqc
from sliders_conceptmod_tpu.io import quant_cache as jcache
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.cli import quantize_checkpoint as tqc
from sliders_conceptmod_tpu_torch.io import quant_cache as tcache
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, read_metadata, save_file
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import unet as tunet
from test_torch_train import CTX, SEQ, slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

FWD_TOL = 2e-4


@pytest.fixture
def min_elems_1(monkeypatch):
    """Both packages quantize every Linear / Dense of the tiny models."""
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    for name in ("quantize_host_tree", "quantize_init"):
        monkeypatch.setattr(jquant, name, functools.partial(getattr(jquant, name), min_elems=1))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_assets")
    A.make_assets(root, "xl")
    (root / "sd1").mkdir()
    A.make_assets(root / "sd1", "sd1")
    return root


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _as_np(got[k]), _as_np(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_loads_across_packages(slice_setup, tmp_path, dtype):
    model, params, port, *_ = slice_setup
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    qtree, jscales = jquant.quantize_params(jax.tree.map(lambda a: jnp.asarray(a, jdt), params), min_elems=1)
    meta = {"family": "xl", "source": "test"}

    # JAX writes, the port reads
    jpath = str(tmp_path / "jax.int8.safetensors")
    jcache.save_quantized(jpath, qtree, jscales, metadata=meta)
    assert tcache.is_quantized_artifact(jpath) and read_metadata(jpath)[tcache.FORMAT_KEY] == "int8-percol-v1"
    ttree, tscales = tcache.load_quantized(jpath, tdt)
    jtree, jscales2 = jcache.load_quantized(jpath, jdt)
    _assert_same(_flat(ttree), _flat(jtree))
    _assert_same({"/".join(k): v for k, v in tscales.items()}, {"/".join(k): v for k, v in jscales2.items()})

    # the port writes (a UNet quantized from the same weights), JAX reads
    tport = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()).to(tdt)
    load_jax_params(tport, to_numpy_tree(params))
    tquant.quantize_module(tport, min_elems=1)
    ppath = str(tmp_path / "port.int8.safetensors")
    assert tcache.save_quantized(ppath, tport, metadata=meta) == 60
    assert read_metadata(ppath) == read_metadata(jpath)
    assert jcache.is_quantized_artifact(ppath)
    back, back_scales = jcache.load_quantized(ppath, jdt)
    _assert_same(_flat(back), _flat(jtree))
    _assert_same({"/".join(k): v for k, v in back_scales.items()}, {"/".join(k): v for k, v in jscales2.items()})
    # byte for byte the same tensors in both files
    _assert_same(load_file(ppath), load_file(jpath))

    plain = str(tmp_path / "plain.safetensors")
    save_file({"w": torch.zeros(2)}, plain)
    with pytest.raises(ValueError) as want:
        jcache.load_quantized(plain)
    with pytest.raises(ValueError) as got:
        tcache.load_quantized(plain)
    assert str(got.value) == str(want.value)
    assert not tcache.is_quantized_artifact(plain) and not tcache.is_quantized_artifact(A.__file__)


def test_artifact_as_base_gives_both_loaders_one_unet(slice_setup, tmp_path):
    """A tiny-xl artifact as ``--base``: the port's ``load_models_xl`` and
    JAX's take the UNet from it (the weightless towers and VAE are each
    package's own), and their forwards agree within 2e-4."""
    _, params, *_ = slice_setup
    qtree, jscales = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_elems=1)
    path = str(tmp_path / "tiny-xl.int8.safetensors")
    jcache.save_quantized(path, qtree, jscales)
    _, _, jb, _ = jfactory.load_models_xl(path)
    _, tes, unet, _, vae = tfactory.load_models_xl(path, weight_dtype=torch.float32, device="cpu", with_vae=True)
    assert tquant.is_quantized(unet) and len(tquant.quant_scales(unet)) == 60
    assert vae is not None and len(tes) == 2
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.asarray([30.0, 700.0], np.float32)
    ctx = rng.standard_normal((2, SEQ, CTX)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((2, 32)).astype(np.float32),
             "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))}
    want = np.asarray(jb.apply_fn()(jb.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                    added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()}))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()}).numpy()
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()


@pytest.mark.parametrize("family", ["xl", "sd1"])
def test_quantize_checkpoint_cli_writes_jax_artifact(assets, tmp_path, min_elems_1, family):
    """Both CLIs over the same JAX-written tiny single file, fp32: the same
    keys, int8 codes, scales and other leaves, bit for bit."""
    base = str(assets / "tiny-xl.safetensors" if family == "xl" else assets / "sd1" / "tiny-sd1.safetensors")
    argv = ["--base", base, "--family", family, "--precision", "float32"]
    name = "tiny-xl" if family == "xl" else "tiny-sd1"  # a "tiny" name loads as the tiny family
    jout, tout = str(tmp_path / f"{name}.jax.safetensors"), str(tmp_path / f"{name}.port.safetensors")
    jqc.run(jqc.build_parser().parse_args(argv + ["--out", jout]))
    n = tqc.main(argv + ["--out", tout, "--device", "cpu"])
    assert n == (60 if family == "xl" else 50)
    assert read_metadata(tout) == read_metadata(jout)
    _assert_same(load_file(tout), load_file(jout))
    # the artifact is a base: it loads in the loaders of its family
    loader = tfactory.load_models_xl if family == "xl" else tfactory.load_models
    unet = loader(tout, weight_dtype=torch.float32, device="cpu")[2]
    assert len(tquant.quant_scales(unet)) == n


def test_quantize_checkpoint_cli_weightless_and_refusals(tmp_path, capsys):
    out = str(tmp_path / "tiny-xl.int8.safetensors")
    assert tqc.main(["--base", "tiny-xl", "--family", "xl", "--out", out, "--device", "cpu"]) == 0
    assert f"wrote {out}: 0 int8 kernels (family=xl)" in capsys.readouterr().out
    assert tcache.is_quantized_artifact(out)
    # sd3 and flux quantize since their slices (tests/test_torch_sd3_io.py, tests/test_torch_flux_io.py)
    flux_out = str(tmp_path / "tiny-flux.int8.safetensors")
    assert tqc.main(["--base", "tiny-flux", "--family", "flux", "--out", flux_out, "--device", "cpu"]) == 0
    assert f"wrote {flux_out}: 0 int8 kernels (family=flux)" in capsys.readouterr().out
    assert tqc.build_parser().parse_args(["--base", "b", "--family", "sd1", "--out", "o"]).precision == "bfloat16"
