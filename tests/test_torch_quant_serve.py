"""The int8 base in serving and in the SDXL sweep against the JAX package's,
on the CPU (fp32):

* a tiny-xl ``SliderService`` with ``quantize_base`` and with ``w8a8``
  against JAX's service: one padded two-row sampler call from the same
  weights, slider and latents, decoded by one VAE; the flags through
  ``service_settings``;
* the SDXL sweep CLI with ``--quantize_base --batch_scales`` against the
  JAX CLI: pixels within 1 of 255 (the fp32 bound of
  ``tests/test_torch_sweep_cli_xl.py``); with ``--w8a8 --batch_scales``
  within ``W8A8_PIXEL``; and JAX's refusal of ``--quantize_base`` without
  ``--batch_scales`` word for word.

W8A8 re-derives the activation codes at every Linear of every step, so an
fp32 rounding difference (~1e-7) next to a rounding midpoint moves a code by
one: the sampler is not continuous in its inputs. Measured on the CPU: the
sweep of the port against JAX's differs by at most 4 of 255 (mean 0.64), and
the port against itself with the initial latents scaled by 1 + 1e-6 differs
as much (at most 4, mean 0.68); the service's two-row call differs by at
most 6 (mean 0.64). The W8A8 bounds are twice the measured gaps.

Tiny widths hold no Linear of 65,536 elements, so both packages quantize
with a limit of 1 element here (the JAX package's own tests do the same)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _sweep_cli_assets as A
from sliders_conceptmod_tpu import serve as jserve
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.cli import generate_images_xl as jcli_xl
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.cli import generate_images_xl as tcli_xl
from sliders_conceptmod_tpu_torch.infer.generate import latents_to_images
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

W8A8_PIXEL = (8, 1.5)  # the sweep: max and mean of |port − JAX| in 0..255


@pytest.fixture
def min_elems_1(monkeypatch):
    """Both packages quantize every Linear / Dense of the tiny models."""
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    for name in ("quantize_host_tree", "quantize_init"):
        monkeypatch.setattr(jquant, name, functools.partial(getattr(jquant, name), min_elems=1))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_sweep")
    A.make_assets(root, "xl")
    return root


# ---------------------------------------------------------------------------
# the int8 SDXL sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["--quantize_base", "--w8a8"])
def test_int8_sweep_matches_jax(assets, tmp_path, monkeypatch, min_elems_1, flag):
    A.fp32(monkeypatch, jcli_xl, tcli_xl)
    extra = ["--start_noise", "500", "--batch_scales", flag]
    jcli_xl.run(jcli_xl.build_parser().parse_args(A.args(assets, "xl", tmp_path / "jax", *extra)))
    monkeypatch.setattr(tcli_xl, "draw_latents", A.jax_draw)
    tcli_xl.main(A.args(assets, "xl", tmp_path / "port", *extra, "--device", "cpu"))
    if flag == "--quantize_base":
        A.assert_same_sweep(tmp_path / "port", tmp_path / "jax", fp32=True)
        return
    assert A.tree(tmp_path / "port") == A.tree(tmp_path / "jax")
    for name in A.tree(tmp_path / "jax"):
        got, want = (np.asarray(Image.open(tmp_path / root / name)).astype(int) for root in ("port", "jax"))
        diff = np.abs(got - want)
        print(f"{name}: max {diff.max()}, mean {diff.mean():.3f}")
        assert diff.max() <= W8A8_PIXEL[0] and diff.mean() <= W8A8_PIXEL[1], name


def test_int8_sweep_needs_batch_scales(assets, tmp_path):
    for flag in ("--quantize_base", "--w8a8"):
        with pytest.raises(SystemExit) as want:
            jcli_xl.run(jcli_xl.build_parser().parse_args(A.args(assets, "xl", tmp_path / "jax", flag)))
        with pytest.raises(SystemExit) as got:
            tcli_xl.main(A.args(assets, "xl", tmp_path / "port", flag, "--device", "cpu"))
        assert str(got.value) == str(want.value) and "requires --batch_scales" in str(got.value)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xl_slider(tmp_path_factory):
    _, _, junet, _ = jfactory.load_models_xl("tiny-xl")
    conv = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV
    sites = jlora.create_sites(junet.params, rank=2, alpha=1.0, target_replace=conv, train_method="full")
    rng = np.random.default_rng(5)
    lp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(5), sites))
    path = tmp_path_factory.mktemp("int8_serve") / "slider_full_rank2_alpha1.safetensors"
    jlora.save_weights(str(path), sites, lp)
    return str(path)


# |port − JAX| in 0..255 of the decoded two-row group
SERVE_PIXEL = {"quantize_base": (1, 0.05), "w8a8": (12, 1.5)}


@pytest.mark.parametrize("mode", ["quantize_base", "w8a8"])
def test_int8_service_matches_jax(xl_slider, monkeypatch, min_elems_1, mode):
    """One padded two-row sampler call of both services (fp32, 3 DDIM steps,
    the slider from step 1), the sampled latents decoded by one seeded tiny
    VAE. Weight-only: within 1 of 255; W8A8: see the module docstring."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jserve, "jnp", proxy)
    monkeypatch.setattr(tserve.SliderService, "weight_dtype", torch.float32)
    jvae = jfactory.VAEBundle(jfactory.AutoencoderKL(jfactory.VAEConfig.tiny()), {}, jfactory.VAEConfig.tiny())
    monkeypatch.setattr(jfactory, "_load_or_init_vae", lambda *a, **k: jvae)
    monkeypatch.setattr(tfactory, "_vae", lambda name, cfg, device, dtype, seed: tfactory.build_module(
        lambda: AutoencoderKL(VAEConfig.tiny()), device, dtype, seed))
    monkeypatch.setattr(jserve, "latents_to_images", lambda decode, latents, scaling: np.asarray(latents))
    monkeypatch.setattr(tserve, "latents_to_images", lambda decode, latents, scaling: latents.numpy())
    flags = {mode: True}
    kw = dict(image_size=64, steps=3, start_noise=500)
    jsvc = jserve.SliderService("tiny-xl", xl_slider, microbatch=False, **flags, **kw)
    tsvc = tserve.SliderService("tiny-xl", xl_slider, device="cpu", **flags, **kw)
    try:
        assert jsvc.unet.act_quant == (mode == "w8a8") and jsvc.unet.quant_scales
        acts = {m.act_quant for m in tsvc.unet.modules() if isinstance(m, tquant.QuantLinear)}
        assert acts == {mode == "w8a8"}
        assert load_jax_params(tsvc.unet, to_numpy_tree(jsvc.unet.params)) == []
        for te, jte in zip(tsvc.text_encoders, jsvc.text_encoders):
            assert load_jax_params(te.model, to_numpy_tree(jte.params)) == []
        monkeypatch.setattr(tsvc, "_initial_latents", lambda gens: torch.cat([
            torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(s), (1, 4, 8, 8), jnp.float32)))
            for s in (7, 9)]))
        padded = [("a photo of a person", 1.5, 7, 7.5, "default"), ("a red car", -2.0, 9, 7.5, "default")]
        want = jsvc._sample_group(padded, 7.5, jsvc._resolve("default"))
        got = tsvc._sample_group(padded, 7.5, tsvc._resolve("default"))
        decode = tsvc.vae.decode
        images = [latents_to_images(decode, torch.from_numpy(np.asarray(x)), 0.13025) for x in (got, want)]
        diff = np.abs(images[0].astype(int) - images[1].astype(int))
        print(f"{mode}: pixel gap max {diff.max()}, mean {diff.mean():.3f}")
        assert diff.max() <= SERVE_PIXEL[mode][0] and diff.mean() <= SERVE_PIXEL[mode][1]
    finally:
        tsvc.close()


def test_serve_flags_reach_the_service():
    args = tserve.build_parser().parse_args(["--slider", "s.safetensors", "--w8a8"])
    cls, kwargs = tserve.service_settings(args)
    assert cls is tserve.SliderService and kwargs["w8a8"] and not kwargs["quantize_base"]
    args = tserve.build_parser().parse_args(["--slider", "s.safetensors", "--base", "sd15", "--family", "sd1",
                                             "--quantize_base"])
    cls, kwargs = tserve.service_settings(args)
    assert cls is tserve.SD1SliderService and kwargs["quantize_base"] and not kwargs["w8a8"]
