"""Flux serving, the packed sampler and the Flux sweep CLI in the port against
the JAX package, on the CPU, over a tiny Flux diffusers directory
(``_flux_assets.write_tiny_flux_dir``: the tiny transformer, a tiny T5 and
CLIP, a synthetic ``spiece.model`` and a tiny VAE with FLUX.1's scaling
and shift) that both packages load.

* the packed sampler (``sample_packed_flow``) against JAX's jitted
  ``make_packed_overlay_sampler`` at scales -2, 0
  and 2 (the slider from step 1 of 3), schnell and dev (a guidance input):
  fp32 tokens within 1e-3;
* the ``indexed`` call over two stacked sliders against JAX's indexed
  sampler, and against each slider's solo call;
* ``FluxSliderService`` against JAX's ``_sample_group``: one padded two-row
  group (two seeds, scales +1.5 and -2), with a transformer slider and with
  a T5 text-encoder part (te2 merged per row); fp32, the initial latents
  JAX's ``normal(PRNGKey(seed))``; images within 1 of 255;
* ``--quantize_base`` and ``--w8a8`` services against JAX's (every Dense
  int8), within the bounds of ``tests/test_torch_quant_serve.py``;
* the service end to end (PNG bytes, the scale moves the image, a stacked
  pair, HTTP), ``main``'s Flux settings and its ``--static_guidance``
  refusal;
* ``cli/generate_images_flux`` against the JAX CLI over the directory (its
  VAE decodes): fp32 within 1 of 255 per pixel, the tree of files; and with
  ``--quantize_base`` (the overlay route).
"""

import functools
import os
import threading
import types
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sliders_conceptmod_tpu import serve as jserve
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.adapters import slider_file as jsfile
from sliders_conceptmod_tpu.cli import generate_images_flux as jgen_cli
from sliders_conceptmod_tpu.diffusion import flow_match as jflow
from sliders_conceptmod_tpu.infer import generate_flow as jgf
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models import flux as jflux
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.cli import generate_images_flux as tgen_cli
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.infer import generate_flow as tgf
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.png import decode_png
from _flux_assets import LATENT_TOL, random_flux, write_flux_slider, write_tiny_flux_dir
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

SLIDER = "flux_slider_full_rank2_alpha1.safetensors"
SERVE_PIXEL = {"quantize_base": (1, 0.05), "w8a8": (12, 1.5)}  # tests/test_torch_quant_serve.py's bounds


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("flux_serve")
    base = write_tiny_flux_dir(root)
    _, params, _ = random_flux()
    slider = write_flux_slider(root / SLIDER, params)
    other = write_flux_slider(root / "other.safetensors", params, seed=12)
    # a T5 text-encoder part (a notrigger FLUX.1 te2 save's keys)
    _, enc, _, _ = jfactory.load_models_flux(str(base))
    sites = jlora.create_sites(enc.text_encoder_params[1], rank=2, alpha=1.0, target_replace=["T5Attention"],
                               prefix="lora_te2", train_method="t5attn",
                               name_path_prefix=jsfile.T5_NAME_PATH_PREFIX)
    rng = np.random.default_rng(3)
    lp = jax.tree.map(lambda a: jnp.asarray(0.5 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(3), sites))
    te = root / "te.safetensors"
    jlora.save_weights(str(te), sites, lp)
    return dict(base=str(base), slider=slider, other=other, te=str(te), params=params)


def _inputs(b=3, g=4, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, g * g, 16)).astype(np.float32), r.standard_normal((b, 8, 32)).astype(np.float32),
            r.standard_normal((b, 32)).astype(np.float32))


@pytest.mark.parametrize("dev", [False, True])
def test_packed_sampler_matches_jax(assets, dev):
    model, params, port = random_flux(dev=dev)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jlp = jlora.load_weights(assets["slider"], jsites)
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    tlp = tlora.load_weights(assets["slider"], tsites)
    mu = jflow.calculate_shift(16)
    jsched = jflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(3, mu=mu)
    tsched = tflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(3, mu=mu)
    ids = jflux.prepare_latent_image_ids(4, 4)
    apply = lambda p, *a, **kw: model.apply({"params": p}, *a, **kw)  # noqa: E731
    jsample = jgf.make_packed_overlay_sampler(apply, jsites, jsched, 1, jnp.asarray(ids), dev)
    tids = torch.from_numpy(ids)
    tokens, text, pooled = _inputs()
    scales = np.array([-2.0, 0.0, 2.0], np.float32)
    want = np.asarray(jsample(params, jlp, jnp.asarray(scales), tokens, text, pooled, jnp.float32(4.0)))
    got = tgf.sample_packed_flow(port, 1, tsched, *(torch.from_numpy(a) for a in (tokens, text, pooled)), tids,
                                 guidance=4.0, overlay=tlora.LoRAOverlay(port, tsites, tlp),
                                 row_scale=torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), want, atol=LATENT_TOL, rtol=0)
    assert np.abs(want[0] - want[2]).max() > 1e-2  # the slider bites


def test_indexed_stack_matches_jax_and_solo(assets):
    model, params, port = random_flux()
    files = [assets["slider"], assets["other"]]
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jstack_sites, jstacked = jlora.stack_adapters([(jsites, jlora.load_weights(f, jsites)) for f in files])
    tentries = [(tsites, tlora.load_weights(f, tsites)) for f in files]
    tstack_sites, tstacked = tlora.stack_adapters(tentries)
    sched_j = jflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(3, mu=0.7)
    sched_t = tflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(3, mu=0.7)
    ids = jflux.prepare_latent_image_ids(4, 4)
    apply = lambda p, *a, **kw: model.apply({"params": p}, *a, **kw)  # noqa: E731
    jsample = jgf.make_packed_overlay_sampler(apply, tuple(jstack_sites), sched_j, 1, jnp.asarray(ids), False,
                                              indexed=True)
    tids = torch.from_numpy(ids)
    tokens, text, pooled = _inputs()
    scales, idx = np.array([1.5, -1.0, 2.0], np.float32), np.array([0, 1, 1], np.int32)
    want = np.asarray(jsample(params, jstacked, jnp.asarray(scales), jnp.asarray(idx), tokens, text, pooled,
                              jnp.float32(0.0)))
    targs = [torch.from_numpy(a) for a in (tokens, text, pooled)]
    got = tgf.sample_packed_flow(port, 1, sched_t, *targs, tids,
                                 overlay=tlora.LoRAOverlay(port, tstack_sites, tstacked),
                                 row_scale=torch.from_numpy(scales), adapter_idx=torch.from_numpy(idx).long())
    np.testing.assert_allclose(got.numpy(), want, atol=LATENT_TOL, rtol=0)
    for row, (s, i) in enumerate(zip(scales, idx)):
        solo = tgf.sample_packed_flow(port, 1, sched_t, *(a[row:row + 1] for a in targs), tids,
                                      overlay=tlora.LoRAOverlay(port, *tentries[i]), row_scale=torch.tensor([s]))
        np.testing.assert_allclose(solo.numpy(), got[row:row + 1].numpy(), atol=1e-5, rtol=0)


def _fp32(monkeypatch):
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jserve, "jnp", proxy)
    monkeypatch.setattr(tserve.SliderService, "weight_dtype", torch.float32)


def _jax_latents(seeds, res=32):
    return torch.cat([torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(s), (1, 4, res, res),
                                                                  jnp.float32))) for s in seeds])


@pytest.fixture
def min_elems_1(monkeypatch):
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    for name in ("quantize_host_tree", "quantize_init", "quantize_params"):
        monkeypatch.setattr(jquant, name, functools.partial(getattr(jquant, name), min_elems=1))


@pytest.mark.parametrize("kind,mode", [("transformer", None), ("te", None), ("transformer", "quantize_base"),
                                       ("transformer", "w8a8")])
def test_service_group_matches_jax(assets, monkeypatch, min_elems_1, kind, mode):
    _fp32(monkeypatch)
    path = assets["slider"] if kind == "transformer" else assets["te"]
    kw = dict(image_size=64, steps=3, start_noise=900, **({mode: True} if mode else {}))
    jsvc = jserve.FluxSliderService(assets["base"], path, microbatch=False, **kw)
    tsvc = tserve.FluxSliderService(assets["base"], path, device="cpu", **kw)
    try:
        assert tsvc.flip == jsvc.flip == 1
        if mode:
            assert load_jax_params(tsvc.unet, to_numpy_tree(jsvc.transformer.params)) == []
            assert {m.act_quant for m in tsvc.unet.modules() if isinstance(m, tquant.QuantLinear)} == {mode == "w8a8"}
        monkeypatch.setattr(tsvc, "_draw_latents", _jax_latents)
        padded = [("a photo of a person", 1.5, 7, 3.5, "default"), ("a red car", -2.0, 9, 3.5, "default")]
        want = np.stack([np.asarray(w) for w in jsvc._sample_group(padded, 3.5, jsvc._resolve("default"))])
        got = np.stack(tsvc._sample_group(padded, 3.5, tsvc._resolve("default")))
        assert got.shape == (2, 64, 64, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        bound = SERVE_PIXEL[mode] if mode else (1, 1.0)
        print(f"{kind}/{mode}: pixel gap max {diff.max()}, mean {diff.mean():.3f}")
        assert diff.max() <= bound[0] and diff.mean() <= bound[1]
        base = tsvc._sample_group([(r[0], 0.0) + r[2:] for r in padded], 3.5, tsvc._resolve("default"))
        assert any(not np.array_equal(a, b) for a, b in zip(base, got))  # the slider bites
    finally:
        tsvc.close()


def test_service_end_to_end_and_settings(assets):
    svc = tserve.FluxSliderService(assets["base"], assets["slider"], image_size=64, steps=3, start_noise=1000,
                                   device="cpu", batch_window_ms=300.0)
    calls = []
    real = svc._sample_group
    svc._sample_group = lambda *a, **k: calls.append(k.get("adapter_idx")) or real(*a, **k)
    try:
        svc.add_slider("other", assets["other"])
        reqs = [("a cat", 1.5, 3, 3.5, "default"), ("a cat", -1.0, 4, 3.5, "other")]
        together = svc._generate_batch(reqs)
        assert len(calls) == 1 and calls[0] is not None  # one stacked call
        solo = [svc._generate_batch([r])[0] for r in reqs]
        for a, b in zip(together, solo):
            assert np.abs(decode_png(a).astype(int) - decode_png(b).astype(int)).max() <= 1
        imgs = {s: decode_png(svc.generate("a photo of a person", s, 3, 3.5)) for s in (0.0, 2.0)}
        assert imgs[0.0].shape == (64, 64, 3) and not np.array_equal(imgs[0.0], imgs[2.0])
        server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/generate?prompt=a+cat&scale=1&seed=2"
            with urllib.request.urlopen(url, timeout=120) as resp:
                assert resp.status == 200 and decode_png(resp.read()).shape == (64, 64, 3)
        finally:
            server.shutdown()
            server.server_close()
    finally:
        svc.close()
    cls, kwargs = tserve.service_settings(tserve.build_parser().parse_args(
        ["--slider", "s", "--base", "black-forest-labs/FLUX.1-schnell", "--w8a8"]))
    assert cls is tserve.FluxSliderService
    assert (kwargs["steps"], kwargs["start_noise"], kwargs["w8a8"]) == (8, 800, True)
    with pytest.raises(SystemExit):
        tserve.service_settings(tserve.build_parser().parse_args(
            ["--slider", "s", "--family", "flux", "--static_guidance", "1"]))


def test_latent_preview_without_vae(assets):
    svc = tserve.FluxSliderService("tiny-flux", assets["slider"], image_size=64, steps=2, device="cpu")
    try:
        assert svc.vae is None
        img = decode_png(svc.generate("a cat", 1.0, 3, 3.5))
        assert img.shape == (32, 32, 3) and img.max() == 255 and img.min() == 0
    finally:
        svc.close()


@pytest.mark.parametrize("quantize", [False, True])
def test_sweep_cli_matches_jax(assets, tmp_path, monkeypatch, quantize):
    import csv

    with open(tmp_path / "prompts.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerow([0, "a photo of a person", 42])
        w.writerow([3, "a red car", 7])  # outside --till_case 2
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jgen_cli, "jnp", proxy)
    monkeypatch.setattr(tgen_cli, "WEIGHT_DTYPE", torch.float32)
    monkeypatch.setattr(tgen_cli, "draw_latents", lambda seed, shape, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(int(seed)), tuple(shape), jnp.float32))))

    def argv(out):
        return ["--model_name", assets["slider"], "--prompts_path", str(tmp_path / "prompts.csv"), "--save_path",
                str(out), "--base", assets["base"], "--image_size", "64", "--steps", "3", "--scales=-1,1",
                "--till_case", "2", "--start_noise", "700"] + (["--quantize_base"] if quantize else [])

    jgen_cli.run(jgen_cli.build_parser().parse_args(argv(tmp_path / "jax")))
    tgen_cli.main(argv(tmp_path / "port") + ["--device", "cpu"])
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert names == [f"{SLIDER}/-1.0/0_0.png", f"{SLIDER}/1.0/0_0.png"]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name
    a, b = (np.asarray(Image.open(tmp_path / "port" / n)) for n in names)
    assert not np.array_equal(a, b)
