"""SD1.x/SD2.x serving in the port against the JAX package, on the CPU.

* ``SD1SliderService`` on the tiny family, one sampler call of a padded
  two-row group (two seeds, scales +1.5 and -2, CFG 7.5), against JAX
  ``SD1SliderService._sample_group`` with the same weights (moved by
  ``io/jax_params.py``), slider file and initial latents (the port's draw
  patched to JAX's ``normal(PRNGKey(seed))``), with and without
  ``v2``/``v_pred``: both services at fp32 (the port's ``weight_dtype``; the
  JAX module sees ``jnp.bfloat16`` as ``float32``) and both decodes patched
  out, so the sampled latents are compared, within 2e-4;
* the service end to end on the CPU: PNG bytes, the slider changing the
  image, the micro-batcher and the HTTP handler;
* ``detect_family`` against JAX's on a table of names, and ``main``'s
  ``--family`` handling (defaults by family, SD3's 28 steps, Flux's 8)."""

import json
import threading
import types
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu import serve as jserve
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CONV = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV
SLIDER = "slider_full_rank2_alpha1.safetensors"


@pytest.fixture(scope="module")
def slider(tmp_path_factory):
    _, _, junet, _ = jfactory.load_models("tiny")
    sites = jlora.create_sites(junet.params, rank=2, alpha=1.0, target_replace=CONV, train_method="full")
    rng = np.random.default_rng(5)
    lp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(5), sites))
    path = tmp_path_factory.mktemp("sd_serve") / SLIDER
    jlora.save_weights(str(path), sites, lp)
    return str(path)


def _tiny_vae(monkeypatch):
    """Both services' VAE is the tiny one (the sampler comparison never decodes)."""
    jvae = jfactory.VAEBundle(jfactory.AutoencoderKL(jfactory.VAEConfig.tiny()), {}, jfactory.VAEConfig.tiny())
    monkeypatch.setattr(jfactory, "_load_or_init_vae", lambda *a, **k: jvae)
    monkeypatch.setattr(tfactory, "_vae", lambda name, cfg, device, dtype, seed: tfactory.build_module(
        lambda: AutoencoderKL(VAEConfig.tiny()), device, dtype, seed))


@pytest.mark.parametrize("v2,v_pred", [(False, False), (True, True)], ids=["sd1_eps", "sd2_vpred"])
def test_sampler_call_matches_jax(slider, monkeypatch, v2, v_pred):
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jserve, "jnp", proxy)
    monkeypatch.setattr(tserve.SliderService, "weight_dtype", torch.float32)
    _tiny_vae(monkeypatch)
    identity = lambda decode, latents, scaling: np.asarray(latents)  # noqa: E731 — the sampled latents
    monkeypatch.setattr(jserve, "latents_to_images", identity)
    monkeypatch.setattr(tserve, "latents_to_images", lambda decode, latents, scaling: latents.numpy())
    kw = dict(image_size=64, steps=3, start_noise=500, v2=v2, v_pred=v_pred)
    jsvc = jserve.SD1SliderService("tiny", slider, microbatch=False, **kw)
    tsvc = tserve.SD1SliderService("tiny", slider, device="cpu", **kw)
    try:
        assert load_jax_params(tsvc.unet, to_numpy_tree(jsvc.unet.params)) == []
        assert load_jax_params(tsvc.text_encoders[0].model, to_numpy_tree(jsvc.text_encoders[0].params)) == []
        assert tsvc.scheduler.prediction_type == jsvc.scheduler.prediction_type
        assert tsvc.flip == jsvc.flip == 1  # timesteps 666, 333, 0: the slider from step 1
        monkeypatch.setattr(tsvc, "_initial_latents", lambda gens: torch.cat([
            torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(s), (1, 4, 8, 8), jnp.float32)))
            for s in (7, 9)]))
        padded = [("a photo of a person", 1.5, 7, 7.5, "default"), ("a red car", -2.0, 9, 7.5, "default")]
        want = jsvc._sample_group(padded, 7.5, jsvc._resolve("default"))
        got = tsvc._sample_group(padded, 7.5, tsvc._resolve("default"))
        assert got.dtype == np.float32 and got.shape == (2, 4, 8, 8)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    finally:
        tsvc.close()


def test_service_end_to_end(slider, monkeypatch):
    _tiny_vae(monkeypatch)
    svc = tserve.SD1SliderService("tiny", slider, image_size=64, steps=3, device="cpu", batch_window_ms=200.0)
    try:
        imgs = {s: decode_png(svc.generate("a photo of a person", s, 3, 7.5)) for s in (0.0, 2.0)}
        assert imgs[0.0].shape == (16, 16, 3)  # the tiny VAE upsamples 8 latents twice
        assert not np.array_equal(imgs[0.0], imgs[2.0])
        again = decode_png(svc.generate("a photo of a person", 2.0, 3, 7.5))
        np.testing.assert_array_equal(again, imgs[2.0])  # a seed reproduces its image
        out, threads = {}, []
        for s in (-2.0, 1.0):
            threads.append(threading.Thread(target=lambda s=s: out.update({s: svc.generate("a cat", s, 4, 7.5)})))
        calls = svc._batcher.total_batches
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert len(out) == 2 and svc._batcher.total_batches - calls == 1  # one micro-batch
        server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            with urllib.request.urlopen(f"{base}/generate?prompt=a+cat&scale=1&seed=2", timeout=120) as resp:
                assert resp.status == 200 and decode_png(resp.read()).shape == (16, 16, 3)
            health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
            assert health["status"] == "ok" and health["sliders"] == ["default"]
        finally:
            server.shutdown()
            server.server_close()
    finally:
        svc.close()


NAMES = ["stabilityai/stable-diffusion-xl-base-1.0", "runwayml/stable-diffusion-v1-5", "CompVis/stable-diffusion-v1-4",
         "stabilityai/stable-diffusion-2-1", "/ckpt/sd21-v2-1_768-ema.safetensors", "/models/SD1.5/dir",
         "stabilityai/stable-diffusion-3-medium", "black-forest-labs/FLUX.1-schnell", "tiny-xl", "tiny",
         "/weights/sd2-base", "my-model"]


def test_detect_family_matches_jax():
    assert [tserve.detect_family(n) for n in NAMES] == [jserve.detect_family(n) for n in NAMES]


def test_main_family_handling():
    parse = lambda *a: tserve.build_parser().parse_args(["--slider", "s.safetensors", *a])  # noqa: E731
    cls, kw = tserve.service_settings(parse())
    assert cls is tserve.SliderService and kw["steps"] == 25 and kw["start_noise"] == 750
    cls, kw = tserve.service_settings(parse("--base", "runwayml/stable-diffusion-v1-5"))
    assert cls is tserve.SD1SliderService and kw["steps"] == 50 and kw["start_noise"] == 750
    assert not kw["v2"] and not kw["v_pred"]
    cls, kw = tserve.service_settings(parse("--base", "my-dir", "--family", "sd1", "--v2", "--v_pred", "--steps", "10",
                                            "--start_noise", "600"))
    assert cls is tserve.SD1SliderService and kw["v2"] and kw["v_pred"] and kw["steps"] == 10
    assert kw["start_noise"] == 600
    cls, _ = tserve.service_settings(parse("--base", "runwayml/stable-diffusion-v1-5", "--family", "xl"))
    assert cls is tserve.SliderService  # --family wins over the name
    cls, kw = tserve.service_settings(parse("--base", "stabilityai/stable-diffusion-3-medium"))
    assert cls is tserve.SD3SliderService and kw["steps"] == 28 and kw["start_noise"] == 750
    for base, fam in (("black-forest-labs/FLUX.1-schnell", None), ("x", "flux")):  # Flux serves since its slice
        cls, kw = tserve.service_settings(parse("--base", base, *(("--family", fam) if fam else ())))
        assert cls is tserve.FluxSliderService and kw["steps"] == 8 and kw["start_noise"] == 800
    with pytest.raises(SystemExit):
        parse("--family", "cascade")
