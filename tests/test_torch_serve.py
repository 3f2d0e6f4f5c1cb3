"""The ported serving slice as a whole, on tiny-xl on the CPU.

* ``sample_loop_scales`` + ``latents_to_images`` in both packages with the
  same weights (moved by io/jax_params.py), latents, embeddings and slider,
  3 DDIM steps, fp32;
* the port's ``SliderService("tiny-xl", device="cpu")``: micro-batching, seed
  reproducibility, the slider scale changing the image, the HTTP handler;
* ``MicroBatcher`` and the PNG codec on their own."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.infer import generate as jgen
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion import schedulers as tsched
from sliders_conceptmod_tpu_torch.infer import generate as tgen
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.png import decode_png, encode_png
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.models import vae as tvae
from sliders_conceptmod_tpu_torch.serve import MicroBatcher, QueueFullError, SliderService, make_handler
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CONV = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV


def test_sampler_and_decode_match_jax():
    _, _, junet_b, jsched, jvae_b = jfactory.load_models_xl("tiny-xl", scheduler_name="ddim", with_vae=True)
    unet = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    vae = tvae.AutoencoderKL(tvae.VAEConfig.sdxl())  # the JAX tiny-xl family decodes with it too
    assert load_jax_params(unet, to_numpy_tree(junet_b.params)) == []
    assert load_jax_params(vae, to_numpy_tree(jvae_b.params)) == []  # the whole tree, encoder included
    unet.eval(), vae.eval()

    jsites = jlora.create_sites(junet_b.params, rank=4, alpha=1.0, target_replace=CONV, train_method="noxattn")
    rng = np.random.default_rng(0)
    jlp = jax.tree.map(
        lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
        jlora.init_lora_params(jax.random.PRNGKey(0), jsites),
    )
    tsites = tlora.create_sites(unet, rank=4, alpha=1.0, target_replace=CONV, train_method="noxattn")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)

    scales = np.asarray([0.0, 1.5, -2.0], np.float32)
    latents = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    emb = rng.standard_normal((6, 77, 32)).astype(np.float32)
    added = {
        "text_embeds": rng.standard_normal((6, 32)).astype(np.float32),
        "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (6, 1)),
    }
    jschedule = jsched.set_timesteps(3)
    want = jgen.sample_loop_scales(
        junet_b.apply_fn(), junet_b.params, jsites, jlp, jnp.asarray(scales), 1, jsched, jschedule,
        jnp.asarray(latents), jnp.asarray(emb), jax.random.PRNGKey(0), guidance_scale=7.5,
        added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()},
    )
    tsch = tsched.create_noise_scheduler("ddim")
    got = tgen.sample_loop_scales(
        unet, tsites, tlp, scales, 1, tsch, tsch.set_timesteps(3), torch.from_numpy(latents),
        torch.from_numpy(emb), guidance_scale=7.5, added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)
    assert np.abs(np.asarray(want)[1] - np.asarray(want)[0]).max() > 1e-2  # the slider bites

    want_img = jgen.latents_to_images(jvae_b.decode, want, jvae_b.config.scaling_factor)
    got_img = tgen.latents_to_images(vae.decode, got, vae.config.scaling_factor)
    assert got_img.dtype == np.uint8 and got_img.shape == want_img.shape
    diff = np.abs(got_img.astype(int) - want_img.astype(int))
    assert diff.max() <= 1 or (diff <= 1).mean() >= 0.999, (diff.max(), (diff <= 1).mean())


def test_stochastic_sampler_with_rescale_matches_jax():
    """euler_a with per-row keys in JAX; the port gets the same per-step draws
    injected (``step_noise``) and rescales CFG the same way."""
    _, _, junet_b, _ = jfactory.load_models_xl("tiny-xl", scheduler_name="euler_a")
    unet = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    load_jax_params(unet, to_numpy_tree(junet_b.params))
    unet.eval()
    jsites = jlora.create_sites(junet_b.params, rank=2, alpha=1.0, train_method="full")
    rng = np.random.default_rng(1)
    jlp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                       jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    tsites = tlora.create_sites(unet, rank=2, alpha=1.0, train_method="full")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jcreate

    jsched, tsch = jcreate("euler_a"), tsched.create_noise_scheduler("euler_a")
    n = 3
    jschedule, tschedule = jsched.set_timesteps(n), tsch.set_timesteps(n)
    latents = (rng.standard_normal((2, 4, 8, 8)) * tschedule.init_noise_sigma).astype(np.float32)
    emb = rng.standard_normal((4, 77, 32)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((4, 32)).astype(np.float32),
             "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (4, 1))}
    keys = jnp.stack([jax.random.PRNGKey(7), jax.random.PRNGKey(9)])
    want = jgen.sample_loop_scales(
        junet_b.apply_fn(), junet_b.params, jsites, jlp, jnp.asarray([1.0, -2.0]), 1, jsched, jschedule,
        jnp.asarray(latents), jnp.asarray(emb), keys, guidance_scale=7.5, guidance_rescale=0.7,
        added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()},
    )
    # the JAX sampler's per-row draw at step i: normal(fold_in(row key, i))
    noise = np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, i), (4, 8, 8), jnp.float32)) for k in keys])
        for i in range(n)
    ])
    got = tgen.sample_loop_scales(
        unet, tsites, tlp, [1.0, -2.0], 1, tsch, tschedule, torch.from_numpy(latents), torch.from_numpy(emb),
        guidance_scale=7.5, guidance_rescale=0.7, step_noise=torch.from_numpy(noise),
        added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


def test_sampling_helpers_match_jax():
    from sliders_conceptmod_tpu.diffusion import sampling as jsampling
    from sliders_conceptmod_tpu_torch.diffusion import sampling as tsampling

    for crops in (False, True):
        np.testing.assert_array_equal(
            tsampling.get_add_time_ids(1024, 768, crops, np.random.default_rng(3)),
            jsampling.get_add_time_ids(1024, 768, crops, np.random.default_rng(3)),
        )
    rng = np.random.default_rng(4)
    cfg, text = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tsampling.rescale_noise_cfg(torch.from_numpy(cfg), torch.from_numpy(text), 0.7).numpy(),
        np.asarray(jsampling.rescale_noise_cfg(jnp.asarray(cfg), jnp.asarray(text), 0.7)),
        rtol=1e-5, atol=1e-6,
    )
    sched = tsched.create_noise_scheduler("ddim").set_timesteps(25)
    jsched = jfactory.create_noise_scheduler("ddim").set_timesteps(25)
    for start in (-1, 0, 500, 750, 999, 1100):
        assert tgen.flip_step_for_start_noise(sched, start) == jgen.flip_step_for_start_noise(jsched, start)


def test_cond_only_path_for_python_guidance_at_most_one():
    """A Python guidance <= 1 runs the conditional rows only; a tensor
    guidance always runs CFG (the traced-guidance semantics)."""
    torch.manual_seed(0)
    unet = tfactory.build_module(lambda: tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()), "cpu",
                                 torch.float32, seed=0)
    sch = tsched.create_noise_scheduler("ddim")
    schedule = sch.set_timesteps(2)
    lat = torch.randn(1, 4, 8, 8)
    emb = torch.randn(2, 77, 32)
    added = {"text_embeds": torch.randn(2, 32), "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2)}
    calls = []
    unet.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
    run = lambda g: tgen.sample_loop_scales(unet, [], {}, [0.0], 0, sch, schedule, lat, emb, guidance_scale=g,
                                            added_cond_kwargs=added)
    cond_only = run(1.0)
    assert calls == [1, 1]
    calls.clear()
    traced = run(torch.tensor(1.0))
    assert calls == [2, 2]
    torch.testing.assert_close(cond_only, traced, atol=1e-5, rtol=1e-5)  # u + 1·(c−u) = c


def test_concurrent_samplers_on_one_unet_match_their_solo_runs():
    """Two threads sample through two sliders' overlays on one shared UNet
    (flip step 1: a plain call, then overlaid calls). Each trajectory must
    equal its solo run: no thread's hooks may reach the other's rows."""
    unet = tfactory.build_module(lambda: tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()), "cpu",
                                 torch.float32, seed=0)
    sites = tlora.create_sites(unet, rank=2, alpha=1.0, target_replace=CONV, train_method="noxattn")
    g = torch.Generator().manual_seed(0)
    overlays = []
    for _ in range(2):
        lp = tlora.init_lora_params(sites, generator=g)
        for leaf in lp.values():
            leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.5
        overlays.append(tlora.LoRAOverlay(unet, sites, lp))
    sch = tsched.create_noise_scheduler("ddim")
    schedule = sch.set_timesteps(4)
    lat = torch.randn((2, 4, 8, 8), generator=g)
    emb = torch.randn((4, 77, 32), generator=g)
    added = {"text_embeds": torch.randn((4, 32), generator=g), "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 4)}
    jobs = [(overlays[0], [1.0, -2.0]), (overlays[1], [2.0, 0.5])]

    def run(job):
        overlay, scales = job
        return tgen.sample_loop_scales(unet, sites, None, scales, 1, sch, schedule, lat, emb, guidance_scale=7.5,
                                       added_cond_kwargs=added, overlay=overlay)

    solo = [run(job) for job in jobs]
    assert (solo[0] - solo[1]).abs().max().item() > 1e-2  # the two sliders differ
    for _ in range(3):
        out, errors = {}, []

        def client(i):
            try:
                out[i] = run(jobs[i])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors and not any(t.is_alive() for t in threads)
        for i in range(2):
            torch.testing.assert_close(out[i], solo[i], atol=1e-6, rtol=0)
    assert all(not m._forward_hooks for m in unet.modules())


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    path = tmp_path_factory.mktemp("slider") / "xl_noxattn_rank4.safetensors"
    with torch.device("meta"):
        meta = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    sites = tlora.create_sites(meta, rank=4, alpha=1.0, target_replace=CONV, train_method="noxattn")
    g = torch.Generator().manual_seed(0)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.5
    tlora.save_weights(str(path), sites, lp)
    svc = SliderService("tiny-xl", str(path), image_size=64, steps=3, device="cpu", batch_window_ms=300.0)
    svc.add_slider("extra", str(path))
    yield svc
    svc.close()


def test_service_scale_seed_and_shape(service):
    a = service.generate("a photo of a person", 0.0, 7, 7.5)
    again = service.generate("a photo of a person", 0.0, 7, 7.5)
    b = service.generate("a photo of a person", 2.0, 7, 7.5, slider="extra")
    c = service.generate("a photo of a person", 0.0, 8, 7.5)
    assert a == again  # a seed reproduces the port's image
    ia, ib, ic = map(decode_png, (a, b, c))
    assert ia.dtype == np.uint8 and ia.shape == (64, 64, 3)
    assert not np.array_equal(ia, ib)  # the slider scale changes the image
    assert not np.array_equal(ia, ic)  # and so does the seed
    with pytest.raises(KeyError):
        service.generate("x", 1.0, 0, 7.5, slider="missing")


def test_service_micro_batches_concurrent_requests(service):
    solo = {s: decode_png(service.generate("a cat", s, 11, 7.5)) for s in (-2.0, 1.0)}
    b0 = service._batcher.total_batches
    out, errors = {}, []

    def client(scale):
        try:
            out[scale] = decode_png(service.generate("a cat", scale, 11, 7.5))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in (-2.0, 1.0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert service._batcher.total_batches - b0 == 1 and service._batcher.batch_sizes[-1] == 2
    for s in (-2.0, 1.0):  # a batched row reproduces its solo image (float jitter ≤ 1 LSB)
        assert np.abs(out[s].astype(int) - solo[s]).max() <= 1


def test_http_handler(service):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        assert health["status"] == "ok" and health["sliders"] == ["default", "extra"]
        listed = json.loads(urllib.request.urlopen(f"{base}/sliders", timeout=30).read())
        assert sorted(s["name"] for s in listed["sliders"]) == ["default", "extra"]
        with urllib.request.urlopen(f"{base}/generate?prompt=a+dog&scale=1.5&seed=2", timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            assert decode_png(r.read()).shape == (64, 64, 3)
        for url, code in ((f"{base}/generate?scale=1", 400), (f"{base}/nowhere", 404),
                          (f"{base}/generate?prompt=x&slider=missing", 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(url, timeout=30)
            assert err.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_microbatcher_routes_results_and_exceptions():
    seen = []

    def run_batch(items):
        seen.append(list(items))
        return [ValueError(f"bad {x}") if x < 0 else x * 10 for x in items]

    mb = MicroBatcher(run_batch, max_batch=4, window_ms=300.0)
    try:
        out, errs = {}, {}

        def client(x):
            try:
                out[x] = mb.submit(x)
            except ValueError as e:
                errs[x] = str(e)

        threads = [threading.Thread(target=client, args=(x,)) for x in (1, 2, -3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert out == {1: 10, 2: 20} and errs == {-3: "bad -3"}
        assert len(seen) == 1 and sorted(seen[0]) == [-3, 1, 2]
    finally:
        mb.close()

    def boom(items):
        raise RuntimeError("whole batch failed")

    mb = MicroBatcher(boom, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError):
            mb.submit(1)
        assert mb.errored == 1
    finally:
        mb.close()


def test_microbatcher_sheds_when_the_queue_is_full():
    release = threading.Event()

    def slow(items):
        release.wait(30)
        return items

    mb = MicroBatcher(slow, max_batch=1, window_ms=1.0, max_queue=1)
    try:
        first = threading.Thread(target=mb.submit, args=(1,))
        first.start()
        deadline = time.time() + 10
        while mb.total_batches == 0 and time.time() < deadline:  # the worker holds item 1
            time.sleep(0.01)
        second = threading.Thread(target=mb.submit, args=(2,))
        second.start()
        while mb.queue_depth() == 0 and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(QueueFullError):
            mb.submit(3)
        assert mb.rejected == 1
        release.set()
        first.join(10)
        second.join(10)
        assert not first.is_alive() and not second.is_alive()
    finally:
        release.set()
        mb.close()


def test_png_round_trip_and_reference_decoder():
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    grey = img[:, :, 0].copy()
    np.testing.assert_array_equal(decode_png(encode_png(grey)), grey)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
