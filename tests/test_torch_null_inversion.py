"""Null-text inversion editing and the prompt-to-prompt controllers in the
port against the JAX package, on the CPU.

On the tiny SD UNet with N(0, 0.1²) weights carried over by
``io/jax_params.py`` (3 DDIM steps over 8 × 8 latents):

* ``ddim_invert`` against JAX's (fp32, ≤ 2e-4);
* ``null_optimization`` (3 inner steps) against JAX's jitted one, on the
  per-step embeddings and the final latents (≤ 1e-3), with the early stop
  out of reach (``epsilon = −1``: every inner step runs) and met at the first
  inner step of every step (``epsilon = 10``, far above any loss here): both
  far from the threshold, so no comparison hangs on a borderline loss;
* ``edit_with_slider`` at scale 1.5 with a slider file both packages read;
* the ptp helpers (``get_word_inds``, ``token_weights``,
  ``time_words_attention_alpha``) exactly, over each package's hash and BPE
  tokenizers;
* the captured maps (per module, in call order) and the reweighted outputs
  ([S] and [B, S] weights, nested contexts) against JAX's sown
  ``attn_probs`` and outputs, and the attention calls each controller keeps
  off the kernel dispatch;
* the editing entry point end to end with ``--device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jpeg_writer import write_jpeg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion import schedulers as jsched
from sliders_conceptmod_tpu.infer import null_inversion as jni
from sliders_conceptmod_tpu.infer import ptp as jptp
from sliders_conceptmod_tpu.models import tokenizer as jtok
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters.lora import module_path
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import unet_slider
from sliders_conceptmod_tpu_torch.demos import demo_image_editing
from sliders_conceptmod_tpu_torch.diffusion import schedulers as tsched
from sliders_conceptmod_tpu_torch.infer import null_inversion as tni
from sliders_conceptmod_tpu_torch.infer import ptp as tptp
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.models import tokenizer as ttok
from sliders_conceptmod_tpu_torch.models import unet as tunet

STEPS, SEQ, CTX = 3, 7, 32
TOL = dict(rtol=2e-4, atol=2e-4)
OPT_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def setup():
    """The tiny UNet in both packages, the DDIM schedules, the inputs."""
    model = junet.UNet2DConditionModel(junet.UNetConfig.tiny())
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, SEQ, CTX)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params["params"])
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    port = port.eval().requires_grad_(False)
    jschedule = jsched.create_noise_scheduler("ddim").set_timesteps(STEPS)
    tschedule = tsched.create_noise_scheduler("ddim").set_timesteps(STEPS)
    np.testing.assert_array_equal(np.asarray(jschedule.timesteps), tschedule.timesteps)
    latent0 = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    cond = rng.standard_normal((1, SEQ, CTX)).astype(np.float32)
    uncond = (0.5 * rng.standard_normal((1, SEQ, CTX))).astype(np.float32)

    def unet_apply(p, lat, t, emb):
        return model.apply({"params": p}, lat, t, emb)

    traj = jax.jit(lambda p, lat, c: jni.ddim_invert(unet_apply, p, jschedule, lat, c))(
        params, jnp.asarray(latent0), jnp.asarray(cond))
    return dict(model=model, params=params, port=port, jschedule=jschedule, tschedule=tschedule,
                latent0=latent0, cond=cond, uncond=uncond, unet_apply=unet_apply, traj=np.array(traj))


def test_ddim_steps_and_invert(setup):
    s = setup
    rng = np.random.default_rng(2)
    eps, x = rng.standard_normal((2, 1, 4, 8, 8)).astype(np.float32)
    for t, t2 in ((-333, 0), (0, 333), (333, 666), (666, 999)):
        want = jni.ddim_next_step(s["jschedule"], jnp.asarray(eps), t, t2, jnp.asarray(x))
        got = tni.ddim_next_step(s["tschedule"], torch.from_numpy(eps), t, t2, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        want = jni.ddim_prev_step(s["jschedule"], jnp.asarray(eps), t2, t, jnp.asarray(x))
        got = tni.ddim_prev_step(s["tschedule"], torch.from_numpy(eps), t2, t, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    traj = tni.ddim_invert(s["port"], s["tschedule"], torch.from_numpy(s["latent0"]), torch.from_numpy(s["cond"]))
    assert traj.shape == (STEPS + 1, 1, 4, 8, 8) and traj.dtype == torch.float32
    np.testing.assert_allclose(traj.numpy(), s["traj"], **TOL)


@pytest.mark.parametrize("epsilon,want_inner", [(-1.0, 3), (10.0, 1)], ids=["stop_out_of_reach", "stop_at_first"])
def test_null_optimization(setup, epsilon, want_inner):
    s = setup
    cfg = dict(num_inner_steps=3, epsilon=epsilon)
    fn = jax.jit(lambda p, traj, c, u: jni.null_optimization(s["unet_apply"], p, s["jschedule"], traj, c, u,
                                                             jni.NullOptConfig(**cfg)))
    want_u, want_lat = fn(s["params"], jnp.asarray(s["traj"]), jnp.asarray(s["cond"]), jnp.asarray(s["uncond"]))
    inner = []
    got_u, got_lat = tni.null_optimization(s["port"], s["tschedule"], torch.from_numpy(s["traj"]),
                                           torch.from_numpy(s["cond"]), torch.from_numpy(s["uncond"]),
                                           tni.NullOptConfig(**cfg), inner)
    assert inner == [want_inner] * STEPS
    assert got_u.shape == (STEPS, 1, SEQ, CTX) and got_u.dtype == torch.float32
    assert np.abs(got_u.numpy() - s["uncond"]).max() > 1e-3  # the embeddings moved
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **OPT_TOL)
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), **OPT_TOL)


def test_losses_stay_far_from_the_thresholds(setup):
    """Both cases above compare away from the early-stop threshold: every
    loss of the run is well above 0 (so −1 never stops it) and well below 10."""
    s = setup
    losses = []
    port, sched = s["port"], s["tschedule"]
    traj = torch.from_numpy(s["traj"])
    lat, uncond, cond = traj[-1], torch.from_numpy(s["uncond"]), torch.from_numpy(s["cond"])
    with torch.no_grad():
        for i, t in enumerate(sched.timesteps.tolist()):
            eps_c = port(lat, t, cond)
            eps_u = port(lat, t, uncond)
            prev = tni.ddim_prev_step(sched, eps_u + 7.5 * (eps_c - eps_u), t, t - 1000 // STEPS, lat)
            losses.append(float(torch.mean((prev - traj[STEPS - 1 - i]) ** 2)))
            lat = prev
    assert 1e-3 < min(losses) and max(losses) < 1.0, losses


def test_edit_with_slider(setup, tmp_path):
    s = setup
    sites = jlora.create_sites(s["params"], rank=2, alpha=1.0, train_method="noxattn",
                               target_replace=jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER
                               + jlora.UNET_TARGET_REPLACE_MODULE_CONV)
    rng = np.random.default_rng(5)
    lp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(5), sites))
    path = str(tmp_path / "slider_noxattn_rank2_alpha1.safetensors")
    jlora.save_weights(path, sites, lp)
    rng = np.random.default_rng(6)
    uncond_per_step = (0.5 * rng.standard_normal((STEPS, 1, SEQ, CTX))).astype(np.float32)
    x_t = s["traj"][-1]
    for scale, flip in ((1.5, 1),):  # the base weights for step 0, the slider after
        merged = jlora.merge_lora_params(s["params"], sites, lp, scale)
        want = jni.edit_with_slider(s["unet_apply"], s["params"], merged, flip, s["jschedule"], jnp.asarray(x_t),
                                    jnp.asarray(s["cond"]), jnp.asarray(uncond_per_step))
        tsites, tlp = unet_slider(s["port"], path, load_slider_file(path).unet)
        assert len(tsites) == len(sites)
        got = tni.edit_with_slider(s["port"], tlora.merge_lora_params(s["port"], tsites, tlp, scale), flip,
                                   s["tschedule"], torch.from_numpy(x_t), torch.from_numpy(s["cond"]),
                                   torch.from_numpy(uncond_per_step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# ptp helpers
# ---------------------------------------------------------------------------


def _tokenizers(tmp_path):
    texts = ["a photo of a smiling person", "a photo of a person with glasses", "an old man, smiling"]
    ttok.write_synthetic_bpe_files(str(tmp_path), texts, n_merges=60)
    return [(jtok.HashTokenizer(), ttok.HashTokenizer()),
            (jtok.CLIPTokenizerFiles(str(tmp_path)), ttok.CLIPTokenizerFiles(str(tmp_path)))]


def test_ptp_helpers_equal_jax(tmp_path):
    prompts = ["a photo of a person", "a photo of a smiling person", "a photo of a person with glasses"]
    for jt, tt in _tokenizers(tmp_path):
        for text, word in ((prompts[1], "smiling"), (prompts[2], "person"), (prompts[2], 3), (prompts[0], "cat"),
                           ("an old man, smiling", "man,")):
            want = jptp.get_word_inds(text, word, jt)
            got = tptp.get_word_inds(text, word, tt)
            assert got.dtype == want.dtype and got.tolist() == want.tolist()
        np.testing.assert_array_equal(tptp.token_weights(77, [2, 5], 2.5), jptp.token_weights(77, [2, 5], 2.5))
        for crs in (0.8, {"default_": 0.5, "smiling": (0.2, 0.9)}, {"glasses": 0.3}):
            want = jptp.time_words_attention_alpha(prompts, 10, dict(crs) if isinstance(crs, dict) else crs, jt)
            got = tptp.time_words_attention_alpha(prompts, 10, dict(crs) if isinstance(crs, dict) else crs, tt)
            assert got.dtype == want.dtype and got.shape == (11, 2, 77)
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# attention controllers
# ---------------------------------------------------------------------------


def _inputs(setup):
    rng = np.random.default_rng(7)
    sample = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.asarray([3.0, 777.0], np.float32)
    ctx = rng.standard_normal((2, SEQ, CTX)).astype(np.float32)
    return sample, t, ctx


def _count_dispatch(monkeypatch):
    calls = []
    real = tunet.dot_product_attention
    monkeypatch.setattr(tunet, "dot_product_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_capture_attention_maps_matches_jax(setup, monkeypatch):
    s = setup
    sample, t, ctx = _inputs(s)
    with junet.capture_attention_maps():
        want, inter = s["model"].apply({"params": s["params"]}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                                       mutable=["intermediates"])
    calls = _count_dispatch(monkeypatch)
    with tunet.capture_attention_maps() as cap:
        with torch.no_grad():
            got = s["port"](torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    n_attn = s["port"].config.attention_calls_per_forward()
    assert len(calls) == 0 and len(cap.maps) == n_attn  # every attention materialised, none dispatched
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    by_module = cap.by_module(s["port"])
    assert len(by_module) == n_attn
    for name, maps in by_module.items():
        node = inter["intermediates"]
        for key in module_path(name):
            node = node[key]
        (want_probs,) = node["attn_probs"]
        assert len(maps) == 1 and maps[0].dtype == torch.float32
        np.testing.assert_allclose(maps[0].numpy(), np.asarray(want_probs), **TOL)
    first = next(iter(by_module))
    assert first == "down_blocks.0.attentions.0.transformer_blocks.0.attn1"  # call order: the first attention first
    with torch.no_grad():
        s["port"](torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    assert len(calls) == n_attn  # outside the context: the dispatch again


@pytest.mark.parametrize("per_row", [False, True], ids=["weights_S", "weights_BxS"])
def test_reweight_cross_attention_matches_jax(setup, monkeypatch, per_row):
    s = setup
    sample, t, ctx = _inputs(s)
    w = np.ones((SEQ,), np.float32)
    w[2:4] = [3.0, 0.25]
    if per_row:  # CFG callers: ones on the uncond row
        w = np.stack([np.ones((SEQ,), np.float32), w])
    with junet.reweight_cross_attention(jnp.asarray(w)):
        want = s["model"].apply({"params": s["params"]}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    plain = s["model"].apply({"params": s["params"]}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    calls = _count_dispatch(monkeypatch)
    with tunet.reweight_cross_attention(w), torch.no_grad():
        got = s["port"](torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    assert len(calls) == s["port"].config.attention_calls_per_forward() // 2  # the self-attentions only
    assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-3  # the weights change the output
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # nested: captured maps carry the outer weights; each context restores the outer state
    with tunet.reweight_cross_attention(w):
        with tunet.capture_attention_maps() as cap, torch.no_grad():
            inner = s["port"](torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
        assert tunet._CAPTURE[0] is None and tunet._CROSS_ATTN_WEIGHTS[0] is w
        with tunet.reweight_cross_attention(None), torch.no_grad():
            unweighted = s["port"](torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
        assert tunet._CROSS_ATTN_WEIGHTS[0] is w
    assert tunet._CROSS_ATTN_WEIGHTS[0] is None
    np.testing.assert_allclose(inner.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(unweighted.numpy(), np.asarray(plain), **TOL)
    cross = [p for m, p in cap.maps if m.is_cross]
    assert len(cross) == len(cap.maps) // 2 and all(torch.allclose(p.sum(-1), torch.ones(())) for p in cross)


def test_capture_maps_flag_on_one_module(setup):
    s = setup
    sample, t, ctx = _inputs(s)
    port = s["port"]
    attn = port.down_blocks[0].attentions[0].transformer_blocks[0].attn2
    attn.capture_maps = True
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx))
        assert len(attn.attn_probs) == 1 and attn.attn_probs[0].shape == (2, 4, 64, SEQ)
        want = s["model"].apply({"params": s["params"]}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    finally:
        attn.capture_maps = False
        attn.attn_probs.clear()


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_demo_end_to_end_on_the_cpu(tmp_path):
    """tiny base, a JPEG photo, a rank-2 slider, 3 DDIM steps, scales 0 and 2."""
    from sliders_conceptmod_tpu_torch.models import factory

    _, _, unet, _ = factory.load_models("tiny", device="cpu")
    sites = tlora.create_sites(unet, rank=2, alpha=1.0, train_method="noxattn")
    gen = torch.Generator().manual_seed(3)
    lp = tlora.init_lora_params(sites, generator=gen)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=gen) * 0.3
    slider = str(tmp_path / "slider_noxattn_rank2_alpha1.safetensors")
    tlora.save_weights(slider, sites, lp)
    yy, xx = np.mgrid[0:48, 0:40]
    photo = np.stack([xx * 6, yy * 5, (xx + yy) * 3], -1).clip(0, 255).astype(np.uint8)
    (tmp_path / "photo.jpg").write_bytes(write_jpeg(photo, sampling=((2, 2), (1, 1), (1, 1))))
    out = tmp_path / "out"
    args = demo_image_editing.build_parser().parse_args(
        ["--base", "tiny", "--image", str(tmp_path / "photo.jpg"), "--prompt", "a photo of a person",
         "--slider", slider, "--scales", "0,2", "--ddim_steps", "3", "--resolution", "64",
         "--out", str(out), "--device", "cpu"])
    res = demo_image_editing.run(args, tni.NullOptConfig(num_inner_steps=2))
    assert res["flip_step"] == 1 and len(res["inner_steps"]) == 3 and all(1 <= k <= 2 for k in res["inner_steps"])
    assert set(res["seconds"]) == {"load", "invert", "null_optimization", "edit_0.0", "edit_2.0"}
    imgs = {s: decode_png((out / f"edit_scale_{s}.png").read_bytes()) for s in (0.0, 2.0)}
    assert all(img.shape == (64, 64, 3) for img in imgs.values())
    np.testing.assert_array_equal(imgs[0.0], res["images"][0.0])
    assert np.abs(imgs[0.0].astype(int) - imgs[2.0]).max() > 0  # the slider edits the image
    assert torch.isfinite(res["finals"][2.0]).all() and res["trajectory"].shape[0] == 4
    assert demo_image_editing.build_parser().parse_args(["--image", "a", "--prompt", "b", "--slider", "c"]).device \
        == "cuda"
