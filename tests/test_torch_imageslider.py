"""The port's image-pair ("visual") slider slice against the JAX package's.

* ``io/png.py``: every PNG row filter (0-4) decodes to the raw pixels, the
  alpha colour types load as PIL's ``convert("RGB")`` does, and palette,
  16-bit and interlaced files raise;
* ``load_image_array`` gives the JAX loader's array for a PNG, at the
  training resolution and resized, and refuses JPEG/WebP;
* ``build_image_bank`` over a folder of PNGs written here, through the tiny
  VAE on the same weights: the same pair table and moments (≤ 2e-4);
* the slice as a whole: three tiny-xl image-pair steps (fp32, Euler-A) from
  the same UNet weights, LoRA factors, bank and random draws — the port's
  draws derived from the JAX key as ``imageslider.py`` derives them — against
  ``make_image_slider_step(student_overlay=True)``: loss, both halves and
  every factor within 2e-4;
* ``cli/train_lora_scale`` on tiny-xl on the CPU through ``main``: the saved
  key set is the JAX trainer's, a resumed run ends bit-identical; the
  refusals.
"""

import io
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.models import vae as jvae
from sliders_conceptmod_tpu.train import imageslider as jimage
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import train_lora_scale as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.png import decode_png, encode_png
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.models import vae as tvae
from sliders_conceptmod_tpu_torch.train import imageslider as timage
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 2e-4
MAX_STEPS, SEQ, CTX = 4, 11, 32


# ---------------------------------------------------------------------------
# PNG and image loading
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """A PNG of ``img`` (uint8 [H, W, C], C 1..4) whose row y uses filter
    ``kinds[y % len(kinds)]``, filtered here by the spec's forward rules."""
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = {0: 0 * cur, 1: left, 2: up, 3: (left + up) // 2,
                4: np.array([_paeth(a, b, d) for a, b, d in zip(left, up, upleft)])}[kind]
        out += bytes([kind]) + bytes(((cur - pred) % 256).astype(np.uint8))

    def chunk(tag, payload):
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filters_decode_to_the_raw_pixels(kind, channels):
    rng = np.random.default_rng(kind * 10 + channels)
    img = rng.integers(0, 256, (9, 13, channels)).astype(np.uint8)
    img[3:6] = img[2]  # repeated rows and smooth runs, where Up/Paeth predict well
    got = decode_png(_filtered_png(img, [kind, (kind + 1) % 5, kind]))
    np.testing.assert_array_equal(got, img[:, :, 0] if channels == 1 else img)


def test_png_written_by_pil_and_unsupported_kinds():
    yy, xx = np.mgrid[0:40, 0:56]
    img = np.stack([xx * 4 % 256, yy * 6 % 256, (xx + yy) * 3 % 256], -1).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L", "LA"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, format="PNG")
        np.testing.assert_array_equal(decode_png(buf.getvalue()), np.asarray(Image.open(buf)))
    # palette and 16-bit files, refused before the decoder took every PNG kind
    # (tests/test_torch_image_decode.py), decode as Pillow converts them to RGB
    for mode in ("P", "I;16"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, format="PNG")
        got = decode_png(buf.getvalue())
        got = np.repeat(got[:, :, None], 3, axis=2) if got.ndim == 2 else got
        np.testing.assert_array_equal(got, np.asarray(Image.open(buf).convert("RGB")))
    # a kind the spec does not define still raises: the IHDR's bit depth set to 3
    data = bytearray(encode_png(img))
    data[24] = 3
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="bit depth 3"):
        decode_png(bytes(data))


def test_load_image_array_matches_the_jax_loader(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L", "LA"):
        path = str(tmp_path / f"im_{mode}.png")
        Image.fromarray(img).convert(mode).save(path)
        np.testing.assert_array_equal(timage.load_image_array(path, 16), jimage.load_image_array(path, 16))
    # resizing follows the JAX loader's PIL resize since it was ported (tests/test_torch_image_resize.py)
    np.testing.assert_array_equal(timage.load_image_array(str(tmp_path / "im_RGB.png"), 32),
                                  jimage.load_image_array(str(tmp_path / "im_RGB.png"), 32))
    # JPEG, refused before io/jpeg.py, loads as the JAX loader's PIL call does
    Image.fromarray(img[:, :, :3]).save(tmp_path / "im.jpg")
    np.testing.assert_array_equal(timage.load_image_array(str(tmp_path / "im.jpg"), 16),
                                  jimage.load_image_array(str(tmp_path / "im.jpg"), 16))


# ---------------------------------------------------------------------------
# the image bank
# ---------------------------------------------------------------------------


def _write_folders(root, folders, names, size, seed):
    rng = np.random.default_rng(seed)
    for f in folders:
        os.makedirs(os.path.join(root, f), exist_ok=True)
        for n in names:
            with open(os.path.join(root, f, n), "wb") as fh:
                fh.write(encode_png(rng.integers(0, 256, (size, size, 3)).astype(np.uint8)))


def test_image_bank_matches_jax(tmp_path):
    folders, scales = ["m2", "m1", "p1", "p2"], [-2.0, -1.0, 1.0, 2.0]
    _write_folders(str(tmp_path), folders, ["b.png", "a.png", "c.png"], 16, seed=2)
    model = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
                          model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"])
    want = jimage.build_image_bank(str(tmp_path), folders, scales,
                                   lambda x: model.apply({"params": params}, x, method=model.encode), 16)
    port = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    got = timage.build_image_bank(str(tmp_path), folders, scales, port.eval().encode, 16)
    assert timage.list_paired_images(str(tmp_path), folders) == ["a.png", "b.png", "c.png"]
    assert got.pair_table == [tuple(r) for r in np.asarray(want.pair_table).tolist()] == [(1, 2), (0, 3)]
    assert got.pair_scales == np.asarray(want.pair_scales).tolist() == [1.0, 2.0]
    assert tuple(got.mean.shape) == np.asarray(want.mean).shape == (4, 3, 4, 8, 8)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=STEP_TOL, rtol=0)
    np.testing.assert_allclose(got.logvar.numpy(), np.asarray(want.logvar), atol=STEP_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the slice: image-pair steps, port vs JAX
# ---------------------------------------------------------------------------


def _jax_draws(key, bank):
    """The port's Draws from the JAX step key, exactly as the JAX step draws."""
    ks = jax.random.split(key, 6)
    n_pairs, n_imgs = bank.pair_table.shape[0], bank.mean.shape[1]
    pair = int(jax.random.randint(ks[0], (), 0, n_pairs))
    image = int(jax.random.randint(ks[1], (), 0, n_imgs))
    t_to = int(jax.random.randint(ks[2], (), 1, MAX_STEPS - 1))
    shape = bank.mean.shape[2:]
    post = np.array(jax.random.normal(ks[3], shape, bank.mean.dtype))
    noise = np.array(jax.random.normal(ks[4], (1,) + shape, bank.mean.dtype))
    return timage.Draws(pair, image, t_to, torch.from_numpy(post), torch.from_numpy(noise))


def test_image_pair_steps_match_jax():
    image_pair_steps_match_jax(student_overlay=True)


def image_pair_steps_match_jax(student_overlay, seeds=(21, 22, 23), optimizer_args=""):
    """Steps of the port and of the JAX package from the same state, with the
    2-row overlay student or the two merged ±s students; ``optimizer_args``
    go to both packages' AdamW."""
    cfg = junet.UNetConfig.tiny_xl()
    model = junet.UNet2DConditionModel(cfg)
    added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
                        jnp.zeros((1, SEQ, CTX)), added_cond_kwargs=added)["params"]
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    port = port.eval().requires_grad_(False)

    jsites = jlora.create_sites(params, rank=2, alpha=1.0, train_method="full")
    jlp = jlora.init_lora_params(jax.random.PRNGKey(1), jsites)
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, train_method="full")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)

    emb = {r: 0.5 * rng.standard_normal((SEQ, CTX)).astype(np.float32) for r in ("positive", "neutral", "uncond")}
    pooled = {r: 0.5 * rng.standard_normal((32,)).astype(np.float32) for r in ("positive", "neutral", "uncond")}
    mean = rng.standard_normal((4, 3, 4, 8, 8)).astype(np.float32)
    logvar = (0.3 * rng.standard_normal((4, 3, 4, 8, 8)) - 1.0).astype(np.float32)
    table, pscales = [(1, 2), (0, 3)], [1.0, 2.0]
    jbank = jimage.ImageBank(jnp.asarray(mean), jnp.asarray(logvar), jnp.asarray(table, jnp.int32),
                             jnp.asarray(pscales, jnp.float32))
    tbank = timage.ImageBank(torch.from_numpy(mean), torch.from_numpy(logvar), table, pscales)
    add = jsampling.get_add_time_ids(64, 64)

    def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
        return model.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

    jsched = jscheduler("euler_a")
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10), optimizer_args)
    icfg = dict(max_denoising_steps=MAX_STEPS, scaling_factor=0.13025)
    jstep = jimage.make_image_slider_step(
        unet_apply, jsites, jsched, jsched.set_timesteps(MAX_STEPS), jopt, jimage.ImageSliderConfig(**icfg),
        positive_emb=jnp.asarray(emb["positive"]), neutral_emb=jnp.asarray(emb["neutral"]),
        uncond_emb=jnp.asarray(emb["uncond"]), pooled={k: jnp.asarray(v) for k, v in pooled.items()},
        add_time_ids=jnp.asarray(add), student_overlay=student_overlay)
    tsched = tscheduler("euler_a")
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), optimizer_args)
    tstep = timage.make_image_slider_step(
        port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt, timage.ImageSliderConfig(**icfg),
        torch.from_numpy(emb["positive"]), torch.from_numpy(emb["neutral"]),
        pooled={k: torch.from_numpy(pooled[k]) for k in ("positive", "neutral")}, add_time_ids=torch.from_numpy(add),
        student_overlay=student_overlay)
    tstate = topt.init(toptim.flat_params(tsites, tlp))

    lp = jax.tree.map(jnp.array, jlp)
    jstate = jopt.init(lp)
    before = tlora.state_dict_numpy(tsites, tlp)
    seen = set()
    for i, seed in enumerate(seeds):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, jbank)
        seen.add((draws.pair, draws.timesteps_to))
        lp, jstate, jm = jstep(params, lp, jstate, key, jbank)
        tm = tstep(tstate, tbank, draws=draws)
        for name in ("loss", "loss_high", "loss_low"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=STEP_TOL, atol=1e-7, err_msg=name)
        want = jlora.state_dict_numpy(jsites, lp)
        got = tlora.state_dict_numpy(tsites, tlp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=f"step {i}: {k}")
    assert len(seen) > 1  # the draws vary across steps
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 5e-3  # the factors moved


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _tiny_config(path, iterations=2):
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-tiny-xl.yaml"))
    cfg.prompts_file = os.path.join(REPO, cfg.prompts_file)
    cfg.save.path = str(path)
    cfg.train.iterations = iterations
    cfg.logging.verbose = False
    return cfg


def test_cli_trains_tiny_xl_on_the_cpu_and_saves_the_jax_key_set(tmp_path):
    """``main`` on tiny-xl on the CPU: 512px PNG pairs through the full SDXL
    VAE (the family's VAE, as in the JAX factory) and the tiny-xl UNet, four
    steps with a periodic save at step 2; the saved keys are the JAX
    trainer's, and a run resumed from the step-2 checkpoint ends with the
    same factors, bit for bit."""
    _write_folders(str(tmp_path / "imgs"), ["low", "high"], ["x.png", "y.png"], 512, seed=5)
    text = open(os.path.join(REPO, "data", "config-tiny-xl.yaml")).read()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{os.path.join(REPO, "data", "prompts-tiny.yaml")}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"').replace("per_steps: 200", "per_steps: 2")
    (tmp_path / "config.yaml").write_text(text.replace("verbose: true", "verbose: false"))
    argv = ["--config_file", str(tmp_path / "config.yaml"), "--alpha", "1", "--rank", "2", "--device", "cpu",
            "--folder_main", str(tmp_path / "imgs"), "--folders", "low,high", "--scales=-1,1"]
    res = tcli.main(tcli.build_parser().parse_args(argv))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses)) and res.bank_seconds > 0
    assert {r["timesteps_to"] for r in res.metrics} <= set(range(1, 3)) and {r["scale"] for r in res.metrics} == {1.0}
    out = tmp_path / "out" / "tinyxl_slider_alpha1.0_rank2_full"
    assert sorted(os.listdir(out)) == [f"tinyxl_slider_alpha1.0_rank2_full_{s}" for s in (
        "2steps.safetensors", "last.safetensors", "metrics.jsonl", "resume.pt")]
    saved = tst.load_file(str(out / "tinyxl_slider_alpha1.0_rank2_full_last.safetensors"))
    jcfg = junet.UNetConfig.tiny_xl()
    shapes = jax.eval_shape(
        lambda: junet.UNet2DConditionModel(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)),
            added_cond_kwargs={"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))})["params"])
    jsites = jlora.create_sites(shapes, rank=2, alpha=1.0, train_method="full")
    assert set(saved) == {f"{s.lora_name}.{k}" for s in jsites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    assert all(v.abs().max() > 0 for k, v in saved.items() if k.endswith("lora_up.weight"))

    os.replace(out, tmp_path / "first")
    resumed = tcli.main(tcli.build_parser().parse_args(argv + ["--resume_from", str(tmp_path / "first")]))
    assert resumed.losses == res.losses[3:]
    again = tst.load_file(str(out / "tinyxl_slider_alpha1.0_rank2_full_last.safetensors"))
    for k, v in saved.items():
        assert torch.equal(again[k], v), k


def test_cli_refusals_and_parser(tmp_path):
    prompts = tprompts.load_prompts_from_yaml(os.path.join(REPO, "data", "prompts-tiny.yaml"))
    for knob, value, match in (("quantize_base", True, "quantize_base"), ("w8a8_warmup", True, "w8a8"),
                               ("overlay_warmup", True, "warm-up")):
        cfg = _tiny_config(tmp_path)
        setattr(cfg.tpu, knob, value)
        with pytest.raises(NotImplementedError, match=match):
            tcli.train(cfg, prompts, str(tmp_path), ["a", "b"], [-1.0, 1.0], device="cpu")
    # the JAX CLI's route rule: the overlay student unless tpu.student_overlay is false,
    # which selects the merged ±scale students; an overlay warm-up without it raises
    cfg = _tiny_config(tmp_path)
    assert tcli.resolve_student(cfg) is True
    cfg.tpu.student_overlay = False
    assert tcli.resolve_student(cfg) is False
    cfg.tpu.overlay_warmup = True
    with pytest.raises(ValueError, match="requires tpu.student_overlay"):
        tcli.train(cfg, prompts, str(tmp_path), ["a", "b"], [-1.0, 1.0], device="cpu")
    # the SD1/SD2 branch trains since the SD slice (tests/test_torch_sd_imageslider.py);
    # a path on disk loads when it is a diffusers directory or a checkpoint
    # file (tests/test_torch_loaders.py), and any other path raises
    cfg = _tiny_config(tmp_path)
    cfg.pretrained_model.name_or_path = str(tmp_path)
    with pytest.raises(ValueError, match="neither a diffusers directory"):
        tcli.train(cfg, prompts, str(tmp_path), ["a", "b"], [-1.0, 1.0], device="cpu")
    with pytest.raises(ValueError, match="index-matched"):
        tcli.train(_tiny_config(tmp_path), prompts, str(tmp_path), ["a", "b"], [-1.0], device="cpu")
    # a value that starts with "-" is given with "=", as argparse needs
    args = tcli.build_parser().parse_args(["--config_file", "c.yaml", "--folder_main", "f", "--folders", "a,b",
                                           "--scales=-1,1"])
    assert (args.device, args.rank, args.alpha, args.stylecheck, args.resume_from) == ("cuda", 4, 1.0, None, None)
    assert args.scales == "-1,1"
