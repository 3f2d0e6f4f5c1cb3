"""SD3 serving, the SD3 sweep CLI and the SD3 notrigger towers in the port
against the JAX package, on the CPU, over a tiny SD3 diffusers directory
(``_sd3_assets.write_tiny_sd3_dir``: the tiny MMDiT, two tiny towers, a tiny
16-channel VAE without quant convs, ``shift_factor`` 0.0609) that both
packages load.

* ``SD3SliderService`` against JAX's ``_sample_group``: one padded two-row
  group (two seeds, scales +1.5 and -2, CFG 7), with a transformer slider,
  with a text-encoder part (the towers merged per row, the uncond row's
  included), and under ``static_guidance`` 1 (cond rows only); both services
  at fp32 (the port's ``weight_dtype``; the JAX module sees ``jnp.bfloat16``
  as ``float32``), the initial latents JAX's ``normal(PRNGKey(seed))``;
  images within 1 of 255;
* a stacked cross-slider call (two sliders in one sampler call) against
  each slider's solo call, images within 1 of 255, and the service end to
  end (PNG bytes, the scale moves the image, the HTTP handler);
* ``cli/generate_images_sd3`` against the JAX CLI over the directory (its
  VAE decodes): fp32 within 1 of 255 per pixel, the tree of files;
* ``cli/train_notrigger --model tiny-sd3``: a slider in the tiny SD3 bigG
  tower (``load_models_sd3``'s towers), the JAX trainer's key set, factor
  shapes and alphas.
"""

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
from sliders_conceptmod_tpu.adapters import slider_file as jsfile
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.cli import generate_images_sd3 as jgen_cli
from sliders_conceptmod_tpu.cli import train_notrigger as jnt_cli
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.cli import generate_images_sd3 as tgen_cli
from sliders_conceptmod_tpu_torch.cli import train_notrigger as tnt_cli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.io.png import decode_png
from _sd3_assets import random_mmdit, write_sd3_slider, write_tiny_sd3_dir
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLIDER = "sd3_slider_full_rank2_alpha1.safetensors"


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd3_serve")
    base = write_tiny_sd3_dir(root)
    _, params, _ = random_mmdit()
    slider = write_sd3_slider(root / SLIDER, params)
    other = write_sd3_slider(root / "other.safetensors", params, seed=12)
    # a text-encoder part over the CLIP-L tower (a notrigger save's keys)
    from sliders_conceptmod_tpu.models import factory as jfactory

    _, jtes, _, _ = jfactory.load_models_sd3(str(base))
    sites = jlora.create_sites(jtes[0].params, rank=2, alpha=1.0, target_replace=["CLIPAttention"],
                               prefix="lora_te1", train_method="full", name_path_prefix=jsfile.CLIP_NAME_PATH_PREFIX)
    rng = np.random.default_rng(3)
    lp = jax.tree.map(lambda a: jnp.asarray(0.5 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(3), sites))
    te = root / "te.safetensors"
    jlora.save_weights(str(te), sites, lp)
    return dict(base=str(base), slider=slider, other=other, te=str(te), root=root)


def _fp32(monkeypatch):
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jserve, "jnp", proxy)
    monkeypatch.setattr(tserve.SliderService, "weight_dtype", torch.float32)


def _jax_latents(seeds, res=8):
    return torch.cat([torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(s), (1, 16, res, res),
                                                                  jnp.float32))) for s in seeds])


@pytest.mark.parametrize("kind,static", [("transformer", None), ("te", None), ("transformer", 1.0)])
def test_sampler_call_matches_jax(assets, monkeypatch, kind, static):
    _fp32(monkeypatch)
    path = assets["slider"] if kind == "transformer" else assets["te"]
    kw = dict(image_size=64, steps=3, start_noise=900, static_guidance=static)
    jsvc = jserve.SD3SliderService(assets["base"], path, microbatch=False, **kw)
    tsvc = tserve.SD3SliderService(assets["base"], path, device="cpu", **kw)
    try:
        assert tsvc.flip == jsvc.flip == 1  # timesteps 1000, 857.1, 500: the slider from step 1
        monkeypatch.setattr(tsvc, "_draw_latents", _jax_latents)
        padded = [("a photo of a person", 1.5, 7, 7.0, "default"), ("a red car", -2.0, 9, 7.0, "default")]
        want = jsvc._sample_group(padded, 7.0, jsvc._resolve("default"))
        got = tsvc._sample_group(padded, 7.0, tsvc._resolve("default"))
        assert len(got) == 2 and got[0].shape == (16, 16, 3) and got[0].dtype == np.uint8
        for g, w in zip(got, want):
            assert np.abs(g.astype(int) - np.asarray(w).astype(int)).max() <= 1
        base = tsvc._sample_group([(r[0], 0.0) + r[2:] for r in padded], 7.0, tsvc._resolve("default"))
        assert any(not np.array_equal(a, b) for a, b in zip(base, got))  # the slider bites
    finally:
        tsvc.close()


def test_stacked_call_matches_solo_and_serves_end_to_end(assets):
    svc = tserve.SD3SliderService(assets["base"], assets["slider"], image_size=64, steps=3, start_noise=1000,
                                  device="cpu", batch_window_ms=300.0)
    calls = []
    real = svc._sample_group
    svc._sample_group = lambda *a, **k: calls.append(k.get("adapter_idx")) or real(*a, **k)
    try:
        svc.add_slider("other", assets["other"])
        reqs = [("a cat", 1.5, 3, 7.0, "default"), ("a cat", -1.0, 4, 7.0, "other")]
        together = svc._generate_batch(reqs)
        assert len(calls) == 1 and calls[0] is not None  # one stacked call
        solo = [svc._generate_batch([r])[0] for r in reqs]
        for a, b in zip(together, solo):
            assert np.abs(decode_png(a).astype(int) - decode_png(b).astype(int)).max() <= 1
        imgs = {s: decode_png(svc.generate("a photo of a person", s, 3, 7.0)) for s in (0.0, 2.0)}
        assert imgs[0.0].shape == (16, 16, 3) and not np.array_equal(imgs[0.0], imgs[2.0])
        server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/generate?prompt=a+cat&scale=1&seed=2&guidance=7"
            with urllib.request.urlopen(url, timeout=120) as resp:
                assert resp.status == 200 and decode_png(resp.read()).shape == (16, 16, 3)
        finally:
            server.shutdown()
            server.server_close()
    finally:
        svc.close()


def test_latent_preview_without_vae(assets, tmp_path):
    svc = tserve.SD3SliderService("tiny-sd3", assets["slider"], image_size=64, steps=2, device="cpu")
    try:
        assert svc.vae is None
        img = decode_png(svc.generate("a cat", 1.0, 3, 7.0))
        assert img.shape == (8, 8, 3) and img.max() == 255 and img.min() == 0
    finally:
        svc.close()


def test_sweep_cli_matches_jax(assets, tmp_path, monkeypatch):
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
                "--till_case", "2", "--start_noise", "500"]

    jgen_cli.run(jgen_cli.build_parser().parse_args(argv(tmp_path / "jax")))
    tgen_cli.main(argv(tmp_path / "port") + ["--device", "cpu"])
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert names == [f"{SLIDER}/-1.0/0_0.png", f"{SLIDER}/1.0/0_0.png"]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == want.shape == (16, 16, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name
    a, b = (np.asarray(Image.open(tmp_path / "port" / n)) for n in names)
    assert not np.array_equal(a, b)


def test_notrigger_tiny_sd3_matches_jax(tmp_path):
    def config(mod):
        cfg = mod.load_config_from_yaml(os.path.join(REPO, "data", "config-notrigger-xl.yaml"))
        cfg.train.iterations = 3
        cfg.train.lr = 1.0
        cfg.save.path = str(tmp_path)
        cfg.logging.verbose = False
        return cfg

    for clip_index in (1,):
        want = jnt_cli.train(config(jconfig), positive="smiling", negative="frowning", clip_index=clip_index,
                             peft_type="lora", rank=2, model="tiny-sd3", save_file=False)
        got = tnt_cli.train(config(tconfig), positive="smiling", negative="frowning", clip_index=clip_index,
                            peft_type="lora", rank=2, model="tiny-sd3", save_file=False, device="cpu")
        assert set(got) == set(want) and all(k.startswith(f"lora_te{clip_index + 1}_") for k in got)
        for k in want:  # the factors start from different draws: shapes and the alphas
            assert got[k].shape == np.asarray(want[k]).shape, k
            if k.endswith(".alpha"):
                assert float(got[k]) == float(want[k])
