"""Shared set-up of tests/test_torch_sweep_cli_{xl,sd1}.py: the JAX-written
tiny checkpoints and slider, the CLI arguments, the fp32 switch of both
CLIs, and the comparison of two sweep trees (the bounds are stated in those
files' docstrings)."""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.io import ldm_export as le
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from sliders_conceptmod_tpu.models.vae import VAEConfig as JVAEConfig

CONV = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV
SLIDER = "slider_full_rank2_alpha1.safetensors"
PIXEL_MAX, PIXEL_MEAN = 24, 3.0


def jax_draw(seed, shape, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(int(seed)), tuple(shape), jnp.float32)))


def write_slider(path, unet_params):
    sites = jlora.create_sites(unet_params, rank=2, alpha=1.0, target_replace=CONV, train_method="full")
    rng = np.random.default_rng(11)
    lp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(11), sites))
    jlora.save_weights(str(path), sites, lp)


def make_assets(root, family: str):
    """The JAX-written tiny checkpoint of ``family`` (xl or sd1, with the tiny
    VAE), a slider over it and a two-row prompt CSV, under ``root``."""
    vae = JAutoencoderKL(JVAEConfig.tiny()).init(jax.random.PRNGKey(5), jnp.zeros((1, 3, 16, 16)))["params"]
    if family == "xl":
        _, jtes, junet, _ = jfactory.load_models_xl("tiny-xl")
        le.save_ldm_checkpoint(str(root / "tiny-xl.safetensors"),
                               le.export_sdxl_checkpoint(junet.params, jtes[0].params, jtes[1].params, vae))
    else:
        _, jte, junet, _ = jfactory.load_models("tiny")
        le.save_ldm_checkpoint(str(root / "tiny-sd1.safetensors"),
                               le.export_ldm_checkpoint(junet.params, jte.params, vae, v2=False))
    os.makedirs(root / family)
    write_slider(root / family / SLIDER, junet.params)
    with open(root / "prompts.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerow([0, "a photo of a person", 42])
        w.writerow([3, "a red car", 7])  # outside --till_case 2
    return root


def args(assets, family, out, *extra):
    base = assets / ("tiny-xl.safetensors" if family == "xl" else "tiny-sd1.safetensors")
    return ["--model_name", str(assets / family / SLIDER), "--prompts_path", str(assets / "prompts.csv"),
            "--save_path", str(out), "--base", str(base), "--image_size", "64", "--ddim_steps", "3",
            "--num_samples", "1", "--scales=-1,1", "--till_case", "2", *extra]


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def fp32(monkeypatch, jax_cli, port_cli):
    """Both CLIs at fp32: the port's WEIGHT_DTYPE, and the JAX CLI's module
    sees ``jnp.bfloat16`` as ``float32`` (nothing in the JAX package changes)."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jax_cli, "jnp", proxy)
    monkeypatch.setattr(port_cli, "WEIGHT_DTYPE", torch.float32)


def assert_same_sweep(port_root, jax_root, fp32: bool):
    assert tree(port_root) == tree(jax_root)
    names = tree(jax_root)
    assert len(names) == 3 and f"{SLIDER}/all/0.png" in names  # 2 scales + the composite
    for name in names:
        got = np.asarray(Image.open(os.path.join(port_root, name)))
        want = np.asarray(Image.open(os.path.join(jax_root, name)))
        assert got.shape == want.shape and got.dtype == np.uint8, name
        diff = np.abs(got.astype(int) - want.astype(int))
        bound = (1, 0.05) if fp32 else (PIXEL_MAX, PIXEL_MEAN)
        assert diff.max() <= bound[0] and diff.mean() <= bound[1], (name, diff.max(), diff.mean())
    a, b = (np.asarray(Image.open(os.path.join(port_root, SLIDER, s, "0_0.png"))) for s in ("-1.0", "1.0"))
    assert not np.array_equal(a, b)  # the slider bites
