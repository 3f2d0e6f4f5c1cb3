"""Shared set-up of tests/test_torch_baseline_clis*.py: tiny SD1 and SDXL
single files (with the tiny VAE) written by the port's exporter from its
seeded weightless models (the JAX package would need ~45 s of weightless
initialisation for the same), the prompt CSV of tests/_sweep_cli_assets.py,
and both packages' CLI runs over the same files."""

import os

import numpy as np
import torch

import _sweep_cli_assets as A
from sliders_conceptmod_tpu_torch.io import ldm_export as tle
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig

COMMON = ["--image_size", "64", "--ddim_steps", "3", "--num_samples", "1", "--till_case", "2"]


def write_checkpoints(root) -> None:
    """``tiny-sd1.safetensors`` and ``tiny-xl.safetensors`` under ``root``
    (the names carry "tiny": both loaders build the tiny families), and
    ``prompts.csv`` (cases 0 and 3; ``--till_case 2`` keeps case 0)."""
    vae = tfactory.build_module(lambda: AutoencoderKL(VAEConfig.tiny()), "cpu", torch.float32, 5).state_dict()
    _, te, unet, _ = tfactory.load_models("tiny", device="cpu")
    tle.save_ldm_checkpoint(str(root / "tiny-sd1.safetensors"), tle.export_ldm_checkpoint(
        unet.state_dict(), te.model.state_dict(), vae, v2=False))
    _, tes, xl, _ = tfactory.load_models_xl("tiny-xl", device="cpu")
    tle.save_ldm_checkpoint(str(root / "tiny-xl.safetensors"), tle.export_sdxl_checkpoint(
        xl.state_dict(), tes[0].model.state_dict(), tes[1].model.state_dict(), vae))
    with open(root / "prompts.csv", "w") as f:
        f.write("case_number,prompt,evaluation_seed\n0,a photo of a person,42\n3,a red car,7\n")


def unet_entries(path) -> dict:
    """The UNet of a tiny single file under diffusers' names, fp32 numpy."""
    _, _, unet, _ = tfactory.load_models(str(path), device="cpu")
    return {k: v.numpy() for k, v in unet.state_dict().items()}


def is_kv(key: str) -> bool:
    return "attn2" in key and (".to_k." in key or ".to_v." in key)


def run_both(monkeypatch, jax_cli, port_modules, argv, out, fp32: bool) -> None:
    """The JAX CLI into ``out/jax``, then the port's (``port_modules[0]``,
    the other modules what it calls) into ``out/port`` with JAX's latent
    draws; with ``fp32`` both packages' weight dtype is fp32."""
    if fp32:
        A.fp32(monkeypatch, jax_cli, port_modules[0])
    for mod in port_modules:
        if fp32:
            monkeypatch.setattr(mod, "WEIGHT_DTYPE", torch.float32)
        if hasattr(mod, "draw_latents"):
            monkeypatch.setattr(mod, "draw_latents", A.jax_draw)
    jax_cli.run(jax_cli.build_parser().parse_args(argv + ["--save_path", str(out / "jax")]))
    port_modules[0].main(argv + ["--save_path", str(out / "port"), "--device", "cpu"])


def assert_same_images(out, n_files: int, fp32: bool) -> dict:
    """The same file tree of ``n_files`` PNGs; pixels within 1 of 255 at
    fp32, within the bf16 bound of tests/_sweep_cli_assets.py at bf16.
    Returns the port's images by relative path."""
    from PIL import Image

    port, jax_root = out / "port", out / "jax"
    names = A.tree(jax_root)
    assert A.tree(port) == names and len(names) == n_files, (A.tree(port), names)
    images = {}
    for name in names:
        got, want = (np.asarray(Image.open(os.path.join(r, name))) for r in (port, jax_root))
        diff = np.abs(got.astype(int) - want.astype(int))
        bound = (1, 0.05) if fp32 else (A.PIXEL_MAX, A.PIXEL_MEAN)
        assert got.shape == want.shape and diff.max() <= bound[0] and diff.mean() <= bound[1], \
            (name, diff.max(), diff.mean())
        images[name] = got
    return images


def parser_flags(jax_cli, port_cli, required) -> None:
    """The port's parser is JAX's plus ``--device`` (default "0")."""
    port = vars(port_cli.build_parser().parse_args(required))
    assert port.pop("device") == "0"
    want = vars(jax_cli.build_parser().parse_args(required))
    want.pop("device", None)
    assert port == want
