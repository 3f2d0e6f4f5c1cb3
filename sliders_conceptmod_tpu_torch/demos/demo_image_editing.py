"""Real-image editing with a slider through null-text inversion — the
port's counterpart of ``demos/demo_image_editing.py`` (the reference's
``demo_image_editing.ipynb``): invert a real image with DDIM at CFG 1,
optimise the null-text embedding per timestep so CFG 7.5 reconstructs it
(``infer/null_inversion.py``), then denoise again with the slider merged in
below ``--start_noise`` (the notebook uses 500), once per scale; each result
is written as ``<out>/edit_scale_<scale>.png``.

    python -m sliders_conceptmod_tpu_torch.demos.demo_image_editing --base tiny \\
        --image photo.jpg --prompt "a photo of a person" --slider slider.safetensors --scales 0,2,4

``--image`` is a PNG or JPEG (``train/imageslider.py::load_image_array``);
``--device`` is ``cuda`` (the default), a CUDA ordinal or ``cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import unet_slider
from sliders_conceptmod_tpu_torch.core.config import parse_precision
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.infer import null_inversion as ni
from sliders_conceptmod_tpu_torch.infer.generate import flip_step_for_start_noise, latents_to_images
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.train.imageslider import load_image_array


def run(args, null_cfg: ni.NullOptConfig = ni.NullOptConfig(),
        after_part: Optional[Callable[[str], None]] = None) -> dict:
    """The demo's steps; returns the UNet, the latents of each stage, the
    edits' final latents and images by scale, the inner steps each null-text
    step took and the seconds of each part. ``after_part(name)`` is called as
    each part (load, invert, null_optimization, edit_<scale>) ends."""
    device = torch_device(args.device)
    seconds = {}
    t0 = time.time()

    def done(part: str) -> None:
        nonlocal t0
        if str(device).startswith("cuda"):
            torch.cuda.synchronize(device)
        seconds[part] = time.time() - t0
        if after_part is not None:
            after_part(part)
        t0 = time.time()

    _, te, unet, scheduler, vae = factory.load_models(
        args.base, scheduler_name="ddim", weight_dtype=parse_precision(args.precision), with_vae=True, device=device)
    schedule = scheduler.set_timesteps(args.ddim_steps)
    parts = load_slider_file(args.slider)
    if parts.unet is None:
        raise ValueError(f"{args.slider} carries no unet slider part")
    sites, lora_params = unet_slider(unet, args.slider, parts.unet, device)
    done("load")

    with torch.no_grad():  # the image → the VAE posterior mean latents (the notebook's image2latent)
        image = torch.from_numpy(load_image_array(args.image, args.resolution)).to(device)
        mean, _ = vae.encode(image)
        latent0 = mean.float() * vae.config.scaling_factor
    cond = factory.encode_prompts(te, [args.prompt])
    uncond0 = factory.encode_prompts(te, [""])  # null_optimization keeps its leaf fp32
    traj = ni.ddim_invert(unet, schedule, latent0, cond)
    done("invert")
    inner_steps = []
    uncond_per_step, _ = ni.null_optimization(unet, schedule, traj, cond, uncond0, null_cfg, inner_steps)
    done("null_optimization")

    flip = flip_step_for_start_noise(schedule, args.start_noise)
    os.makedirs(args.out, exist_ok=True)
    finals, images = {}, {}
    for scale in [float(s) for s in args.scales.split(",")]:
        merged = None  # free the previous scale's merged weights first
        merged = lora_lib.merge_lora_params(unet, sites, lora_params, scale)
        finals[scale] = ni.edit_with_slider(unet, merged, flip, schedule, traj[-1], cond, uncond_per_step)
        images[scale] = latents_to_images(vae.decode, finals[scale], vae.config.scaling_factor)[0]
        path = os.path.join(args.out, f"edit_scale_{scale}.png")
        with open(path, "wb") as f:
            f.write(encode_png(images[scale]))
        print(f"scale {scale}: {path}")
        done(f"edit_{scale}")
    return dict(unet=unet, cond=cond, latent0=latent0, trajectory=traj, uncond_per_step=uncond_per_step,
                finals=finals, images=images, inner_steps=inner_steps, flip_step=flip, seconds=seconds)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="runwayml/stable-diffusion-v1-5")
    ap.add_argument("--image", required=True)
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--slider", required=True, help="slider .safetensors")
    ap.add_argument("--scales", default="0,2,4")
    ap.add_argument("--start_noise", type=int, default=500)
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "edit_demo"))
    ap.add_argument(
        "--precision", default="float32", choices=["float32", "bfloat16"],
        help="float32 = notebook parity; bfloat16 = the faster mode (the null-embedding Adam math stays fp32 "
        "inside null_optimization)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default), a CUDA ordinal, or cpu")
    return ap


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
