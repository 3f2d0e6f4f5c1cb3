"""Few-step (Turbo-style) slider inference — the port's counterpart of
``demos/demo_sdxl_turbo.py`` (the reference's ``demo_SDXL_Turbo.ipynb``, cell
8): an SDXL-Turbo base, 1–4 Euler-A steps, guidance 0 (the cond-only path:
turbo models are distilled without CFG), the slider merged in below
``--start_noise`` (default 800), one image per scale as
``<out>/turbo_scale_<scale>.png``:

    python -m sliders_conceptmod_tpu_torch.demos.demo_sdxl_turbo --base path/to/sdxl-turbo \\
        --slider slider.safetensors --prompt "a photo of a person" --steps 4 --scales=-2,0,2

The slider's UNet part is read as the sweeps read it (rank and alpha from
its tensors, else its file name; ``cli/generate_images_xl.py::unet_slider``);
bf16 weights. ``--device`` is ``cuda`` (the default), a CUDA ordinal or
``cpu``. The initial latents and the step noise are torch draws from
``--seed`` (the JAX demo draws ``PRNGKey(seed)``).
"""

from __future__ import annotations

import argparse
import os

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import draw_latents, unet_slider
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.demos.demo_concept_sliders import step_noise, xl_conditioning
from sliders_conceptmod_tpu_torch.infer.generate import flip_step_for_start_noise, latents_to_images, sample_loop
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory

WEIGHT_DTYPE = torch.bfloat16  # the weights' and the sampled latents' dtype, as the JAX demo loads them


def run(args) -> dict:
    """Every scale's image (uint8 HWC) by scale."""
    device = torch_device(args.device)
    _, text_encoders, unet, scheduler, vae = factory.load_models_xl(
        args.base, scheduler_name="euler_a", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device
    )
    schedule = scheduler.set_timesteps(args.steps)
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    parts = load_slider_file(args.slider)
    if parts.unet is None:
        raise ValueError(f"{args.slider} carries no unet slider part")
    sites, lora_params = unet_slider(unet, args.slider, parts.unet, device)
    emb, added = xl_conditioning(text_encoders, args.prompt, args.resolution, device)

    os.makedirs(args.out, exist_ok=True)
    shape = (1, 4, args.resolution // 8, args.resolution // 8)
    images = {}
    for scale in [float(s) for s in args.scales.split(",")]:
        latents = draw_latents(args.seed, shape, device) * schedule.init_noise_sigma
        merged = None  # free the previous scale's merged weights first
        merged = lora_lib.merge_lora_params(unet, sites, lora_params, scale)
        final = sample_loop(unet, merged, flip, scheduler, schedule, latents.to(WEIGHT_DTYPE), emb,
                            guidance_scale=args.guidance_scale, added_cond_kwargs=added,
                            step_noise=step_noise(args.seed, args.steps, shape, device))
        images[scale] = latents_to_images(vae.decode, final, vae.config.scaling_factor)[0]
        with open(f"{args.out}/turbo_scale_{scale}.png", "wb") as f:
            f.write(encode_png(images[scale]))
        print(f"scale {scale}: {args.out}/turbo_scale_{scale}.png")
    return images


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="stabilityai/sdxl-turbo")
    ap.add_argument("--slider", required=True)
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--guidance_scale", type=float, default=0.0)
    ap.add_argument("--start_noise", type=int, default=800)
    ap.add_argument("--scales", default="-2,0,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="/tmp/turbo_demo")
    ap.add_argument("--device", default="cuda", help="cuda (default), a CUDA ordinal, or cpu")
    return ap


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
