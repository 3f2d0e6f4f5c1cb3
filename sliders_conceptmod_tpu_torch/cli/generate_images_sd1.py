"""CLI: the SD1.x/SD2.x slider sweep.

Counterpart of ``sliders_conceptmod_tpu/cli/generate_images_sd1.py`` (the
reference's ``eval-scripts/generate_images_sd1.py``): tokenize, CFG
embeddings, the LMS scheduler, the slider flipped on at ``start_noise``
(default 850), the VAE decode; per-scale folders and a composite grid per
case, as the XL sweep writes them:

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_sd1 \\
      --model_name slider.safetensors --prompts_path prompts/prompts-person.csv \\
      --save_path out --base path/to/stable-diffusion-v1-5 --scales=-2,2 --num_samples 1

Each scale runs the merged slider through ``infer/generate.py::sample_loop``
(bf16 weights, as the JAX CLI loads them). ``--v2`` loads SD2.x (the
OpenCLIP tower and SD2.1's UNet widths), ``--v_pred`` samples with
v-prediction. ``--device`` is a CUDA ordinal (default ``0``) or ``cpu``.
As in JAX, this sweep regenerates every image (no resume).
"""

from __future__ import annotations

import argparse
import os

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import (
    WEIGHT_DTYPE,
    draw_latents,
    load_prompts_csv,
    save_composite,
    save_images,
    unet_slider,
)
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.infer.generate import flip_step_for_start_noise, latents_to_images, sample_loop
from sliders_conceptmod_tpu_torch.models import factory


def run(args):
    device = torch_device(args.device)
    rows = load_prompts_csv(args.prompts_path)
    scales = [float(s) for s in args.scales.split(",")]
    name = os.path.basename(args.model_name)
    root = f"{args.save_path}/{name}"
    for scale in scales:
        os.makedirs(f"{root}/{scale}", exist_ok=True)

    _, te, unet, scheduler, vae = factory.load_models(
        args.base, scheduler_name="lms", v2=args.v2, v_pred=args.v_pred, weight_dtype=WEIGHT_DTYPE,
        with_vae=True, device=device,
    )
    parts = load_slider_file(args.model_name)
    if parts.unet is None:
        raise ValueError(f"{args.model_name} carries no unet slider part")
    sites, lora_params = unet_slider(unet, args.model_name, parts.unet, device)

    schedule = scheduler.set_timesteps(args.ddim_steps)
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    res = args.image_size // 8
    neg = args.negative_prompts or ""
    for case_number, prompt, seed in rows:
        if not (args.from_case <= case_number <= args.till_case):
            continue
        cond = factory.encode_prompts(te, [prompt] * args.num_samples)
        uncond = factory.encode_prompts(te, [neg] * args.num_samples)
        text_emb = torch.cat([uncond, cond])
        firsts = []
        for scale in scales:
            latents = draw_latents(seed, (args.num_samples, 4, res, res), device) * schedule.init_noise_sigma
            merged = None  # free the previous scale's merged weights first
            merged = lora_lib.merge_lora_params(unet, sites, lora_params, scale)
            final = sample_loop(unet, merged, flip, scheduler, schedule, latents.to(WEIGHT_DTYPE), text_emb,
                                guidance_scale=args.guidance_scale)
            images = latents_to_images(vae.decode, final, vae.config.scaling_factor)
            save_images(f"{root}/{scale}", case_number, images)
            firsts.append(images[0])
            print(f"case {case_number} scale {scale}: saved {images.shape[0]} images")
        save_composite(root, case_number, firsts)


def build_parser():
    parser = argparse.ArgumentParser(prog="generateImagesSD1")
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--negative_prompts", type=str, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--base", type=str, default="runwayml/stable-diffusion-v1-5")
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--start_noise", type=int, default=850)
    parser.add_argument("--scales", type=str, default="-2,-1,0,1,2")
    parser.add_argument("--v2", action="store_true", help="SD2.x base: the OpenCLIP tower and SD2.1's UNet widths")
    parser.add_argument("--v_pred", action="store_true", help="v-prediction base (SD2.x 768-v checkpoints)")
    parser.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
