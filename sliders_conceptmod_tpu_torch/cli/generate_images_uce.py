"""CLI: the UCE baseline-comparison sweep — counterpart of
``sliders_conceptmod_tpu/cli/generate_images_uce.py`` (reference
``eval-scripts/generate_images-uce.py``).

The edited model is a whole diffusers UNet state dict
(``eval/baselines.py::load_edited_unet``). Each scale samples with the
ORIGINAL UNet while ``t > start_noise`` and with
``original + scale·(edited − original)`` after (LMS), and writes
``{save_path}/{basename}/{scale}/{case}_{n}.png`` (``0.5`` → ``half``) and the
composite ``{save_path}/{basename}/all/{case}.png``:

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_uce \\
      --model_name uce_edited.safetensors --prompts_path prompts/prompts-person.csv \\
      --save_path out --base path/to/stable-diffusion-v1-4

The delta is fp32, taken from the unrounded edited weights; each scale's
weights are ``(base.float() + s·delta).to(base.dtype)``, swapped in at the
flip by ``infer/generate.py::sample_loop``. Only the tensors whose delta is
non-zero are interpolated (at a zero delta the interpolation is the base,
bit for bit), so the card holds one UNet and the edited tensors.
``--device`` is a CUDA ordinal (default ``0``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

from sliders_conceptmod_tpu_torch.cli.generate_images_xl import (
    WEIGHT_DTYPE,
    draw_latents,
    load_prompts_csv,
    save_composite,
    save_images,
)
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.eval.baselines import load_edited_unet
from sliders_conceptmod_tpu_torch.infer.generate import flip_step_for_start_noise, latents_to_images, sample_loop
from sliders_conceptmod_tpu_torch.models import factory


def scale_folder(scale: float) -> str:
    """The scale's folder name: ``0.5`` → ``half`` (reference :178; an exact
    match only, so 10.5 or 0.55 stay as they are), trailing zeros dropped."""
    if abs(scale) == 0.5:
        return "half" if scale > 0 else "-half"
    return f"{scale}".rstrip("0").rstrip(".") if "." in f"{scale}" else f"{scale}"


@torch.no_grad()
def edit_delta(unet, edited: dict) -> dict:
    """``{name: edited.float() − base.float()}`` for every UNet parameter
    whose edit is not zero (the edited dict must hold every parameter)."""
    params = dict(unet.named_parameters())
    missing, extra = sorted(set(params) - set(edited)), sorted(set(edited) - set(params))
    if missing or extra:
        raise KeyError(f"the edited UNet's keys differ from the base's: missing {missing[:3]}, unexpected {extra[:3]}")
    delta = {}
    for name, p in params.items():
        d = edited[name].to(device=p.device, dtype=torch.float32) - p.float()
        if bool(d.any()):
            delta[name] = d
    return delta


@torch.no_grad()
def interpolate(unet, delta: dict, scale: float) -> dict:
    """The interpolated weights of the edited tensors at ``scale``."""
    params = dict(unet.named_parameters())
    return {k: (params[k].float() + scale * d).to(params[k].dtype) for k, d in delta.items()}


def run(args):
    device = torch_device(args.device)
    rows = load_prompts_csv(args.prompts_path)
    scales = [float(s) for s in args.scales.split(",")]
    name = os.path.basename(os.path.normpath(args.model_path))
    folder = f"{args.save_path}/{name}"
    for scale in scales:
        os.makedirs(f"{folder}/{scale_folder(scale)}", exist_ok=True)

    _, te, unet, scheduler, vae = factory.load_models(
        args.base, scheduler_name="lms", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device,
    )
    delta = edit_delta(unet, load_edited_unet(args.model_path))

    schedule = scheduler.set_timesteps(args.ddim_steps)
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    res = args.image_size // 8
    neg = args.negative_prompts or ""
    uncond = factory.encode_prompts(te, [neg] * args.num_samples)  # the same for every case
    for case_number, prompt, seed in rows:
        if not (args.from_case <= case_number <= args.till_case):
            continue
        cond = factory.encode_prompts(te, [prompt] * args.num_samples)
        text_emb = torch.cat([uncond, cond])
        firsts = []
        for scale in scales:
            latents = draw_latents(seed, (args.num_samples, 4, res, res), device) * schedule.init_noise_sigma
            merged = None  # free the previous scale's weights first
            merged = interpolate(unet, delta, scale) if delta else None
            final = sample_loop(unet, merged, flip, scheduler, schedule, latents.to(WEIGHT_DTYPE), text_emb,
                                guidance_scale=args.guidance_scale)
            images = latents_to_images(vae.decode, final, vae.config.scaling_factor)
            save_images(f"{folder}/{scale_folder(scale)}", case_number, images)
            firsts.append(images[0])
            print(f"case {case_number} scale {scale}: saved {images.shape[0]} images")
        save_composite(folder, case_number, firsts)


def build_parser():
    parser = argparse.ArgumentParser(prog="generateImagesUCE")
    # reference flag name is --model_name; --model_path kept as an alias
    parser.add_argument("--model_name", "--model_path", dest="model_path", type=str, required=True,
                        help="edited UNet state dict")
    parser.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu")
    parser.add_argument("--rank", type=int, default=4, help="accepted for parity; unused by UCE")
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--negative_prompts", type=str, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--base", type=str, default="CompVis/stable-diffusion-v1-4")
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--start_noise", type=int, default=750)
    parser.add_argument("--scales", type=str, default="-2,-1,-0.5,0,0.5,1,2")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
