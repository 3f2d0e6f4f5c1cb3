"""CLI: the Textual-Inversion baseline generator (SD1) — counterpart of
``sliders_conceptmod_tpu/cli/generate_images_textinversion.py`` (reference
``eval-scripts/generate_images_textinversion.py:7-36``).

Every CSV prompt gets ``" with {token}"`` appended and is sampled with the
LMS scheduler (50 steps, CFG 7.5, 5 images a prompt by default) into
``{save_path}/{basename(model_name)}/{case}_{i}.png``. The learned embedding
(``--embedding_path``: diffusers ``learned_embeds.{safetensors,bin}`` or an
A1111 ``.pt``) is written into the text tower's token table at a freshly
added token id (``eval/baselines.py::add_inversion_token``):

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_textinversion \\
      --model_name path/to/stable-diffusion-v1-5 --prompts_path prompts/prompts-person.csv \\
      --token "<sks>" --embedding_path learned_embeds.safetensors

``--device`` is a CUDA ordinal (default ``0``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

import torch

from sliders_conceptmod_tpu_torch.cli.generate_images_xl import (
    WEIGHT_DTYPE,
    draw_latents,
    load_prompts_csv,
    save_images,
)
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.eval.baselines import add_inversion_token, load_textual_inversion
from sliders_conceptmod_tpu_torch.infer.generate import latents_to_images, sample_loop
from sliders_conceptmod_tpu_torch.models import factory

# prompts -> (embeddings [B, 77, D], the added conditioning of those rows or None)
Encode = Callable[[list], Tuple[torch.Tensor, Optional[dict]]]


def sweep_cases(args, unet, vae, scheduler, encode: Encode, folder: str, device) -> None:
    """The baseline generators' loop: per CSV case in range, its prompt with
    ``" with {token}"`` (reference :31), one trajectory of one model (no
    flip), ``{folder}/{case}_{i}.png``."""
    rows = load_prompts_csv(args.prompts_path)
    schedule = scheduler.set_timesteps(args.ddim_steps)
    res = args.image_size // 8
    N = args.num_samples
    emb_u, added_u = encode([""] * N)  # the same for every case
    for case_number, prompt, seed in rows:
        if not (args.from_case <= case_number <= args.till_case):
            continue
        emb, added = encode([f"{prompt} with {args.token}"] * N)
        text_emb = torch.cat([emb_u, emb])
        if added is not None:
            added = {k: torch.cat([added_u[k], v]) for k, v in added.items()}
        latents = draw_latents(seed, (N, 4, res, res), device) * schedule.init_noise_sigma
        final = sample_loop(unet, None, 0, scheduler, schedule, latents.to(WEIGHT_DTYPE), text_emb,
                            guidance_scale=args.guidance_scale, added_cond_kwargs=added)
        images = latents_to_images(vae.decode, final, vae.config.scaling_factor)
        save_images(folder, case_number, images)
        print(f"case {case_number}: saved {images.shape[0]} images")


def run(args):
    device = torch_device(args.device)
    folder = f"{args.save_path}/{os.path.basename(os.path.normpath(args.model_name))}"
    os.makedirs(folder, exist_ok=True)
    _, te, unet, scheduler, vae = factory.load_models(
        args.model_name, scheduler_name="lms", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device,
    )
    if args.embedding_path:
        add_inversion_token(te, args.token, load_textual_inversion(args.embedding_path))
    sweep_cases(args, unet, vae, scheduler, lambda prompts: (factory.encode_prompts(te, prompts), None), folder,
                device)


def add_common_flags(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags after ``--model_name``/``--prompts_path``/``--token`` that
    the textual-inversion CLIs share."""
    parser.add_argument("--embedding_path", type=str, default=None, help="learned_embeds file")
    parser.add_argument("--save_path", type=str, default="images/text_inversion")
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu")
    return parser


def build_parser():
    parser = argparse.ArgumentParser(prog="Generate Text Inversion Images")
    parser.add_argument("--model_name", type=str, required=True, help="base model path")
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--token", type=str, required=True)
    return add_common_flags(parser)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
