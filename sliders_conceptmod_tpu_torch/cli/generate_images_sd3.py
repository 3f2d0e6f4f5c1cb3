"""CLI: the SD3 slider sweep (flow matching) — counterpart of
``sliders_conceptmod_tpu/cli/generate_images_sd3.py``:

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_sd3 \\
      --model_name sd3_slider.safetensors --prompts_path prompts/prompts-person.csv \\
      --save_path out --base /ckpts/sd3-medium-diffusers --scales=-2,0,2

Each (case, scale) is one two-phase flow-Euler trajectory
(``infer/generate_flow.py::sample_flow_loop``: the base weights while
``t > start_noise``, the slider after; ``start_noise`` in continuous flow
timesteps 0..1000), CFG with the uncond ("") row first, one sample per case
(the JAX CLI's). The slider is merged into the site weights at each scale
(``adapters/lora.py::merge_lora_params``); with ``--quantize_base`` (int8
transformer Linears, ``adapters/quant.py``) or ``--w8a8`` (which implies
it), where nothing can be merged, the scale rides the per-row overlay
instead. Text-encoder parts (a notrigger save over the CLIP-L/bigG towers,
or a ``combine_loras`` file) merge into the towers at each scale before the
encode, the uncond row's included (its embedding cached per scale).

The weights are bf16, as the JAX CLI loads them. Outputs:
``{save_path}/{basename(model_name)}/{scale}/{case}_0.png`` when ``--base``
is a directory with ``vae/`` (the 16-channel VAE decodes ``z / scaling +
shift``), else the final latents as ``{case}_0.npy`` (fp32), as in JAX.
The initial latents are drawn from each case's ``evaluation_seed`` with
torch's generator (the JAX CLI's numbers differ). ``--device`` is a CUDA
ordinal (default ``0``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import (
    draw_latents,
    load_prompts_csv,
    settings_from_tensors,
)
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.infer.generate_flow import (
    flip_step_for_start_noise,
    sample_flow_loop,
    sd3_latents_to_images,
)
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory

WEIGHT_DTYPE = torch.bfloat16  # the weights' and the sampled latents' dtype, as the JAX CLI loads them


def sd3_slider(transformer, path: str, part, device=None):
    """(sites, factors) of a ``-``-delimited SD3 slider part over the
    transformer: rank and alpha from its tensors (else 4 and 1), the sites
    the file carries."""
    rank, alpha = settings_from_tensors(part) or (4, 1.0)
    sites = lora_lib.create_sites(transformer, rank=rank, alpha=alpha, target_replace=["Attention"],
                                  train_method="full", delimiter="-")
    sites = lora_lib.filter_sites_to_keys(part.keys(), sites)
    if not sites:
        raise ValueError(f"No matching LoRA keys between transformer and {path}")
    return sites, lora_lib.load_weights_from_tensors(part, sites, device=device)


def run(args):
    if args.w8a8:
        args.quantize_base = True
    device = torch_device(args.device)
    rows = load_prompts_csv(args.prompts_path)
    scales = [float(s) for s in args.scales.split(",")]
    name = os.path.basename(args.model_name)
    for scale in scales:
        os.makedirs(f"{args.save_path}/{name}/{scale}", exist_ok=True)

    _, text_encoders, transformer, scheduler = factory.load_models_sd3(
        args.base, weight_dtype=WEIGHT_DTYPE, device=device, quantize_base=args.quantize_base)
    quant.set_act_quant(transformer, args.w8a8)
    # the decode in fp32, as the JAX CLI loads its VAE
    has_vae = os.path.isdir(os.path.join(str(args.base), "vae"))
    vae = factory.sd3_vae(args.base, device, torch.float32) if has_vae else None
    mm_cfg = transformer.config
    parts = load_slider_file(args.model_name, [te.model for te in text_encoders])
    sites, lora_params = [], {}
    if parts.unet is not None:
        sites, lora_params = sd3_slider(transformer, args.model_name, parts.unet, device)
    elif not parts.has_te:
        raise ValueError(f"{args.model_name} carries neither transformer nor text-encoder slider parts")
    overlay = lora_lib.LoRAOverlay(transformer, sites, lora_params)

    schedule = scheduler.set_timesteps(args.steps)
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    res = args.image_size // 8
    t5_len = factory.sd3_t5_seq_len(args.base)
    uncond_cache: dict = {}

    def encode_case(prompt: str, scale: float):
        """(text [2], pooled [2]) uncond ++ cond; text-encoder parts merge at
        ``scale`` first, the uncond row's included."""
        if not parts.has_te:
            scale = 0.0
        with parts.merged_text_encoders(scale):
            if scale not in uncond_cache:
                uncond_cache[scale] = factory.encode_prompts_sd3(text_encoders, [""], mm_cfg.joint_attention_dim,
                                                                 t5_len)
            text, pooled = factory.encode_prompts_sd3(text_encoders, [prompt], mm_cfg.joint_attention_dim, t5_len)
        text_u, pooled_u = uncond_cache[scale]
        return torch.cat([text_u, text]), torch.cat([pooled_u, pooled])

    for case_number, prompt, seed in rows:
        if not (args.from_case <= case_number <= args.till_case):
            continue
        for scale in scales:
            emb, pooled = encode_case(prompt, scale)
            latents = draw_latents(seed, (1, mm_cfg.in_channels, res, res), device).to(WEIGHT_DTYPE)
            if args.quantize_base:
                final = sample_flow_loop(transformer, flip, schedule, latents, emb, pooled,
                                         guidance_scale=args.guidance_scale, overlay=overlay,
                                         row_scale=torch.full((1,), scale, device=latents.device))
            else:
                merged = None  # free the previous scale's merged weights first
                merged = lora_lib.merge_lora_params(transformer, sites, lora_params, scale)
                final = sample_flow_loop(transformer, flip, schedule, latents, emb, pooled,
                                         guidance_scale=args.guidance_scale, merged=merged)
            out_path = f"{args.save_path}/{name}/{scale}/{case_number}_0"
            if vae is not None:
                img = sd3_latents_to_images(vae.decode, final, vae.config.scaling_factor, vae.config.shift_factor)[0]
                with open(out_path + ".png", "wb") as f:
                    f.write(encode_png(img))
                out_path += ".png"
            else:
                np.save(out_path + ".npy", final.float().cpu().numpy())
                out_path += ".npy"
            print(f"case {case_number} scale {scale}: wrote {out_path}")


def build_parser():
    parser = argparse.ArgumentParser(prog="generateImagesSD3")
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--base", type=str, default="stabilityai/stable-diffusion-3-medium")
    parser.add_argument("--guidance_scale", type=float, default=7.0)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--steps", type=int, default=28)
    parser.add_argument("--start_noise", type=float, default=750)
    parser.add_argument("--scales", type=str, default="-2,-1,0,1,2")
    parser.add_argument("--quantize_base", action="store_true",
                        help="int8 transformer Linears (adapters/quant.py); the slider runs via the overlay")
    parser.add_argument("--w8a8", action="store_true",
                        help="per-token int8 activations on the int8 Linears (implies --quantize_base)")
    parser.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
