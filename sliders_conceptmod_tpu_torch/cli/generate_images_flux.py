"""CLI: the Flux slider sweep (few-step flow matching over packed tokens) —
counterpart of ``sliders_conceptmod_tpu/cli/generate_images_flux.py``:

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_flux \\
      --model_name flux_slider.safetensors --prompts_path prompts/prompts-person.csv \\
      --save_path out --base /ckpts/flux-schnell-diffusers --scales=-2,0,2

Each (case, scale) is one two-phase flow-Euler trajectory over packed tokens
(``infer/generate_flow.py::sample_packed_flow``: the base weights while
``t > start_noise``, the slider after; ``start_noise`` in continuous flow
timesteps 0..1000), un-guided, one sample per case, the schedule shifted by
μ from the image's token count. A dev model takes ``--guidance_scale`` as
its distilled-guidance input (schnell ignores it). The slider is merged
into the site weights at each scale; with ``--quantize_base`` (int8
transformer Linears) or ``--w8a8`` (which implies it) the scale rides the
per-row overlay instead. Text-encoder parts (te1 CLIP-L, te2 T5) merge into
the towers at each scale before the encode, which needs a directory's
towers; without them every case is encoded once up front and the towers
are freed.

The weights are bf16, as the JAX CLI loads them. Outputs:
``{save_path}/{basename(model_name)}/{scale}/{case}_0.png`` when ``--base``
is a directory with ``vae/`` (the 16-channel VAE decodes ``z / scaling +
shift`` in fp32), else the final latents as ``{case}_0.npy`` (fp32), as in
JAX. The initial latents are drawn from each case's ``evaluation_seed``
with torch's generator (the JAX CLI's numbers differ). ``--device`` is a
CUDA ordinal (default ``0``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_sd3 import sd3_slider
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import draw_latents, load_prompts_csv, torch_device
from sliders_conceptmod_tpu_torch.diffusion.flow_match import calculate_shift
from sliders_conceptmod_tpu_torch.infer.generate_flow import (
    flip_step_for_start_noise,
    sample_packed_flow,
    sd3_latents_to_images,
)
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.models.flux import pack_latents, prepare_latent_image_ids, unpack_latents

WEIGHT_DTYPE = torch.bfloat16  # the weights' and the sampled tokens' dtype, as the JAX CLI loads them


def run(args):
    if args.w8a8:
        args.quantize_base = True
    device = torch_device(args.device)
    rows = load_prompts_csv(args.prompts_path)
    scales = [float(s) for s in args.scales.split(",")]
    name = os.path.basename(args.model_name)
    for scale in scales:
        os.makedirs(f"{args.save_path}/{name}/{scale}", exist_ok=True)

    _, encoder, transformer, scheduler = factory.load_models_flux(
        args.base, weight_dtype=WEIGHT_DTYPE, device=device, quantize_base=args.quantize_base)
    quant.set_act_quant(transformer, args.w8a8)
    cfg = transformer.config
    vae_scale = factory.flux_vae_scale(args.base)
    parts = load_slider_file(args.model_name, encoder.text_encoders, te2_is_t5=True)
    sites, lora_params = [], {}
    if parts.unet is not None:
        sites, lora_params = sd3_slider(transformer, args.model_name, parts.unet, device)
    elif not parts.has_te:
        raise ValueError(f"{args.model_name} carries neither transformer nor text-encoder slider parts")
    overlay = lora_lib.LoRAOverlay(transformer, sites, lora_params)

    gh = gw = args.image_size // vae_scale // 2
    schedule = scheduler.set_timesteps(args.steps, mu=calculate_shift(gh * gw))
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    img_ids = torch.from_numpy(prepare_latent_image_ids(gh, gw)).to(device)
    has_vae = os.path.isdir(os.path.join(str(args.base), "vae"))
    vae = factory.sd3_vae(args.base, device, torch.float32) if has_vae else None

    cases = [(c, p, s) for c, p, s in rows if args.from_case <= c <= args.till_case]
    if not parts.has_te:  # encode every case once, then free the towers (T5-XXL is 9.5 GB in bf16)
        encoded = {c: encoder(p) for c, p, _ in cases}
        del encoder
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    for case_number, prompt, seed in cases:
        for scale in scales:
            if parts.has_te:
                with parts.merged_text_encoders(scale):
                    text, pooled = encoder(prompt)
            else:
                text, pooled = encoded[case_number]
            text, pooled = text[None], pooled[None]
            latents = draw_latents(seed, (1, cfg.in_channels // 4, gh * 2, gw * 2), device)
            tokens = pack_latents(latents).to(WEIGHT_DTYPE)
            if args.quantize_base:
                final = sample_packed_flow(transformer, flip, schedule, tokens, text, pooled, img_ids,
                                           guidance=args.guidance_scale, overlay=overlay,
                                           row_scale=torch.full((1,), scale, device=device))
            else:
                merged = None  # free the previous scale's merged weights first
                merged = lora_lib.merge_lora_params(transformer, sites, lora_params, scale)
                final = sample_packed_flow(transformer, flip, schedule, tokens, text, pooled, img_ids,
                                           guidance=args.guidance_scale, merged=merged)
            lat = unpack_latents(final, gh * 2, gw * 2)
            out_path = f"{args.save_path}/{name}/{scale}/{case_number}_0"
            if vae is not None:
                img = sd3_latents_to_images(vae.decode, lat, vae.config.scaling_factor, vae.config.shift_factor)[0]
                with open(out_path + ".png", "wb") as f:
                    f.write(encode_png(img))
                out_path += ".png"
            else:
                np.save(out_path + ".npy", lat.float().cpu().numpy())
                out_path += ".npy"
            print(f"case {case_number} scale {scale}: wrote {out_path}")


def build_parser():
    parser = argparse.ArgumentParser(prog="generateImagesFlux")
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--base", type=str, default="black-forest-labs/FLUX.1-schnell")
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--start_noise", type=float, default=800)
    parser.add_argument("--guidance_scale", type=float, default=3.5,
                        help="Distilled-guidance embedding for dev checkpoints (no CFG); ignored by schnell.")
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
