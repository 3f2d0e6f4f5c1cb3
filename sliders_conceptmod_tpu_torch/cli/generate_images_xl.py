"""CLI: the SDXL slider sweep — a scale grid × a prompt CSV with fixed seeds.

Counterpart of ``sliders_conceptmod_tpu/cli/generate_images_xl.py`` (the
reference's ``generate_images_xl.py`` flag surface):

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_xl \\
      --model_name slider_rank4_alpha1.safetensors --prompts_path prompts/prompts-person.csv \\
      --save_path out --scales=-2,0,2 --num_samples 1

It writes ``{save_path}/{basename(model_name)}/{scale}/{case}_{idx}.png`` and
the composite ``{save_path}/{basename}/all/{case}.png`` (the first sample of
every scale side by side), and keeps PNGs that exist (a rerun resumes). The
weights are bf16, as the JAX CLI loads them; ``--base`` is a family name, a
diffusers directory or a single file (``models/factory.py``).

Two paths, as in JAX:

* the default: per scale, the slider merged into the site weights
  (``adapters/lora.py::merge_lora_params``) and one two-phase trajectory
  (``infer/generate.py::sample_loop``: base weights while
  ``t > start_noise``, merged after);
* ``--batch_scales``: every scale in one trajectory through the per-row
  overlay (``sample_loop_scales``), then one decode per scale.

Rank and alpha come from the checkpoint's tensors when it has one alpha, else
from the file name (the reference's sniffing). A file with text-encoder parts
(a notrigger save, or a ``cli/combine_loras.py`` output) merges them into the
CLIP towers at each scale before the encode, the negative/uncond prompt's
included (``adapters/slider_file.py``); a file with text-encoder parts only
runs with no UNet sites. ``--device`` is a CUDA ordinal (default ``0``) or
``cpu``.

``--quantize_base`` loads the UNet's large Linears as int8
(``adapters/quant.py``); ``--w8a8`` also quantizes their activations per
token (and implies ``--quantize_base``). Both need ``--batch_scales``: the
default path merges the slider into the weights, which an int8 base cannot
hold (JAX's rule and message). The text towers are never quantized, so
text-encoder parts merge into them as before. ``--mesh_data > 1`` exits
naming the ROADMAP item that owns it.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Tuple

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.infer.generate import (
    flip_step_for_start_noise,
    latents_to_images,
    sample_loop,
    sample_loop_scales,
)
from sliders_conceptmod_tpu_torch.io.png import decode_png, encode_png
from sliders_conceptmod_tpu_torch.models import factory

WEIGHT_DTYPE = torch.bfloat16  # the weights' and the sampled latents' dtype, as the JAX CLI loads them


def infer_network_settings(lora_weight: str):
    """Filename sniffing (reference generate_images_xl.py:459-484)."""
    train_method = "full" if "full" in lora_weight else "noxattn"
    network_type = "lierla" if train_method == "xattn" else "c3lier"
    rank, alpha = 1, 4.0
    if "rank4" in lora_weight:
        rank = 4
    if "rank8" in lora_weight:
        rank = 8
    if "alpha1" in lora_weight:
        alpha = 1.0
    return train_method, network_type, rank, alpha


def settings_from_tensors(sd) -> Optional[Tuple[int, float]]:
    """Exact (rank, alpha) from the checkpoint tensors, when it has one alpha."""
    ranks = {int(v.shape[0]) for k, v in sd.items() if k.endswith(".lora_down.weight")}
    alphas = {float(v) for k, v in sd.items() if k.endswith(".alpha")}
    if ranks and len(alphas) == 1:
        return max(ranks), alphas.pop()
    return None


def settings_from_checkpoint(path: str) -> Optional[Tuple[int, float]]:
    """:func:`settings_from_tensors` of a ``.safetensors`` file (None for
    other files, as in JAX)."""
    if not str(path).endswith(".safetensors"):
        return None
    from sliders_conceptmod_tpu_torch.io.safetensors import load_file

    return settings_from_tensors(load_file(str(path)))


def load_prompts_csv(path: str):
    """``(case_number, prompt, evaluation_seed)`` rows of a prompt CSV."""
    with open(path, newline="") as f:
        return [(int(r["case_number"]), r["prompt"], int(r["evaluation_seed"])) for r in csv.DictReader(f)]


def unet_slider(unet, path: str, unet_sd, device=None):
    """(sites, factors) of a UNet slider part over ``unet``: the settings
    from the tensors (else the file name), the sites the file carries."""
    if any(k.endswith(".dora_scale") for k in unet_sd):
        raise NotImplementedError(f"{path} is a DoRA slider: the sweeps and the export apply LoRA sliders only "
                                  "(the JAX CLIs would read its factors and drop its dora_scale)")
    train_method, network_type, rank, alpha = infer_network_settings(str(path))
    exact = settings_from_tensors(unet_sd)
    if exact is not None:
        rank, alpha = exact
    targets = lora_lib.UNET_TARGET_REPLACE_MODULE_TRANSFORMER
    if network_type == "c3lier":
        targets = targets + lora_lib.UNET_TARGET_REPLACE_MODULE_CONV
    sites = lora_lib.create_sites(unet, rank=rank, alpha=alpha, target_replace=targets, train_method=train_method)
    sites = lora_lib.filter_sites_to_keys(unet_sd.keys(), sites)
    if not sites:
        raise ValueError(f"No matching LoRA keys between UNet and {path}")
    return sites, lora_lib.load_weights_from_tensors(unet_sd, sites, device=device)


def draw_latents(seed: int, shape, device) -> torch.Tensor:
    """The initial N(0, 1) draw of one case, from its ``evaluation_seed``.
    (The JAX CLI draws ``normal(PRNGKey(seed))``; the numbers differ.)"""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def check_args(args) -> None:
    """JAX's int8 rules (``--w8a8`` implies ``--quantize_base``, which needs
    ``--batch_scales``), then what is not ported."""
    if getattr(args, "w8a8", False):
        args.quantize_base = True
    if getattr(args, "quantize_base", False) and not args.batch_scales:
        raise SystemExit("--quantize_base requires --batch_scales (the slider "
                         "runs via the apply-time overlay, never merged)")
    if getattr(args, "mesh_data", 1) > 1:
        raise SystemExit("--mesh_data > 1: sharded sweeps are not ported yet (ROADMAP.md queue 1, item 12)")


def save_images(out_dir: str, case_number: int, images: np.ndarray) -> None:
    for idx, img in enumerate(images):
        with open(f"{out_dir}/{case_number}_{idx}.png", "wb") as f:
            f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_composite(root: str, case_number: int, firsts) -> None:
    """The first sample of every scale side by side: ``all/{case}.png``."""
    os.makedirs(f"{root}/all", exist_ok=True)
    with open(f"{root}/all/{case_number}.png", "wb") as f:
        f.write(encode_png(np.concatenate(firsts, axis=1)))


def run(args):
    check_args(args)
    device = torch_device(args.device)
    rows = load_prompts_csv(args.prompts_path)
    scales = [float(s) for s in args.scales.split(",")]
    name = os.path.basename(args.model_name)
    root = f"{args.save_path}/{name}"
    for scale in scales:
        os.makedirs(f"{root}/{scale}", exist_ok=True)

    _, text_encoders, unet, scheduler, vae = factory.load_models_xl(
        args.base, scheduler_name="ddim", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device,
        quantize_base=args.quantize_base,
    )
    quant.set_act_quant(unet, args.w8a8)
    parts = load_slider_file(args.model_name, [te.model for te in text_encoders])
    sites, lora_params = [], {}
    if parts.unet is not None:
        sites, lora_params = unet_slider(unet, args.model_name, parts.unet, device)
    elif not parts.has_te:
        raise ValueError(f"{args.model_name} carries neither unet nor text-encoder slider parts")

    schedule = scheduler.set_timesteps(args.ddim_steps)
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    res = args.image_size // 8
    N, S = args.num_samples, len(scales)
    neg = args.negative_prompts or ""
    time_ids = torch.from_numpy(get_add_time_ids(args.image_size, args.image_size)).to(device)

    def encode_case(prompt: str, scale: float):
        """(uncond ++ cond embeddings [2N], pooled [2N]) of one prompt, the
        text-encoder parts merged at ``scale`` (no start_noise gate: the
        embeddings hold for the whole trajectory)."""
        with parts.merged_text_encoders(scale), torch.inference_mode():
            text, pooled = factory.encode_prompts_xl(text_encoders, [prompt] * N)
            text_u, pooled_u = factory.encode_prompts_xl(text_encoders, [neg] * N)
        return torch.cat([text_u, text]), torch.cat([pooled_u, pooled])

    for case_number, prompt, seed in rows:
        if not (args.from_case <= case_number <= args.till_case):
            continue
        if not parts.has_te:
            emb, pooled = encode_case(prompt, 0.0)
        firsts = []
        if args.batch_scales:
            paths = [f"{root}/{s}/{case_number}_0.png" for s in scales]
            if all(os.path.exists(p) for p in paths):
                firsts = [read_png(p) for p in paths]
            else:
                lat0 = draw_latents(seed, (N, 4, res, res), device) * schedule.init_noise_sigma
                # rows are scale-major uncond (S·N) ++ cond (S·N), as sample_loop_scales reads them
                per_scale = [encode_case(prompt, s) for s in scales] if parts.has_te else [(emb, pooled)] * S
                emb_b = torch.cat([e[:N] for e, _ in per_scale] + [e[N:] for e, _ in per_scale])
                added = {"text_embeds": torch.cat([p[:N] for _, p in per_scale] + [p[N:] for _, p in per_scale]),
                         "time_ids": time_ids.expand(2 * S * N, -1)}
                final = sample_loop_scales(
                    unet, sites, lora_params, scales, flip, scheduler, schedule, lat0.repeat(S, 1, 1, 1).to(WEIGHT_DTYPE),
                    emb_b, guidance_scale=args.guidance_scale, added_cond_kwargs=added,
                )
                for si, scale in enumerate(scales):
                    images = latents_to_images(vae.decode, final[si * N:(si + 1) * N], vae.config.scaling_factor)
                    save_images(f"{root}/{scale}", case_number, images)
                    firsts.append(images[0])
                print(f"case {case_number}: saved {S * N} images (batched scales)")
        else:
            for scale in scales:
                out_path = f"{root}/{scale}/{case_number}_0.png"
                if os.path.exists(out_path):  # resume: keep the column for the composite
                    firsts.append(read_png(out_path))
                    continue
                if parts.has_te:
                    emb, pooled = encode_case(prompt, scale)
                added = {"text_embeds": pooled, "time_ids": time_ids.expand(2 * N, -1)}
                latents = draw_latents(seed, (N, 4, res, res), device) * schedule.init_noise_sigma
                merged = None  # free the previous scale's merged weights first
                merged = lora_lib.merge_lora_params(unet, sites, lora_params, scale)
                final = sample_loop(unet, merged, flip, scheduler, schedule, latents.to(WEIGHT_DTYPE), emb,
                                    guidance_scale=args.guidance_scale, added_cond_kwargs=added)
                images = latents_to_images(vae.decode, final, vae.config.scaling_factor)
                save_images(f"{root}/{scale}", case_number, images)
                firsts.append(images[0])
                print(f"case {case_number} scale {scale}: saved {images.shape[0]} images")
        if firsts:
            save_composite(root, case_number, firsts)


def build_parser():
    parser = argparse.ArgumentParser(prog="generateImages", description="Generate slider scale sweeps")
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--negative_prompts", type=str, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--base", type=str, default="stabilityai/stable-diffusion-xl-base-1.0")
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--start_noise", type=int, default=750)
    parser.add_argument("--scales", type=str, default="-2,-1,0,1,2")
    parser.add_argument("--batch_scales", action="store_true",
                        help="the whole scale grid as one batched trajectory through the per-row LoRA overlay")
    parser.add_argument("--quantize_base", action="store_true",
                        help="int8 UNet Linears (adapters/quant.py); requires --batch_scales")
    parser.add_argument("--w8a8", action="store_true",
                        help="per-token int8 activations on the int8 Linears, int8 x int8 matmuls "
                             "(implies --quantize_base)")
    parser.add_argument("--mesh_data", type=int, default=1, help="> 1 is not ported yet (ROADMAP.md queue 1, item 12)")
    parser.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
