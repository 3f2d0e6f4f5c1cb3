"""Train a concept slider, then render a scale sweep — the port's
counterpart of ``demos/demo_concept_sliders.py`` (the reference notebooks
``demo_concept_sliders.ipynb`` / ``XL-sliders-inference.ipynb``): train
through the programmatic API (``train/trainer.py::train``, fp32, 4
denoising steps), then sample the target prompt once per slider scale
(Euler-A, 4 steps, CFG 7.5, the slider merged in below ``--start_noise``)
into ``<out>/scale_<scale>.png``:

    python -m sliders_conceptmod_tpu_torch.demos.demo_concept_sliders --base tiny-xl --steps 8 \\
        --target person --positive "smiling person" --out out/slider_demo --device cpu

``--base`` is an SDXL family name (``tiny-xl`` runs on the CPU in seconds),
a diffusers directory or a single file; ``--device`` is ``cuda`` (the
default), a CUDA ordinal or ``cpu``. The initial latents and Euler-A's step
noise are torch draws from seed 0 (the JAX demo draws ``PRNGKey(0)``).
"""

from __future__ import annotations

import argparse
import os

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import draw_latents
from sliders_conceptmod_tpu_torch.core.config import (
    LoggingConfig,
    NetworkConfig,
    OtherConfig,
    PretrainedModelConfig,
    RootConfig,
    SaveConfig,
    TPUConfig,
    TrainConfig,
)
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.infer.generate import flip_step_for_start_noise, latents_to_images, sample_loop
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.train import trainer

SWEEP_STEPS = 4  # the demo's Euler-A steps


def step_noise(seed: int, steps: int, shape, device) -> torch.Tensor:
    """Euler-A's noise for every step of one trajectory ``[steps, *shape]``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((steps, *shape), generator=gen, device=device, dtype=torch.float32)


def xl_conditioning(text_encoders, prompt: str, resolution: int, device):
    """(uncond ++ cond embeddings, {pooled, add_time_ids}) of one prompt, CFG rows."""
    text, pool = factory.encode_prompts_xl(text_encoders, [prompt])
    text_u, pool_u = factory.encode_prompts_xl(text_encoders, [""])
    time_ids = torch.from_numpy(get_add_time_ids(resolution, resolution)).to(device)
    return torch.cat([text_u, text]), {"text_embeds": torch.cat([pool_u, pool]), "time_ids": time_ids.expand(2, -1)}


def run(args) -> dict:
    """Train, then sweep; returns the training result and the images by scale."""
    device = torch_device(args.device)
    config = RootConfig(
        prompts_file="",
        pretrained_model=PretrainedModelConfig(name_or_path=args.base),
        network=NetworkConfig(rank=4, alpha=1.0),
        train=TrainConfig(iterations=args.steps, max_denoising_steps=4, precision="float32"),
        save=SaveConfig(name="demo_slider", path=args.out, per_steps=0),
        logging=LoggingConfig(verbose=True),
        other=OtherConfig(),
        tpu=TPUConfig(),
    )
    prompts = [PromptSettings(target=args.target, positive=args.positive, unconditional=args.unconditional,
                              neutral=args.target, action="enhance", guidance_scale=3, resolution=args.resolution)]
    result = trainer.train(config, prompts, rank=4, save_file=False, device=device)
    print(f"trained: final loss {result.losses[-1]:.6f}, {result.steps_per_sec:.2f} steps/s")

    _, text_encoders, unet, scheduler, vae = factory.load_models_xl(
        args.base, weight_dtype=torch.float32, with_vae=True, device=device
    )
    schedule = scheduler.set_timesteps(SWEEP_STEPS)
    flip = flip_step_for_start_noise(schedule, args.start_noise)
    emb, added = xl_conditioning(text_encoders, args.target, args.resolution, device)
    os.makedirs(args.out, exist_ok=True)
    shape = (1, 4, args.resolution // 8, args.resolution // 8)
    images = {}
    for scale in [float(s) for s in args.scales.split(",")]:
        latents = draw_latents(0, shape, device) * schedule.init_noise_sigma
        merged = None  # free the previous scale's merged weights first
        merged = lora_lib.merge_lora_params(unet, result.sites, result.lora_params, scale)
        final = sample_loop(unet, merged, flip, scheduler, schedule, latents, emb, guidance_scale=7.5,
                            added_cond_kwargs=added, step_noise=step_noise(0, SWEEP_STEPS, shape, device))
        images[scale] = latents_to_images(vae.decode, final, vae.config.scaling_factor)[0]
        with open(f"{args.out}/scale_{scale}.png", "wb") as f:
            f.write(encode_png(images[scale]))
        print(f"scale {scale}: saved {args.out}/scale_{scale}.png")
    return {"result": result, "images": images}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="tiny-xl")
    ap.add_argument("--target", default="person")
    ap.add_argument("--positive", default="smiling person")
    ap.add_argument("--unconditional", default="person")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--scales", default="-2,-1,0,1,2")
    ap.add_argument("--start_noise", type=int, default=750)
    ap.add_argument("--out", default="/tmp/slider_demo")
    ap.add_argument("--device", default="cuda", help="cuda (default), a CUDA ordinal, or cpu")
    return ap


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
