"""CLI: image-pair ("visual") slider training — counterpart of
``sliders_conceptmod_tpu/cli/train_lora_scale.py`` (reference
``trainscripts/imagesliders/train_lora-scale.py:376-419`` flag surface,
256px for SD1/SD2, and the 512px XL variant ``train_lora-scale-xl.py`` when
the model name contains "xl"):

  python -m sliders_conceptmod_tpu_torch.cli.train_lora_scale \\
      --config_file data/config-xl.yaml --alpha 1 --rank 4 \\
      --folder_main imgs --folders low2,low1,high1,high2 --scales=-2,-1,1,2

``--folders`` and ``--scales`` are comma-separated and index-matched: folder
i holds the renders for slider value scales[i]; pairs are (−s, +s) with the
same file name. A value that starts with "-" is given as ``--scales=...``
(argparse reads ``--scales -2,...`` as another option). ``--device`` picks the torch device (default ``cuda``;
``cpu`` runs the kernels' plain versions, for tiny configs).

Flow: models at ``train.precision`` with the VAE → the positive and neutral
prompt embeddings (SD1/SD2: the ``clip_skip`` state; XL: both towers'
penultimate states and the pooled embeddings; then the text towers are
freed) → LoRA sites and factors
→ the image bank (one VAE encode per folder; then the VAE is freed) → one
``train/imageslider.py`` step per iteration → periodic and final
``.safetensors`` saves in the reference key schema, a resume checkpoint
beside each periodic save, and the metrics jsonl. As in the JAX CLI the
optimizer is ``train.optimizer`` over ``train.lr_scheduler``, with no
gradient clip.

The student's route resolves as in the JAX CLI
(``core/config.py::resolve_student_overlay`` with ``default_overlay=True``):
unset or ``tpu.student_overlay: true`` is the 2-row overlay student,
``false`` the reference's two merged ±scale students. The JAX CLI's
refusals are kept (``tpu.quantize_base``, ``tpu.w8a8_warmup``,
``tpu.overlay_warmup: true``).
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.cli.train_lora_xl import _decorate
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import imageslider
from sliders_conceptmod_tpu_torch.train.esd import TrainRNG
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer
from sliders_conceptmod_tpu_torch.train.trainer import TrainResult

XL_RESOLUTION = 512  # reference train_lora-scale-xl.py:220
SD_RESOLUTION = 256  # reference train_lora-scale.py:219


def resolve_student(config) -> bool:
    """The JAX CLI's refusals and its route rule: whether the student runs
    through the overlay (else the merged ±scale students)."""
    tpu = config.tpu
    if tpu.quantize_base or tpu.w8a8_warmup:
        raise NotImplementedError(
            "tpu.quantize_base / tpu.w8a8_warmup are supported by the text-slider trainers only; the image-pair "
            "trainer takes the bf16 base — set quantize_base: false")
    student_overlay, overlay_warmup = config_util.resolve_student_overlay(tpu, False, "lora", default_overlay=True)
    if overlay_warmup:
        raise NotImplementedError(
            "tpu.overlay_warmup: true — the image-pair trainer has no warm-up chain (latents come from noised VAE "
            "posteriors); leave it unset")
    return student_overlay


def train(config, prompts, folder_main: str, folders, scales, rank: int = 4, save_file: bool = True,
          resume_from=None, device: str = "cuda") -> TrainResult:
    """Train one image-pair slider. Runs on ``cuda`` unless ``device="cpu"``."""
    t_entry = time.time()
    student_overlay = resolve_student(config)
    scales, folders = list(scales), list(folders)
    if len(folders) != len(scales):
        raise ValueError("--folders and --scales must be index-matched")
    device = torch.device(device)
    weight_dtype = config_util.parse_precision(config.train.precision)
    save_dtype = config_util.parse_save_precision(config.save.precision)
    save_path = Path(config.save.path)
    settings = prompts[0]

    # --- models, then the two prompt embeddings; the text towers are freed -
    models = factory.load_for_training(config.pretrained_model, config.train.noise_scheduler, weight_dtype,
                                       with_vae=True, device=str(device))
    unet, scheduler, vae = models.unet, models.scheduler, models.vae
    resolution = XL_RESOLUTION if models.is_xl else SD_RESOLUTION
    emb, pooled = {}, {}
    for role, prompt in (("positive", settings.positive), ("neutral", settings.neutral)):
        text, pool = models.encode(prompt)
        with torch.inference_mode(False):  # they enter the student's graph (cross-attention sites)
            emb[role] = text.clone()
            if pool is not None:
                pooled[role] = pool.clone()
    models.encode = models.vae = None

    # --- adapter and optimizer --------------------------------------------
    target_replace = list(lora_lib.UNET_TARGET_REPLACE_MODULE_TRANSFORMER)
    if config.network.type == "c3lier":
        target_replace += lora_lib.UNET_TARGET_REPLACE_MODULE_CONV
    sites = lora_lib.create_sites(unet, rank=rank, alpha=config.network.alpha, target_replace=target_replace,
                                  train_method=config.network.training_method)
    lora_params = lora_lib.init_lora_params(sites, generator=torch.Generator().manual_seed(config.tpu.seed))
    for leaf in lora_params.values():
        for k in leaf:
            leaf[k] = leaf[k].to(device).requires_grad_(True)
    sched_fn = get_lr_schedule(config.train.lr_scheduler, config.train.lr, config.train.iterations,
                               config.train.eta_min)
    optimizer = get_optimizer(config.train.optimizer, sched_fn, config.train.optimizer_args)

    # --- the image bank, then the VAE is freed ----------------------------
    t_bank = time.time()
    bank = imageslider.build_image_bank(folder_main, folders, [float(s) for s in scales], vae.encode,
                                        resolution, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    bank_seconds = time.time() - t_bank
    icfg = imageslider.ImageSliderConfig(max_denoising_steps=config.train.max_denoising_steps,
                                         scaling_factor=vae.config.scaling_factor)
    del vae
    if device.type == "cuda":
        torch.cuda.empty_cache()

    schedule = scheduler.set_timesteps(config.train.max_denoising_steps)
    step_fn = imageslider.make_image_slider_step(unet, sites, lora_params, scheduler, schedule, optimizer, icfg,
                                                 emb["positive"], emb["neutral"], pooled=pooled or None,
                                                 add_time_ids=models.add_time_ids(resolution, device),
                                                 student_overlay=student_overlay,
                                                 debug_nans=config.tpu.debug_nans)
    opt_state = optimizer.init(flat_params(sites, lora_params))
    rng = TrainRNG(config.tpu.seed, device)
    start_step = ckpt.maybe_restore(resume_from, lora_params, opt_state, rng)
    logger = MetricsLogger(save_path, config.save.name, verbose=config.logging.verbose)

    # --- loop -------------------------------------------------------------
    iterations = config.train.iterations
    t_loop = time.time()
    first_step_seconds = float("nan")
    for i in range(start_step, iterations):
        try:
            metrics = step_fn(opt_state, bank, rng)
        except FloatingPointError as e:  # tpu.debug_nans: stop at the first non-finite step, as JAX does
            raise FloatingPointError(f"step {i}: {e}") from None
        logger.log(i, metrics)  # waits for the first step to finish on the device
        if i == start_step:
            first_step_seconds = time.time() - t_loop
        if save_file and config.save.per_steps and i % config.save.per_steps == 0 and i not in (0, iterations - 1):
            lora_lib.save_weights(save_path / f"{config.save.name}_{i}steps.safetensors", sites, lora_params,
                                  dtype=save_dtype)
            ckpt.save_resume(save_path, config.save.name, lora_params, opt_state, i + 1, rng)

    sps = logger.close()
    if save_file:
        lora_lib.save_weights(save_path / f"{config.save.name}_last.safetensors", sites, lora_params,
                              dtype=save_dtype)
    return TrainResult(
        sites=sites, lora_params=lora_params, losses=logger.losses, steps_per_sec=sps, metrics=logger.rows,
        setup_seconds=t_loop - t_entry, first_step_seconds=first_step_seconds, bank_seconds=bank_seconds,
        next_step=lambda: step_fn(opt_state, bank, rng),
    )


def main(args):
    config = config_util.load_config_from_yaml(args.config_file)
    if args.name is not None:
        config.save.name = args.name
    attributes = [a.strip() for a in args.attributes.split(",")] if args.attributes is not None else []
    _decorate(config, args.alpha, args.rank)
    prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, attributes)
    folders = [f.strip() for f in args.folders.split(",")]
    scales = [float(s) for s in args.scales.split(",")]
    if args.stylecheck is None:
        return train(config, prompts, args.folder_main, folders, scales, rank=args.rank,
                     resume_from=args.resume_from, device=args.device)
    # batch mode "a-b": one slider per numbered folder_main{i} (reference train_lora-scale.py:408-417)
    lo, hi = (int(x) for x in args.stylecheck.split("-"))
    results = []
    for i in range(lo, hi):
        folder_main = args.folder_main + f"{i}"
        config.save.name = f"{os.path.basename(folder_main)}_alpha{args.alpha}_rank{args.rank}"
        config.save.path = f"models/{config.save.name}"
        results.append(train(config, prompts, folder_main, folders, scales, rank=args.rank, device=args.device))
    return results


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, cuda:1, or cpu for tiny configs).")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--attributes", type=str, default=None)
    parser.add_argument("--folder_main", type=str, required=True)
    parser.add_argument("--stylecheck", type=str, default=None, help='"a-b" batch range')
    parser.add_argument("--folders", type=str, required=True)
    parser.add_argument("--scales", type=str, required=True)
    parser.add_argument("--resume_from", type=str, default=None,
                        help="resume checkpoint ({name}_resume.pt next to the saves, or its directory): restores "
                             "the factors, optimizer state, step and generators")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
