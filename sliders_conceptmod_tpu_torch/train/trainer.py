"""Textual-slider trainer — counterpart of ``sliders_conceptmod_tpu/train/trainer.py``
for SD1/SD2 and SDXL.

Flow (reference ``conceptmod/textsliders/train_lora_xl.py:41-394`` and
``train_lora.py``): load the models on the device at ``train.precision`` →
LoRA sites and factors → encode and stack the 5 prompts per pair, then free
the text towers → one ESD step per iteration (``train/esd.py``) → periodic
and final ``.safetensors`` saves in the reference key schema at
``save.precision``, a resume checkpoint beside each periodic save, and the
metrics jsonl.

``models/factory.py::load_for_training`` picks the family (SDXL when the
model name contains "xl", else SD1/SD2). SDXL conditions on both towers'
penultimate states, the pooled embedding and the ``add_time_ids``; SD1/SD2
on the one tower's ``clip_skip`` state alone. Only
the XL branch clips the gradient norm (0.2), and only it keeps the XL
reference quirk: with ``tpu.honor_network_config: false`` the optimizer is
the reference's hardcoded AdamW (lr 1e-4, weight decay 1e-6, cosine over 50
steps to 1e-6), whatever ``train.*`` says.

The adapter is LoRA or DoRA (``peft_type``; ``adapters/dora.py``, its
``dora_scale`` initialised from the base weights and trained with the
factors). The slider's route resolves as in JAX
(``core/config.py::resolve_student_overlay`` with ``default_overlay`` =
LoRA): an unset ``tpu:`` block over LoRA is the overlay student with the
merged warm-up; DoRA and ``tpu.student_overlay: false`` merge the student
too. Knobs of the JAX trainer that this port does not carry yet raise
``NotImplementedError`` naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import torch

from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.core.config import (
    RootConfig,
    parse_precision,
    parse_save_precision,
    resolve_student_overlay,
)
from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import esd
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer

_QUEUE1 = "ROADMAP.md queue 1"


def _uniform_field(prompts: List[PromptSettings], field: str):
    vals = {getattr(p, field) for p in prompts}
    if len(vals) > 1:
        raise NotImplementedError(f"All prompt pairs must share one {field} per run (got {vals})")
    return vals.pop()


def check_supported(config: RootConfig, prompts: List[PromptSettings], peft_type: str) -> None:
    """Refuse what the port does not carry yet, naming where it is queued."""
    tpu = config.tpu
    if peft_type not in ("lora", "dora"):
        raise ValueError(f"peft_type must be 'lora' or 'dora', got {peft_type!r}")
    if tpu.samples_per_step > 1:
        raise NotImplementedError(f"tpu.samples_per_step > 1 is not ported yet ({_QUEUE1}, ESD knobs)")
    for knob in ("pipeline_warmup", "share_warmup", "fuse_teacher_student"):
        if getattr(tpu, knob):
            raise NotImplementedError(f"tpu.{knob} is not ported yet ({_QUEUE1}, ESD knobs)")
    if tpu.quantize_base or tpu.w8a8_warmup:
        raise NotImplementedError(f"tpu.quantize_base / tpu.w8a8_warmup are not ported yet ({_QUEUE1}, int8 / W8A8)")
    if tpu.mesh_model != 1 or tpu.mesh_data not in (-1, 1) or (tpu.num_processes or 1) > 1 or tpu.sequence_parallel:
        raise NotImplementedError(f"meshes and multi-process worlds are not ported yet ({_QUEUE1}, parallelism)")
    if tpu.profile_dir:
        raise NotImplementedError(f"tpu.profile_dir (a trace of the run) is not ported yet ({_QUEUE1})")
    if any(p.dynamic_resolution for p in prompts):
        raise NotImplementedError(f"dynamic_resolution is not ported yet ({_QUEUE1}, ESD knobs)")
    if any(p.dynamic_crops for p in prompts):
        raise NotImplementedError(f"dynamic_crops is not ported yet ({_QUEUE1}, ESD knobs)")


@dataclass
class TrainResult:
    sites: list
    lora_params: dict
    losses: List[float]
    steps_per_sec: float  # over the steps after the first
    metrics: List[dict] = field(default_factory=list)  # the jsonl rows
    setup_seconds: float = float("nan")  # models, sites, prompt bank: entry to the first step
    first_step_seconds: float = float("nan")  # the first step, finished on the device
    bank_seconds: float = float("nan")  # the image-pair trainer's VAE-encoded image bank
    # one more step on the trained state (for a profile or a benchmark)
    next_step: Optional[Callable[[], dict]] = None


def train(
    config: RootConfig,
    prompts: List[PromptSettings],
    rank: int = 4,
    peft_type: str = "lora",
    on_step_complete: Optional[Callable[[int], None]] = None,
    save_file: bool = True,
    resume_from: Optional[str] = None,
    device: str = "cuda",
) -> TrainResult:
    """Train one slider. Runs on ``cuda`` unless ``device="cpu"``."""
    t_entry = time.time()
    tpu_cfg = config.tpu
    check_supported(config, prompts, peft_type)
    # the int8 base is refused above (not ported), so quantize_base is False here
    student_overlay, overlay_warmup = resolve_student_overlay(tpu_cfg, False, peft_type,
                                                              default_overlay=(peft_type == "lora"))
    device = torch.device(device)
    weight_dtype = parse_precision(config.train.precision)
    save_dtype = parse_save_precision(config.save.precision)
    save_path = Path(config.save.path)
    metadata = {
        "prompts": json.dumps([p.model_dump() for p in prompts]),
        "config": config.model_dump_json(),
    }

    # --- models -----------------------------------------------------------
    models = factory.load_for_training(config.pretrained_model, config.train.noise_scheduler, weight_dtype,
                                       device=str(device))
    unet, scheduler, is_xl = models.unet, models.scheduler, models.is_xl

    # --- adapter ----------------------------------------------------------
    target_replace = ["Attention"]
    if config.network.type == "c3lier":
        target_replace = lora_lib.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + lora_lib.UNET_TARGET_REPLACE_MODULE_CONV
    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    sites = peft_mod.create_sites(
        unet, rank=rank, alpha=config.network.alpha, target_replace=target_replace,
        train_method=config.network.training_method,
    )
    init_gen = torch.Generator().manual_seed(tpu_cfg.seed)
    if peft_type == "dora":  # dora_scale = the column norms of the base weights
        lora_params = dora_lib.init_lora_params(sites, unet, generator=init_gen)
    else:
        lora_params = lora_lib.init_lora_params(sites, generator=init_gen)
    for leaf in lora_params.values():
        for k in leaf:
            leaf[k] = leaf[k].to(device).requires_grad_(True)

    # --- optimizer --------------------------------------------------------
    iterations = config.train.iterations
    if is_xl and not tpu_cfg.honor_network_config:
        # reference hardcoded values, train_lora_xl.py:104-105,349
        optimizer = get_optimizer("adamw", get_lr_schedule("cosine", 1e-4, 50, 1e-6), weight_decay=1e-6,
                                  grad_clip_norm=0.2)
    else:
        sched = get_lr_schedule(config.train.lr_scheduler, config.train.lr, iterations, config.train.eta_min)
        optimizer = get_optimizer(config.train.optimizer, sched, config.train.optimizer_args,
                                  grad_clip_norm=0.2 if is_xl else None)

    # --- prompt bank, then the text towers are freed ----------------------
    bank = esd.build_prompt_bank(prompts, models.encode)
    models.encode = None  # the closure holds the towers
    if device.type == "cuda":
        torch.cuda.empty_cache()

    resolution = _uniform_field(prompts, "resolution")
    batch_size = _uniform_field(prompts, "batch_size")
    schedule = scheduler.set_timesteps(config.train.max_denoising_steps)
    ecfg = esd.ESDConfig(
        max_denoising_steps=config.train.max_denoising_steps,
        train_cfg_scale=config.train.cfg,
        batch_size=batch_size,
        height=resolution,
        width=resolution,
        student_overlay=student_overlay,
        overlay_warmup=overlay_warmup,
    )
    step_fn = esd.make_esd_train_step(unet, sites, lora_params, scheduler, schedule, optimizer, ecfg,
                                      add_time_ids=models.add_time_ids(resolution, device),
                                      merge_fn=peft_mod.merge_lora_params, debug_nans=tpu_cfg.debug_nans)
    opt_state = optimizer.init(flat_params(sites, lora_params))
    rng = esd.TrainRNG(tpu_cfg.seed, device)
    start_step = ckpt.maybe_restore(resume_from, lora_params, opt_state, rng)

    save_path.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(save_path, config.save.name, verbose=config.logging.verbose)

    if config.logging.use_wandb:
        print("wandb is not part of the port: metrics go to the jsonl only")

    # --- loop -------------------------------------------------------------
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
            peft_mod.save_weights(save_path / f"{config.save.name}_{i}steps.safetensors", sites, lora_params,
                                  dtype=save_dtype, metadata=metadata)
            ckpt.save_resume(save_path, config.save.name, lora_params, opt_state, i + 1, rng)
        if on_step_complete is not None:
            on_step_complete(i)

    sps = logger.close()
    if save_file:
        peft_mod.save_weights(save_path / f"{config.save.name}_last.safetensors", sites, lora_params,
                              dtype=save_dtype, metadata=metadata)
    return TrainResult(
        sites=sites, lora_params=lora_params, losses=logger.losses, steps_per_sec=sps, metrics=logger.rows,
        setup_seconds=t_loop - t_entry, first_step_seconds=first_step_seconds,
        next_step=lambda: step_fn(opt_state, bank, rng),
    )
