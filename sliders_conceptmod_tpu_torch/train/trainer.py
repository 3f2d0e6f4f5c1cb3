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
too. Every optimizer and schedule of the JAX package trains
(``train/optim.py``).

The JAX trainer's ``tpu:`` knobs: ``samples_per_step``,
``fuse_teacher_student``, ``pipeline_warmup`` and ``share_warmup`` go to the
ESD step (``train/esd.py``, with JAX's refusals of invalid combinations);
``dynamic_resolution`` builds one step per resolution bucket and picks one
per iteration (``loop_utils.resolution_bucket_picker``); ``dynamic_crops``
(XL) redraws the crop conditioning per iteration; ``profile_dir`` writes a
``torch.profiler`` Chrome trace of the loop. Above 512px the student runs
under ``torch.utils.checkpoint``.

The int8 base (JAX's rules and messages): ``tpu.quantize_base`` loads the
UNet's large Linears as int8 (``adapters/quant.py``) and forces the overlay
student and warm-up (an int8 base cannot host a merge); DoRA with it raises.
``tpu.w8a8_warmup`` runs the warm-up alone with W8A8 — over the int8 base,
or, without ``quantize_base``, over an int8 copy of the full-precision base
quantized once after the text towers are freed (the dual tree: it shares
every tensor it does not quantize with the base); the dual tree needs LoRA
and the overlay student and warm-up. Meshes and multi-process worlds are not
ported yet: they raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, List, Optional

import torch

from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.core.config import (
    RootConfig,
    parse_precision,
    parse_save_precision,
    resolve_student_overlay,
)
from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import esd
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger, resolution_bucket_picker
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer
from sliders_conceptmod_tpu_torch.utils.debug import apply_tpu_runtime_flags

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
    if tpu.mesh_model != 1 or tpu.mesh_data not in (-1, 1) or (tpu.num_processes or 1) > 1 or tpu.sequence_parallel:
        raise NotImplementedError(
            f"meshes and multi-process worlds are not ported yet ({_QUEUE1}, item 12: parallelism)")


def resolve_int8_routes(tpu_cfg, peft_type: str):
    """``(student_overlay, overlay_warmup, quantize_base)``: the
    slider's route (``resolve_student_overlay``) under the int8 knobs, with
    the JAX trainer's refusals and messages."""
    quantize_base = bool(tpu_cfg.quantize_base)
    if quantize_base and peft_type == "dora":
        raise NotImplementedError(
            "tpu.quantize_base requires full-precision base magnitudes for "
            "DoRA's norm decomposition — use peft_type='lora' or "
            "quantize_base: false."
        )
    dual_tree = bool(tpu_cfg.w8a8_warmup) and not quantize_base
    if dual_tree and peft_type != "lora":
        raise NotImplementedError(
            "tpu.w8a8_warmup without quantize_base (dual-tree) rides the LoRA "
            "overlay on the int8 warm-up copy — DoRA merges; use peft_type='lora'."
        )
    student_overlay, overlay_warmup = resolve_student_overlay(tpu_cfg, quantize_base, peft_type,
                                                              default_overlay=(peft_type == "lora"))
    if dual_tree:
        if not student_overlay:
            raise ValueError(
                "tpu.w8a8_warmup with a bf16 base needs tpu.student_overlay "
                "(the int8 warm-up copy rides the apply-time LoRA overlay)"
            )
        if tpu_cfg.overlay_warmup is False:
            raise ValueError(
                "tpu.overlay_warmup: false is incompatible with the dual-tree "
                "w8a8_warmup — the int8 warm-up copy cannot host a merged tree"
            )
        overlay_warmup = True
    return student_overlay, overlay_warmup, quantize_base


@contextmanager
def profiled(profile_dir: Optional[str], name: str, device: torch.device) -> Iterator[None]:
    """``tpu.profile_dir``: ``torch.profiler`` (CPU, and CUDA on the card)
    around the block — the training loop, as JAX's ``start_trace`` /
    ``stop_trace`` frame it — written as a Chrome trace
    ``{profile_dir}/{name}_trace.json``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / f"{name}_trace.json"))


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
    apply_tpu_runtime_flags(config.tpu)
    tpu_cfg = config.tpu
    check_supported(config, prompts, peft_type)
    student_overlay, overlay_warmup, quantize_base = resolve_int8_routes(tpu_cfg, peft_type)
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
                                       device=str(device), quantize_base=quantize_base)
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
    # tpu.w8a8_warmup: the warm-up's own UNet, made after the towers are freed
    warm_unet = quant.quantized_copy(unet, act_quant=True) if tpu_cfg.w8a8_warmup else None

    resolution = _uniform_field(prompts, "resolution")
    batch_size = _uniform_field(prompts, "batch_size")
    dynamic_crops = _uniform_field(prompts, "dynamic_crops")
    dynamic_resolution = _uniform_field(prompts, "dynamic_resolution")
    if tpu_cfg.pipeline_warmup and dynamic_resolution:
        raise ValueError("tpu.pipeline_warmup carries the warm-up state across steps at one fixed shape — "
                         "incompatible with dynamic_resolution buckets")
    schedule = scheduler.set_timesteps(config.train.max_denoising_steps)

    def build_step(height: int, width: int) -> esd.ESDStep:
        ecfg = esd.ESDConfig(
            max_denoising_steps=config.train.max_denoising_steps,
            train_cfg_scale=config.train.cfg,
            batch_size=batch_size,
            height=height,
            width=width,
            student_overlay=student_overlay,
            overlay_warmup=overlay_warmup,
            samples_per_step=max(tpu_cfg.samples_per_step, 1),
            fuse_teacher_student=tpu_cfg.fuse_teacher_student,
            dynamic_crops=bool(dynamic_crops) and is_xl,
            pipeline_warmup=tpu_cfg.pipeline_warmup,
            share_warmup=tpu_cfg.share_warmup,
            # the student under torch.utils.checkpoint above 512px, as the JAX trainer sets remat_unet
        )
        add_time_ids = torch.from_numpy(get_add_time_ids(height, width)).to(device) if is_xl else None
        return esd.make_esd_train_step(unet, sites, lora_params, scheduler, schedule, optimizer, ecfg,
                                       add_time_ids=add_time_ids, merge_fn=peft_mod.merge_lora_params,
                                       debug_nans=tpu_cfg.debug_nans, warm_unet=warm_unet)

    # one step per resolution bucket, a bucket per iteration (dynamic_resolution)
    buckets, pick_bucket = resolution_bucket_picker(dynamic_resolution, resolution, tpu_cfg.seed)
    step_fns = [build_step(h, w) for h, w in buckets]
    opt_state = optimizer.init(flat_params(sites, lora_params))
    rng = esd.TrainRNG(tpu_cfg.seed, device)
    start_step = ckpt.maybe_restore(resume_from, lora_params, opt_state, rng)
    if tpu_cfg.pipeline_warmup:
        # a resumed run re-draws the carry (it is not checkpointed), as the JAX trainer does
        step_fns[0].init_carry(bank, rng)

    save_path.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(save_path, config.save.name, verbose=config.logging.verbose)

    if config.logging.use_wandb:
        print("wandb is not part of the port: metrics go to the jsonl only")

    # --- loop -------------------------------------------------------------
    t_loop = time.time()
    first_step_seconds = float("nan")
    with profiled(tpu_cfg.profile_dir, config.save.name, device):
        for i in range(start_step, iterations):
            bi = pick_bucket(i) if pick_bucket is not None else 0
            try:
                metrics = step_fns[bi](opt_state, bank, rng)
            except FloatingPointError as e:  # tpu.debug_nans: stop at the first non-finite step, as JAX does
                raise FloatingPointError(f"step {i}: {e}") from None
            if pick_bucket is not None:
                metrics = dict(metrics, height=buckets[bi][0], width=buckets[bi][1])
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
        next_step=lambda: step_fns[0](opt_state, bank, rng),
    )
