"""CLI: Stable Cascade (Stage-C prior) textual slider training — counterpart
of ``sliders_conceptmod_tpu/cli/train_lora_cascade.py`` (reference
``conceptmod/textsliders/train_lora_cascade.py``), plus the ``train_lora``
programmatic API.

  python -m sliders_conceptmod_tpu_torch.cli.train_lora_cascade \\
      --config_file data/config-cascade.yaml --alpha 1 --rank 4

The JAX trainer's Cascade specifics: the prior and CLIP-G from
``models/factory.py::load_models_cascade`` (``noise_scheduler: wuerstchen``
selects the ratio-space scheduler, any other name a beta scheduler), the
text embedding the last hidden state before the final LayerNorm and the
pooled one projected; LoRA over the attention modules (``c3lier`` adds the
conv classes, which match nothing in the prior, so it trains the same 256
sites at the prior's depth under ``full``); the ESD step of
``train/esd_cascade.py``. The reference's quirks are kept: the config's
optimizer and lr, lr_min = lr / 100, no gradient clipping, saves as
torch-pickle ``.pt``. The student runs each layer under
``torch.utils.checkpoint`` unless the model is the tiny family.

``tpu:`` knobs: ``samples_per_step``, ``share_warmup``, ``student_overlay``
(the merged student is the default), ``w8a8_warmup`` (the dual-tree int8
warm-up, LoRA only), ``debug_nans``, ``profile_dir``; the prompts'
``dynamic_resolution`` picks a bucket per iteration. Refused with JAX's
words: ``quantize_base``, ``w8a8_warmup`` with DoRA, ``overlay_warmup:
true``. Meshes as ``train/trainer.py`` takes them (``parallel/mesh.py``:
DP over ``samples_per_step``, ``mesh_model`` tensor-shards the prior).
``--resume_from`` continues a run bit for bit; saves
are ``{name}_{i}steps.pt`` (with a resume checkpoint beside it) and
``{name}_last.pt`` in ``save.precision``. ``--device`` picks the torch
device (default ``cuda``; a bare integer is a CUDA ordinal; ``cpu`` for the
tiny config).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import esd, esd_cascade
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger, resolution_bucket_picker
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer
from sliders_conceptmod_tpu_torch.train.trainer import TrainResult, check_supported, mesh_step_start, profiled
from sliders_conceptmod_tpu_torch.utils.debug import apply_tpu_runtime_flags


def refuse_unsupported(tpu_cfg, peft_type: str):
    """The JAX trainer's refusals, in its order and words; returns the
    ``(student_overlay, w8a8_warmup)`` route."""
    if tpu_cfg.quantize_base:
        raise NotImplementedError(
            "tpu.quantize_base is supported by the text-slider trainers "
            "(train_lora/_xl/_sd3/_flux); the cascade teacher/student merge "
            "into the bf16 base (no HBM-fit need at 12x12 effnet latents) — "
            "set quantize_base: false. The warm-up perf lever here is "
            "tpu.w8a8_warmup (dual-tree int8 warm-up chain)."
        )
    w8a8_warmup = bool(tpu_cfg.w8a8_warmup)
    if w8a8_warmup and peft_type != "lora":
        raise NotImplementedError(
            "tpu.w8a8_warmup rides the LoRA overlay on the int8 warm-up copy "
            "— DoRA merges; use peft_type='lora'."
        )
    student_overlay, overlay_warmup = config_util.resolve_student_overlay(tpu_cfg, False, peft_type)
    if overlay_warmup:
        raise NotImplementedError(
            "tpu.overlay_warmup: true — the cascade bf16 warm-up always runs "
            "the merged tree; the overlay warm-up exists only as part of "
            "tpu.w8a8_warmup's dual-tree route. Leave it unset."
        )
    return student_overlay, w8a8_warmup


def train(config, prompts, rank: int = 4, peft_type: str = "lora", save_file: bool = True, on_step_complete=None,
          resume_from=None, device: str = "cuda") -> TrainResult:
    """Train one Stable Cascade slider. Runs on ``cuda`` unless
    ``device="cpu"``."""
    t_entry = time.time()
    apply_tpu_runtime_flags(config.tpu)
    tpu_cfg = config.tpu
    student_overlay, w8a8_warmup = refuse_unsupported(tpu_cfg, peft_type)
    check_supported(config, prompts, peft_type)
    samples_per_step = max(tpu_cfg.samples_per_step, 1)
    # joins the yaml world when configured; None on one rank (the one-process step)
    mesh = mesh_lib.training_mesh_from_config(tpu_cfg, samples_per_step, torch_device(device))
    if mesh is not None and not mesh.member:  # a shrunk data axis: this rank idles
        mesh_step_start(mesh)
        return None
    device = mesh_lib.local_device(torch_device(device))
    writer = mesh_lib.is_writer()
    weight_dtype = config_util.parse_precision(config.train.precision)
    save_dtype = config_util.parse_save_precision(config.save.precision)
    save_path = Path(config.save.path)
    name = config.pretrained_model.name_or_path

    _, te, prior, scheduler = factory.load_models_cascade(name, scheduler_name=config.train.noise_scheduler,
                                                          weight_dtype=weight_dtype, device=str(device))
    prior_cfg = prior.config
    is_tiny = "tiny" in str(name).lower()

    def encode(prompt: str):
        text, pooled = factory.encode_prompts_cascade(te, [prompt])
        if is_tiny:  # the tiny tower into the tiny prior's conditioning widths
            text = text[..., : prior_cfg.clip_text_in_channels]
            pooled = pooled[..., : prior_cfg.clip_text_pooled_in_channels]
        return text[0], pooled[0]

    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    # reference: DEFAULT_TARGET_REPLACE, plus the conv classes under c3lier (none inside the prior)
    target_replace = list(lora_lib.DEFAULT_TARGET_REPLACE)
    if config.network.type == "c3lier":
        target_replace += lora_lib.UNET_TARGET_REPLACE_MODULE_CONV
    sites = peft_mod.create_sites(prior, rank=rank, alpha=config.network.alpha, target_replace=target_replace,
                                  train_method=config.network.training_method)
    init_gen = torch.Generator().manual_seed(tpu_cfg.seed)
    if peft_type == "dora":
        lora_params = dora_lib.init_lora_params(sites, prior, generator=init_gen)
    else:
        lora_params = lora_lib.init_lora_params(sites, generator=init_gen)
    for leaf in lora_params.values():
        for k in leaf:
            leaf[k] = leaf[k].to(device).requires_grad_(True)

    # the reference honours the config here: its optimizer and lr, lr_min = lr / 100, no clipping
    sched_fn = get_lr_schedule(config.train.lr_scheduler, config.train.lr, config.train.iterations,
                               config.train.lr / 100)
    optimizer = get_optimizer(config.train.optimizer, sched_fn, config.train.optimizer_args)
    opt_state = optimizer.init(flat_params(sites, lora_params))

    bank = esd.build_prompt_bank(prompts, encode)
    with torch.inference_mode(False):
        empty_text, empty_pooled = (t.clone() for t in encode(""))
    del encode, te  # the tower goes before the (dual-tree) int8 copy
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if mesh is not None:  # the prior tensor-sharded when mesh_model > 1; the rest replicates
        mesh_lib.place_training_state(mesh, prior, lora_params, opt_state, bank, tp=mesh.model > 1)
        if w8a8_warmup and mesh.model > 1:
            raise NotImplementedError(
                "dual-tree w8a8_warmup + tensor parallelism: the int8 "
                "warm-up copy is not TP-sharded — use mesh_model: 1."
            )
    warm = quant.quantized_copy(prior, act_quant=True) if w8a8_warmup else None

    resolution, batch_size = prompts[0].resolution, prompts[0].batch_size
    dynamic_resolution = any(p.dynamic_resolution for p in prompts)
    schedule = scheduler.set_timesteps(config.train.max_denoising_steps)

    def build_step(height: int, width: int) -> esd_cascade.CascadeESDStep:
        ccfg = esd_cascade.CascadeESDConfig(
            max_denoising_steps=config.train.max_denoising_steps,
            batch_size=batch_size,
            height=height,
            width=width,
            latent_channels=prior_cfg.in_channels,
            resolution_multiple=prior_cfg.resolution_multiple,
            remat=not is_tiny,
            samples_per_step=samples_per_step,
            share_warmup=tpu_cfg.share_warmup,
            student_overlay=student_overlay,
            overlay_warmup=w8a8_warmup,
            mesh=mesh,
        )
        return esd_cascade.make_cascade_esd_train_step(
            prior, sites, lora_params, scheduler, schedule, optimizer, ccfg, empty_text=empty_text,
            empty_pooled=empty_pooled, clip_image_dim=prior_cfg.clip_image_in_channels,
            merge_fn=peft_mod.merge_lora_params, warm_prior=warm, debug_nans=tpu_cfg.debug_nans)

    buckets, pick_bucket = resolution_bucket_picker(dynamic_resolution, resolution, tpu_cfg.seed)
    step_fns = [build_step(h, w) for h, w in buckets]
    rng = esd.TrainRNG(tpu_cfg.seed, device)
    start_step = ckpt.maybe_restore(resume_from, lora_params, opt_state, rng)

    if writer:
        save_path.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(save_path, config.save.name, verbose=config.logging.verbose, write=writer)
    mesh_step_start(mesh)
    iterations = config.train.iterations
    t_loop = time.time()
    first_step_seconds = float("nan")
    with profiled(tpu_cfg.profile_dir, config.save.name, device):
        for i in range(start_step, iterations):
            bi = pick_bucket(i) if pick_bucket is not None else 0
            try:
                metrics = step_fns[bi](opt_state, bank, rng)
            except FloatingPointError as e:  # tpu.debug_nans
                raise FloatingPointError(f"step {i}: {e}") from None
            if pick_bucket is not None:
                metrics = dict(metrics, height=buckets[bi][0], width=buckets[bi][1])
            logger.log(i, metrics)
            if i == start_step:
                first_step_seconds = time.time() - t_loop
            if (save_file and writer and config.save.per_steps and i % config.save.per_steps == 0
                    and i not in (0, iterations - 1)):
                peft_mod.save_weights(save_path / f"{config.save.name}_{i}steps.pt", sites, lora_params,
                                      dtype=save_dtype)
                ckpt.save_resume(save_path, config.save.name, lora_params, opt_state, i + 1, rng)
            if on_step_complete is not None:
                on_step_complete(i)
        sps = logger.close()
    if save_file and writer:
        peft_mod.save_weights(save_path / f"{config.save.name}_last.pt", sites, lora_params, dtype=save_dtype)
    return TrainResult(sites=sites, lora_params=lora_params, losses=logger.losses, steps_per_sec=sps,
                       metrics=logger.rows, setup_seconds=t_loop - t_entry, first_step_seconds=first_step_seconds,
                       next_step=lambda: step_fns[0](opt_state, bank, rng))


def _decorate(config, alpha, rank):
    config.network.alpha = alpha
    config.network.rank = rank
    config.save.name += f"_alpha{alpha}_rank{rank}_{config.network.training_method}"
    config.save.path += f"/{config.save.name}"


def main(args):
    config = config_util.load_config_from_yaml(args.config_file)
    # a config that asks for more ranks than this process: run main in a spawned world of them
    if mesh_lib.spawn_for_config(config.tpu, config.tpu.samples_per_step, args.device, main, (args,)):
        return None
    if args.name is not None:
        config.save.name = args.name
    attributes = [a.strip() for a in args.attributes.split(",")] if args.attributes is not None else []
    _decorate(config, args.alpha, args.rank)
    prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, attributes)
    return train(config, prompts, rank=args.rank, peft_type=args.peft_type, resume_from=args.resume_from,
                 device=args.device)


def train_lora(target, positive, negative, unconditional, alpha=1.0, rank=4, device="cuda", name=None,
               attributes=None, batch_size=1, config_file="data/config-cascade.yaml", resolution=1024, steps=None,
               on_step_complete=None, peft_type="lora"):
    """Programmatic API (reference ``train_lora_cascade.py:383-421``): writes
    a prompts YAML next to the config (neutral = target, enhance, guidance
    4), trains, returns the state dict (numpy, reference schema)."""
    spec = {
        "target": target,
        "positive": positive,
        "negative": negative,
        "unconditional": unconditional,
        "neutral": target,
        "action": "enhance",
        "guidance_scale": 4,
        "resolution": resolution,
        "dynamic_resolution": False,
        "batch_size": batch_size,
    }
    prompts_path = os.path.join(os.path.dirname(config_file) or ".", "prompts-api.yaml")
    with open(prompts_path, "w") as f:
        f.write("- " + "\n  ".join(f"{k}: {json.dumps(v)}" for k, v in spec.items()) + "\n")
    config = config_util.load_config_from_yaml(config_file)
    config.prompts_file = prompts_path
    if name is not None:
        config.save.name = name
    if steps is not None:
        config.train.iterations = steps
    attr_list = [a.strip() for a in attributes.split(",")] if attributes else []
    _decorate(config, alpha, rank)
    prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, attr_list)
    result = train(config, prompts, rank=rank, peft_type=peft_type, save_file=False,
                   on_step_complete=on_step_complete, device=device)
    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    return peft_mod.state_dict_numpy(result.sites, result.lora_params)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--alpha", type=float, required=True)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, cuda:1, a bare CUDA ordinal, or cpu for tiny)")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--attributes", type=str, default=None)
    parser.add_argument("--peft_type", type=str, default="lora")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="resume checkpoint ({name}_resume.pt next to the saves, or its directory)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
