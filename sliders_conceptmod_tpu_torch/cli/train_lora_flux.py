"""CLI: Flux textual slider training (few-step flow matching) — counterpart of
``sliders_conceptmod_tpu/cli/train_lora_flux.py`` (reference
``conceptmod/textsliders/train_lora_flux.py``), plus the ``train_lora``
programmatic API.

  python -m sliders_conceptmod_tpu_torch.cli.train_lora_flux \\
      --config_file data/config-flux.yaml --alpha 1 --rank 4

The JAX trainer's Flux specifics: 8 flow steps with the dynamic shift μ from
the packed image's token count, ``timesteps_to`` fixed at 0, no CFG
(``train/esd_flux.py``); LoRA over target ``["Attention"]`` with
``-``-delimited keys (the dual-stream blocks' image q/k/v/out: 76 sites at
schnell's depth); a fixed optimizer whatever ``train.*`` says — AdamW (lr
cosine from 1e-4 over 50 optimizer steps to 1e-6, weight decay 1e-6), the
gradient clipped by value at 1.0 — under gradient accumulation to an
effective batch of 8 (``train/optim.py::MultiSteps``: ``ceil(8 /
(batch_size · samples_per_step))`` micro-steps per optimizer step, 1 when
that product is 8 or more). The loop runs ``iterations × k + 1`` micro-steps
(the reference's count); ``save.per_steps`` counts micro-steps, and
``on_step_complete`` fires per optimizer step with its number. The student
is the merged weights by default (the overlay with ``tpu.student_overlay``
or an int8 base) and runs each block under ``torch.utils.checkpoint``
unless the model is the tiny family.

``tpu:`` knobs: ``samples_per_step``, ``quantize_base`` (JAX's refusals:
``w8a8_warmup`` — Flux has no warm-up chain — and DoRA over int8),
``student_overlay``, ``debug_nans``; the prompts' ``dynamic_resolution``
picks a bucket per micro-step, μ from its token count. Meshes
(``parallel/mesh.py``, as ``train/trainer.py`` takes them): DP over
``samples_per_step``, ``mesh_model`` tensor-shards the transformer, and
``tpu.sequence_parallel`` runs the joint self-attention as ring attention
(``ops/attention.py::sequence_parallel_from_config``).
``--resume_from`` continues a run, mid-accumulation included, bit for bit;
saves are ``{name}_{i}steps`` (i a micro-step) and ``{name}_last
.safetensors`` in ``save.precision`` with a resume checkpoint beside each
periodic save. ``--device`` picks the torch device (default ``cuda``;
``cpu`` for tiny configs).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import torch

from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.diffusion.flow_match import calculate_shift
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.ops.attention import sequence_parallel_from_config
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import esd, esd_flux
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger, resolution_bucket_picker
from sliders_conceptmod_tpu_torch.train.optim import MultiSteps, flat_params, get_lr_schedule, get_optimizer
from sliders_conceptmod_tpu_torch.train.trainer import TrainResult, check_supported, mesh_step_start
from sliders_conceptmod_tpu_torch.utils.debug import apply_tpu_runtime_flags

N_STEPS = 8  # the reference's num_inference_steps (train_lora_flux.py:240)


def accumulation_steps(batch_size: int, samples_per_step: int) -> int:
    """Micro-steps per optimizer step: to an effective batch of 8."""
    rows = batch_size * samples_per_step
    return math.ceil(8 / rows) if rows < 8 else 1


def train(config, prompts, rank: int = 4, peft_type: str = "lora", save_file: bool = True, on_step_complete=None,
          resume_from=None, device: str = "cuda") -> TrainResult:
    """Train one Flux slider. Runs on ``cuda`` unless ``device="cpu"``."""
    t_entry = time.time()
    apply_tpu_runtime_flags(config.tpu)
    tpu_cfg = config.tpu
    check_supported(config, prompts, peft_type)
    quantize_base = bool(tpu_cfg.quantize_base)
    if tpu_cfg.w8a8_warmup:
        raise NotImplementedError(
            "tpu.w8a8_warmup accelerates a gradient-stopped partial-denoise "
            "warm-up chain (SD1/SDXL/SD3 trainers); the Flux trainer has no "
            "warm-up — timesteps_to=0 fixed (reference train_lora_flux.py:"
            "238-239) — set w8a8_warmup: false."
        )
    if quantize_base and peft_type == "dora":
        raise NotImplementedError(
            "tpu.quantize_base requires full-precision base magnitudes for "
            "DoRA's per-column norm init — use peft_type=lora with a "
            "quantized base."
        )
    student_overlay, _ = config_util.resolve_student_overlay(tpu_cfg, quantize_base, peft_type)
    samples_per_step = max(tpu_cfg.samples_per_step, 1)
    # joins the yaml world when configured; None on one rank (the one-process step)
    mesh = mesh_lib.training_mesh_from_config(tpu_cfg, samples_per_step, device)
    if mesh is not None and not mesh.member:  # a shrunk data axis: this rank idles
        mesh_step_start(mesh)
        return None
    device = mesh_lib.local_device(device)
    writer = mesh_lib.is_writer()
    weight_dtype = config_util.parse_precision(config.train.precision)
    save_dtype = config_util.parse_save_precision(config.save.precision)
    save_path = Path(config.save.path)
    name = config.pretrained_model.name_or_path
    metadata = {"prompts": json.dumps([p.model_dump() for p in prompts]), "config": config.model_dump_json()}

    _, encoder, transformer, scheduler = factory.load_models_flux(name, weight_dtype=weight_dtype,
                                                                  device=str(device), quantize_base=quantize_base)
    flux_cfg = transformer.config
    is_tiny = "tiny" in str(name).lower()
    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    sites = peft_mod.create_sites(transformer, rank=rank, alpha=config.network.alpha, target_replace=["Attention"],
                                  train_method=config.network.training_method, delimiter="-")
    init_gen = torch.Generator().manual_seed(tpu_cfg.seed)
    if peft_type == "dora":
        lora_params = dora_lib.init_lora_params(sites, transformer, generator=init_gen)
    else:
        lora_params = lora_lib.init_lora_params(sites, generator=init_gen)
    for leaf in lora_params.values():
        for k in leaf:
            leaf[k] = leaf[k].to(device).requires_grad_(True)

    resolution, batch_size = prompts[0].resolution, prompts[0].batch_size
    k = accumulation_steps(batch_size, samples_per_step)
    inner = get_optimizer("adamw", get_lr_schedule("cosine", 1e-4, 50, 1e-6), weight_decay=1e-6, grad_clip_value=1.0)
    optimizer = MultiSteps(inner, k)
    opt_state = optimizer.init(flat_params(sites, lora_params))

    bank = esd.build_prompt_bank(prompts, encoder)
    del encoder  # the text towers go before training
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if mesh is not None:  # the transformer tensor-sharded when mesh_model > 1; the rest replicates
        mesh_lib.place_training_state(mesh, transformer, lora_params, opt_state, bank, tp=mesh.model > 1)

    vae_scale = factory.flux_vae_scale(name)
    dynamic_resolution = any(p.dynamic_resolution for p in prompts)

    def build_step(height: int, width: int) -> esd_flux.FluxESDStep:
        gh, gw = height // vae_scale // 2, width // vae_scale // 2
        schedule = scheduler.set_timesteps(N_STEPS, mu=calculate_shift(gh * gw))
        fcfg = esd_flux.FluxESDConfig(num_inference_steps=N_STEPS, batch_size=batch_size, height=height, width=width,
                                      latent_channels=flux_cfg.in_channels // 4, vae_scale=vae_scale,
                                      remat=not is_tiny, samples_per_step=samples_per_step,
                                      student_overlay=student_overlay, mesh=mesh)
        return esd_flux.make_flux_esd_train_step(transformer, sites, lora_params, schedule, optimizer, fcfg,
                                                 merge_fn=peft_mod.merge_lora_params, debug_nans=tpu_cfg.debug_nans)

    buckets, pick_bucket = resolution_bucket_picker(dynamic_resolution, resolution, tpu_cfg.seed)
    step_fns = [build_step(h, w) for h, w in buckets]
    rng = esd.TrainRNG(tpu_cfg.seed, device)
    start = ckpt.maybe_restore(resume_from, lora_params, opt_state, rng)

    if writer:
        save_path.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(save_path, config.save.name, verbose=config.logging.verbose, write=writer)
    mesh_step_start(mesh)
    total_micro = config.train.iterations * k + 1  # the reference's count (train_lora_flux.py:227)
    t_loop = time.time()
    first_step_seconds = float("nan")
    # tpu.sequence_parallel: the joint self-attention rings K/V over the data axis
    with sequence_parallel_from_config(tpu_cfg):
        for i in range(start, total_micro):
            # the reference draws the bucket per prompt-pair iteration: per micro-step
            bi = pick_bucket(i) if pick_bucket is not None else 0
            try:
                metrics = step_fns[bi](opt_state, bank, rng)
            except FloatingPointError as e:  # tpu.debug_nans
                raise FloatingPointError(f"step {i}: {e}") from None
            if pick_bucket is not None:
                metrics = dict(metrics, height=buckets[bi][0], width=buckets[bi][1])
            logger.log(i, metrics)
            if i == start:
                first_step_seconds = time.time() - t_loop
            if (save_file and writer and config.save.per_steps and i % config.save.per_steps == 0
                    and i not in (0, total_micro - 1)):
                peft_mod.save_weights(save_path / f"{config.save.name}_{i}steps.safetensors", sites, lora_params,
                                      dtype=save_dtype, metadata=metadata)
                ckpt.save_resume(save_path, config.save.name, lora_params, opt_state, i + 1, rng)
            if (i + 1) % k == 0 and on_step_complete is not None:
                on_step_complete((i + 1) // k)
    sps = logger.close()
    if save_file and writer:
        peft_mod.save_weights(save_path / f"{config.save.name}_last.safetensors", sites, lora_params,
                              dtype=save_dtype, metadata=metadata)
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


def train_lora(target, positive, negative, unconditional, alpha=1.0, device="cuda", name=None, attributes=None,
               batch_size=1, config_file="data/config-xl.yaml", resolution=512, steps=None, on_step_complete=None,
               peft_type="lora", rank=4):
    """Programmatic API (the XL trainer's ``train_lora`` surface): writes a
    prompts YAML next to the config, trains, returns the state dict (numpy,
    reference schema)."""
    spec = {
        "target": target,
        "positive": positive,
        "negative": negative,
        "unconditional": unconditional,
        "neutral": target,
        "action": "enhance",
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
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:1, or cpu for tiny)")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--attributes", type=str, default=None)
    parser.add_argument("--peft_type", type=str, default="lora")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="resume checkpoint ({name}_resume.pt next to the saves, or its directory)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
