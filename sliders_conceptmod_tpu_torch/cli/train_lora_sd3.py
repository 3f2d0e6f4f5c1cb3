"""CLI: SD3 textual slider training (MMDiT + flow matching) — counterpart of
``sliders_conceptmod_tpu/cli/train_lora_sd3.py`` (reference
``conceptmod/textsliders/train_lora_sd3.py``), plus the ``train_lora``
programmatic API.

  python -m sliders_conceptmod_tpu_torch.cli.train_lora_sd3 \\
      --config_file data/config-sd3.yaml --alpha 1 --rank 4

The JAX trainer's SD3 specifics: LoRA sites over target ``["Attention"]``
with ``-``-delimited keys (``lora_unet-transformer_blocks-0-attn-to_q``; the
``add_`` skip leaves the image stream's q/k/v/out, 96 sites at SD3-Medium's
depth under ``full``), the stepped-latent ESD loss (``train/esd_sd3.py``),
16-channel latents, T5 dropped at encode time (``models/factory.py::
encode_prompts_sd3``). Its optimizer is fixed, whatever ``train.*`` says:
AdamW with weight decay 1e-6, lr cosine from 1e-4 over 50 steps to 1e-6,
the gradient norm clipped at 0.2. The student runs each MMDiT block under
``torch.utils.checkpoint`` unless the model is the tiny family.

``tpu:`` knobs: ``samples_per_step``, ``share_warmup``, ``quantize_base``
and ``w8a8_warmup`` (single tree or dual tree, JAX's refusals:
``train/trainer.py::resolve_int8_routes``), ``student_overlay`` /
``overlay_warmup``, ``debug_nans``, ``profile_dir``; the prompts'
``dynamic_resolution`` picks a bucket per iteration. Meshes raise.
``--resume_from`` continues a run; saves are ``{name}_{i}steps`` and
``{name}_last.safetensors`` in ``save.precision`` with a resume checkpoint
beside each periodic save. ``--device`` picks the torch device (default
``cuda``; ``cpu`` for tiny configs).
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
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import esd, esd_sd3
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger, resolution_bucket_picker
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer
from sliders_conceptmod_tpu_torch.train.trainer import TrainResult, check_supported, profiled, resolve_int8_routes
from sliders_conceptmod_tpu_torch.utils.debug import apply_tpu_runtime_flags


def train(config, prompts, rank: int = 4, peft_type: str = "lora", save_file: bool = True, on_step_complete=None,
          resume_from=None, device: str = "cuda") -> TrainResult:
    """Train one SD3 slider. Runs on ``cuda`` unless ``device="cpu"``."""
    t_entry = time.time()
    apply_tpu_runtime_flags(config.tpu)
    tpu_cfg = config.tpu
    check_supported(config, prompts, peft_type)
    student_overlay, overlay_warmup, quantize_base = resolve_int8_routes(tpu_cfg, peft_type)
    device = torch.device(device)
    weight_dtype = config_util.parse_precision(config.train.precision)
    save_dtype = config_util.parse_save_precision(config.save.precision)
    save_path = Path(config.save.path)
    name = config.pretrained_model.name_or_path
    metadata = {"prompts": json.dumps([p.model_dump() for p in prompts]), "config": config.model_dump_json()}

    _, text_encoders, transformer, scheduler = factory.load_models_sd3(
        name, weight_dtype=weight_dtype, device=str(device), quantize_base=quantize_base)
    mm_cfg = transformer.config
    is_tiny = "tiny" in str(name).lower()
    t5_len = factory.sd3_t5_seq_len(name)

    def encode(prompt: str):
        text, pooled = factory.encode_prompts_sd3(text_encoders, [prompt], mm_cfg.joint_attention_dim, t5_len)
        return text[0], pooled[0]

    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    # reference: target ["Attention"], delimiter "-" (train_lora_sd3.py:104-111)
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

    optimizer = get_optimizer("adamw", get_lr_schedule("cosine", 1e-4, 50, 1e-6), weight_decay=1e-6,
                              grad_clip_norm=0.2)
    opt_state = optimizer.init(flat_params(sites, lora_params))

    bank = esd.build_prompt_bank(prompts, encode)
    del encode, text_encoders  # the towers go before the (dual-tree) int8 copy
    if device.type == "cuda":
        torch.cuda.empty_cache()
    warm = quant.quantized_copy(transformer, act_quant=True) if tpu_cfg.w8a8_warmup else None

    resolution, batch_size = prompts[0].resolution, prompts[0].batch_size
    dynamic_resolution = any(p.dynamic_resolution for p in prompts)
    schedule = scheduler.set_timesteps(config.train.max_denoising_steps)

    def build_step(height: int, width: int) -> esd_sd3.SD3ESDStep:
        scfg = esd_sd3.SD3ESDConfig(
            max_denoising_steps=config.train.max_denoising_steps,
            train_cfg_scale=config.train.cfg,
            batch_size=batch_size,
            height=height,
            width=width,
            latent_channels=mm_cfg.in_channels,
            remat=not is_tiny,
            samples_per_step=max(tpu_cfg.samples_per_step, 1),
            share_warmup=tpu_cfg.share_warmup,
            student_overlay=student_overlay,
            overlay_warmup=overlay_warmup,
        )
        return esd_sd3.make_sd3_esd_train_step(transformer, sites, lora_params, schedule, optimizer, scfg,
                                               merge_fn=peft_mod.merge_lora_params, debug_nans=tpu_cfg.debug_nans,
                                               warm_transformer=warm)

    buckets, pick_bucket = resolution_bucket_picker(dynamic_resolution, resolution, tpu_cfg.seed)
    step_fns = [build_step(h, w) for h, w in buckets]
    rng = esd.TrainRNG(tpu_cfg.seed, device)
    start_step = ckpt.maybe_restore(resume_from, lora_params, opt_state, rng)

    save_path.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(save_path, config.save.name, verbose=config.logging.verbose)
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
