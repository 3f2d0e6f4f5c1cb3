"""CLI: notrigger text-encoder slider training — counterpart of
``sliders_conceptmod_tpu/cli/train_notrigger.py`` (reference
``conceptmod/notrigger/train_notrigger.py:547-633``), plus the
``train_lora`` programmatic API.

  python -m sliders_conceptmod_tpu_torch.cli.train_notrigger \\
      --config_file data/config-notrigger-xl.yaml --alpha 1 --rank 4 \\
      --clip_index 0 --positive "smiling" --negative "frowning"

``--clip_index`` picks the tower (0: CLIP-L, keys ``lora_te1_…``; 1:
OpenCLIP bigG, ``lora_te2_…``); ``--peft_type`` is ``dora`` by default;
``--model`` is ``SDXL``, ``PonyXL`` (the config's ``name_or_path``), ``tiny``
(the tiny-xl towers, for the CPU), ``SD3-Medium`` (SD3's towers through
``load_models_sd3``: CLIP-L with its projection, bigG), ``tiny-sd3``,
``FLUX.1`` or ``tiny-flux`` (as JAX's: te1 is the SDXL family's CLIP-L —
tiny-xl's for ``tiny-flux`` —, te2 a seeded T5 at ``train.precision``, XXL's
full width and depth or the tiny T5, with the hash tokenizer (512 tokens,
16 for tiny), the ``t5attn`` method over its ``T5Attention`` q/k/v/o and
keys ``lora_te2_encoder_block_…``). Saves are ``{name}_{clip_index}_{i}steps``
and ``{name}_{clip_index}_last.safetensors`` in ``save.precision``, with a
resume checkpoint beside each periodic save. ``--device`` picks the torch
device (default ``cuda``; ``cpu`` for tiny configs).

The trainer is JAX's: SGD with a 100-step linear warm-up then constant,
clipped by value at 1.0 (the config's optimizer and schedule are not read,
as in the reference), and an early exit when the loss stops moving.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.slider_file import CLIP_NAME_PATH_PREFIX, T5_NAME_PATH_PREFIX
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.models.t5 import T5Config, T5EncoderModel
from sliders_conceptmod_tpu_torch.models.tokenizer import HashTokenizer
from sliders_conceptmod_tpu_torch.train import checkpoint as ckpt
from sliders_conceptmod_tpu_torch.train import notrigger as nt
from sliders_conceptmod_tpu_torch.train.loop_utils import MetricsLogger
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer
from sliders_conceptmod_tpu_torch.utils.debug import apply_tpu_runtime_flags

_SD3 = ("SD3-Medium", "tiny-sd3")
_FLUX = ("FLUX.1", "tiny-flux")


def _prompt(p):
    if isinstance(p, (list, tuple)):
        p = ", ".join(p)
    return None if p == "" else p


def train(
    config,
    positive=None,
    negative=None,
    clip_index: int = 0,
    peft_type: str = "lora",
    rank: int = 4,
    model: str = "SDXL",
    save_file: bool = True,
    on_step_complete=None,
    resume_from=None,
    device: str = "cuda",
):
    """Train one text-encoder slider in tower ``clip_index``. Returns None
    when it saves, else the reference-schema state dict (numpy). Runs on
    ``cuda`` unless ``device="cpu"``."""
    tpu = getattr(config, "tpu", None)
    apply_tpu_runtime_flags(tpu)
    if getattr(tpu, "quantize_base", False) or getattr(tpu, "w8a8_warmup", False):
        raise NotImplementedError(
            "tpu.quantize_base / tpu.w8a8_warmup quantize a frozen diffusion transformer; the "
            "notrigger trainer touches only text encoders — set "
            "quantize_base: false."
        )
    if model not in ("SDXL", "PonyXL", "tiny") + _SD3 + _FLUX:
        raise NotImplementedError(f"model={model} not supported (SDXL/PonyXL/SD3-Medium/FLUX.1)")
    weight_dtype = config_util.parse_precision(config.train.precision)
    target_replace, name_path_prefix, train_method = nt.CLIP_TARGET_REPLACE, CLIP_NAME_PATH_PREFIX, None
    if model in _FLUX and clip_index == 1:  # te2 = T5 (reference train_notrigger.py:188-191)
        tiny = "tiny" in model
        t5_cfg = T5Config.tiny() if tiny else T5Config.xxl()
        t5 = factory.build_module(lambda: T5EncoderModel(t5_cfg), device, weight_dtype, 0)
        tok = HashTokenizer(vocab_size=t5_cfg.vocab_size, max_length=16 if tiny else 512, bos=0, eos=1, pad=0)
        text_encoders = [None, factory.TextEncoderBundle(t5, tok)]
        target_replace, name_path_prefix, train_method = ["T5Attention"], T5_NAME_PATH_PREFIX, "t5attn"
    elif model in _SD3:  # SD3's own towers: CLIP-L with its 768-dim projection, bigG
        name = "tiny-sd3" if "tiny" in model else config.pretrained_model.name_or_path
        _, text_encoders, _, _ = factory.load_models_sd3(name, weight_dtype=weight_dtype, device=device,
                                                         with_transformer=False)
    else:
        name = "tiny-xl" if model in ("tiny", "tiny-flux") else config.pretrained_model.name_or_path
        _, text_encoders, _, _ = factory.load_models_xl(name, weight_dtype=weight_dtype, device=device,
                                                        with_unet=False)
    te = text_encoders[clip_index]
    encoder = te.model
    prefix = ["lora_te1", "lora_te2"][clip_index]

    positive, negative = _prompt(positive), _prompt(negative)
    if positive is None and negative is None:
        raise ValueError("at least one of positive/negative is required")
    dev = next(encoder.parameters()).device

    def ids(prompt: str) -> torch.Tensor:
        return torch.from_numpy(te.tokenizer([prompt]).astype(np.int64)).to(dev)

    with torch.no_grad():
        hidden = nt.hidden_of(encoder)
        neutral_ids = ids("")
        pos_target = hidden(ids(positive)) if positive else None
        neg_target = hidden(ids(negative)) if negative else None
        neutral_target = hidden(neutral_ids)

    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    sites = peft_mod.create_sites(encoder, rank=rank, alpha=config.network.alpha, target_replace=target_replace,
                                  prefix=prefix, train_method=train_method or config.network.training_method,
                                  name_path_prefix=name_path_prefix)
    init_gen = torch.Generator().manual_seed(config.tpu.seed)
    if peft_type == "dora":  # dora_scale = the column norms of the tower's weights
        lora_params = dora_lib.init_lora_params(sites, encoder, generator=init_gen)
    else:
        lora_params = lora_lib.init_lora_params(sites, generator=init_gen)
    for leaf in lora_params.values():
        for k in leaf:
            leaf[k] = leaf[k].to(dev).requires_grad_(True)

    # SGD + 100-step linear warm-up then constant, value clip 1.0 (reference :216-229, :444)
    iterations = config.train.iterations
    optimizer = get_optimizer("sgd", get_lr_schedule("constant_with_warmup", config.train.lr, iterations),
                              grad_clip_value=1.0)
    opt_state = optimizer.init(flat_params(sites, lora_params))
    d1, d2 = nt.initial_distances(encoder, sites, lora_params, neutral_ids, pos_target, neg_target,
                                  merge_fn=peft_mod.merge_lora_params)
    ncfg = nt.NoTriggerConfig(lambda_similarity=config.train.lambda_similarity,
                              has_positive=positive is not None, has_negative=negative is not None)
    step = nt.make_notrigger_step(encoder, sites, lora_params, optimizer, ncfg, neutral_ids, pos_target, neg_target,
                                  neutral_target, d1, d2, merge_fn=peft_mod.merge_lora_params)

    save_path = Path(config.save.path)
    save_dtype = config_util.parse_save_precision(config.save.precision)
    logger = MetricsLogger(save_path, config.save.name, config.logging.verbose)
    # the step is deterministic: the resume checkpoint holds no generator state
    start_step = ckpt.maybe_restore(resume_from, lora_params, opt_state, None)
    last_loss = None
    for i in range(start_step, iterations):
        logger.log(i, step(opt_state))
        # stalled-loss early exit (reference :389-393)
        if i % 800 == 0 and i > 1000:
            cur = logger.current_loss()
            if last_loss is not None and last_loss == cur:
                print("loss stopped moving. exiting early.")
                break
            last_loss = cur
        if save_file and config.save.per_steps and i % config.save.per_steps == 0 and i not in (0, iterations - 1):
            save_path.mkdir(parents=True, exist_ok=True)
            peft_mod.save_weights(save_path / f"{config.save.name}_{clip_index}_{i}steps.safetensors", sites,
                                  lora_params, dtype=save_dtype)
            ckpt.save_resume(save_path, f"{config.save.name}_{clip_index}", lora_params, opt_state, i + 1, None)
        if on_step_complete is not None:
            on_step_complete(i)
    logger.close()
    if save_file:
        save_path.mkdir(parents=True, exist_ok=True)
        peft_mod.save_weights(save_path / f"{config.save.name}_{clip_index}_last.safetensors", sites, lora_params,
                              dtype=save_dtype)
        return None
    return peft_mod.state_dict_numpy(sites, lora_params)


def _decorate(config, alpha, rank) -> None:
    config.network.alpha = alpha
    config.network.rank = rank
    config.save.name += f"_alpha{alpha}_rank{rank}_{config.network.training_method}"
    config.save.path += f"/{config.save.name}"


def main(args):
    config = config_util.load_config_from_yaml(args.config_file)
    if args.name is not None:
        config.save.name = args.name
    _decorate(config, args.alpha, args.rank)
    positive = args.positive if args.positive is None else " ".join(args.positive)
    return train(config, positive=positive, negative=args.negative, clip_index=args.clip_index,
                 peft_type=args.peft_type, rank=args.rank, model=args.model, resume_from=args.resume_from,
                 device=args.device)


def train_lora(
    target,
    positive,
    negative,
    unconditional,
    alpha=1.0,
    rank=4,
    device="cuda",
    name=None,
    attributes=None,
    batch_size=1,
    config_file="data/config-xl.yaml",
    resolution=512,
    steps=None,
    on_step_complete=None,
    clip_index=0,
    peft_type="lora",
    model="SDXL",
):
    """Programmatic API (reference train_notrigger.py:507-545): trains from
    ``positive``/``negative`` and returns the state dict (the target,
    unconditional, attributes, batch size and resolution are vestigial, as
    in the reference)."""
    config = config_util.load_config_from_yaml(config_file)
    if name is not None:
        config.save.name = name
    if steps is not None:
        config.train.iterations = steps
    _decorate(config, alpha, rank)
    return train(config, positive=[positive] if isinstance(positive, str) else positive, negative=negative,
                 clip_index=clip_index, peft_type=peft_type, rank=rank, model=model, save_file=False,
                 on_step_complete=on_step_complete, device=device)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--alpha", type=float, required=True)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, cuda:1, or cpu for tiny configs).")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--attributes", type=str, default=None)
    parser.add_argument("--peft_type", type=str, default="dora", help="dora (default) or lora")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="resume checkpoint ({name}_{clip_index}_resume.pt next to the saves, or its directory)")
    parser.add_argument("--positive", type=str, nargs="+", default=None)
    parser.add_argument("--model", type=str, default="SDXL",
                        help="SDXL | PonyXL | tiny | SD3-Medium | tiny-sd3 | FLUX.1 | tiny-flux")
    parser.add_argument("--negative", type=str, default=None)
    parser.add_argument("--clip_index", type=int, required=True)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
