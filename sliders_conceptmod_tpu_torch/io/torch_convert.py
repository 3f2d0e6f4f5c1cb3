"""A diffusers model directory → the port's state dicts and configs.

Counterpart of ``sliders_conceptmod_tpu/io/torch_convert.py``. A diffusers
directory holds ``unet/``, ``vae/``, ``text_encoder/`` and (SDXL)
``text_encoder_2/``, each with a ``config.json`` and its weights as one
``.safetensors`` file or as shards listed in a ``*.safetensors.index.json``.
The weights are read with the port's own reader (``io/safetensors.py``).

The port's UNet, SD3 MMDiT, Flux transformer (``transformer/``), Stable
Cascade prior (``prior/``) and VAE use diffusers' module names, so their
state dicts load by name, as does Flux's T5 tower (``text_encoder_2/``,
transformers' names, the tied ``encoder.embed_tokens`` dropped); the VAE
attention's older diffusers names, which the SD1.x-era directories still
carry, are renamed (``query/key/value/proj_attn`` →
``to_q/to_k/to_v/to_out.0``). The CLIP towers come in the transformers
layout and map onto
``models/clip.py::CLIPTextEncoder``:

* ``text_model.embeddings.{token,position}_embedding.weight`` →
  ``{token,position}_embedding.weight``;
* ``text_model.encoder.layers.N.…`` → ``layers.N.…``, with ``mlp.fc1`` /
  ``mlp.fc2`` → ``mlp_fc1`` / ``mlp_fc2``;
* ``text_model.final_layer_norm.…`` → ``final_layer_norm.…``;
* ``text_projection.weight`` stays (SDXL's te2); the ``position_ids`` buffers
  are dropped.

:func:`load_state` copies a state dict into a module (strict: every key on
both sides), casting to the module's dtype on its device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.quant import QuantLinear
from sliders_conceptmod_tpu_torch.io.safetensors import load_file
from sliders_conceptmod_tpu_torch.models.cascade import CascadeConfig
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig
from sliders_conceptmod_tpu_torch.models.flux import FluxConfig
from sliders_conceptmod_tpu_torch.models.mmdit import MMDiTConfig
from sliders_conceptmod_tpu_torch.models.t5 import T5Config, convert_t5_state_dict
from sliders_conceptmod_tpu_torch.models.unet import UNetConfig
from sliders_conceptmod_tpu_torch.models.vae import VAEConfig

StateDict = Dict[str, torch.Tensor]

_OLD_VAE_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def weight_files(subdir: str) -> list:
    """The ``.safetensors`` files of one component: the shards an
    ``*.safetensors.index.json`` lists, else the file(s) without a variant
    infix (``model.safetensors``, not ``model.fp16.safetensors``), else
    every ``.safetensors`` file."""
    names = sorted(os.listdir(subdir))
    index = [n for n in names if n.endswith(".safetensors.index.json")]
    if index:
        shards = sorted(set(read_json(os.path.join(subdir, index[0]))["weight_map"].values()))
        return [os.path.join(subdir, s) for s in shards]
    files = [n for n in names if n.endswith(".safetensors")]
    plain = [n for n in files if n.count(".") == 1]
    if not files:
        raise FileNotFoundError(f"no .safetensors weights in {subdir}")
    return [os.path.join(subdir, n) for n in (plain or files)]


def read_component(model_dir: str, component: str) -> Tuple[StateDict, dict]:
    """(state dict as stored, config.json) of ``<model_dir>/<component>``."""
    sub = os.path.join(model_dir, component)
    sd: StateDict = {}
    for path in weight_files(sub):
        sd.update(load_file(path))
    return sd, read_json(os.path.join(sub, "config.json"))


def unet_config_from_json(cfg: dict) -> UNetConfig:
    """diffusers ``unet/config.json`` → ``UNetConfig`` (the JAX factory's
    ``_unet_config_from_json``)."""

    def per_block(key, default):
        v = cfg.get(key, default)
        return tuple(v) if isinstance(v, list) else v

    return UNetConfig(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        attention_head_dim=per_block("attention_head_dim", 8),
        transformer_layers_per_block=per_block("transformer_layers_per_block", 1),
        use_linear_projection=cfg.get("use_linear_projection", False),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim"),
        projection_class_embeddings_input_dim=cfg.get("projection_class_embeddings_input_dim"),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
    )


def vae_config_from_json(cfg: dict) -> VAEConfig:
    """diffusers ``vae/config.json`` → ``VAEConfig`` (the JAX factory's
    ``_load_or_init_vae``): the flow families' VAEs declare a
    ``shift_factor`` and ``use_quant_conv: false``; missing keys give the
    SD1/XL layout."""
    return VAEConfig(
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
        shift_factor=cfg.get("shift_factor") or 0.0,
        use_quant_conv=cfg.get("use_quant_conv", True),
        use_post_quant_conv=cfg.get("use_post_quant_conv", True),
    )


def mmdit_config_from_json(cfg: dict) -> MMDiTConfig:
    """diffusers ``transformer/config.json`` → ``MMDiTConfig``."""
    base = MMDiTConfig()
    return MMDiTConfig(**{f.name: getattr(base, f.name) if cfg.get(f.name) is None else cfg[f.name]
                          for f in dataclasses.fields(MMDiTConfig)})


def clip_config_from_json(cfg: dict, base: CLIPTextConfig, sd: StateDict) -> CLIPTextConfig:
    """The tower's own ``config.json`` over the family's config; the
    projection head only when the weights carry it (transformers configs
    declare a ``projection_dim`` even for plain towers)."""
    proj = sd.get("text_projection.weight")
    return dataclasses.replace(
        base,
        vocab_size=cfg.get("vocab_size", base.vocab_size),
        hidden_size=cfg.get("hidden_size", base.hidden_size),
        intermediate_size=cfg.get("intermediate_size", base.intermediate_size),
        num_hidden_layers=cfg.get("num_hidden_layers", base.num_hidden_layers),
        num_attention_heads=cfg.get("num_attention_heads", base.num_attention_heads),
        max_position_embeddings=cfg.get("max_position_embeddings", base.max_position_embeddings),
        hidden_act=cfg.get("hidden_act", base.hidden_act),
        projection_dim=(cfg.get("projection_dim") or int(proj.shape[0])) if proj is not None else None,
    )


def diffusers_state_dict(sd: StateDict) -> StateDict:
    """A diffusers UNet or VAE state dict under the port's names."""
    out = {}
    for key, value in sd.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-2] in _OLD_VAE_ATTENTION:
            key = ".".join(parts[:-2] + [_OLD_VAE_ATTENTION[parts[-2]], parts[-1]])
        out[key] = value
    return out


def clip_state_dict(sd: StateDict) -> StateDict:
    """A transformers-layout CLIP text tower under the port's names."""
    out = {}
    for key, value in sd.items():
        if key.endswith("position_ids"):
            continue
        for prefix in ("text_model.embeddings.", "text_model.encoder.", "text_model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[key.replace("mlp.fc1.", "mlp_fc1.").replace("mlp.fc2.", "mlp_fc2.")] = value
    return out


@torch.no_grad()
def load_state(module: nn.Module, sd: StateDict, what: str) -> None:
    """Copy ``sd`` into ``module``'s parameters, cast to each one's dtype on
    its device; an int8 ``QuantLinear`` (``adapters/quant.py``) quantizes its
    ``<name>.weight`` from fp32. Every parameter needs its tensor of the same
    shape, and every tensor its parameter."""
    params = dict(module.named_parameters())
    quant = {f"{n}.weight": m for n, m in module.named_modules() if isinstance(m, QuantLinear)}
    missing = sorted((set(params) | set(quant)) - set(sd))
    unexpected = sorted(set(sd) - set(params) - set(quant))
    if missing or unexpected:
        raise KeyError(f"{what}: {len(missing)} parameters have no tensor (e.g. {missing[:3]}), "
                       f"{len(unexpected)} tensors have no parameter (e.g. {unexpected[:3]})")
    shapes = {**{n: tuple(p.shape) for n, p in params.items()},
              **{n: tuple(m.weight_q.shape) for n, m in quant.items()}}
    for name, shape in shapes.items():
        if tuple(sd[name].shape) != shape:
            raise ValueError(f"{what}: {name} is {tuple(sd[name].shape)} in the checkpoint, {shape} in the model")
    for name, p in params.items():
        p.copy_(sd[name])
    for name, m in quant.items():
        m.set_weight(sd[name])


def load_unet_state(model_dir: str) -> Tuple[StateDict, UNetConfig]:
    sd, cfg = read_component(model_dir, "unet")
    return diffusers_state_dict(sd), unet_config_from_json(cfg)


def load_vae_state(model_dir: str) -> Tuple[StateDict, VAEConfig]:
    sd, cfg = read_component(model_dir, "vae")
    return diffusers_state_dict(sd), vae_config_from_json(cfg)


def load_transformer_state(model_dir: str) -> Tuple[StateDict, MMDiTConfig]:
    """SD3's ``transformer/``: diffusers' names are the port's."""
    sd, cfg = read_component(model_dir, "transformer")
    return sd, mmdit_config_from_json(cfg)


def load_text_encoder_state(model_dir: str, component: str, base: CLIPTextConfig) -> Tuple[StateDict, CLIPTextConfig]:
    sd, cfg = read_component(model_dir, component)
    sd = clip_state_dict(sd)
    return sd, clip_config_from_json(cfg, base, sd)


def flux_config_from_json(cfg: dict) -> FluxConfig:
    """diffusers' Flux ``transformer/config.json`` → ``FluxConfig``: its
    widths and depths, and ``guidance_embeds`` (dev)."""
    base = FluxConfig()
    kw = {f: cfg[f] for f in ("in_channels", "num_layers", "num_single_layers", "attention_head_dim",
                               "num_attention_heads", "joint_attention_dim", "pooled_projection_dim",
                               "guidance_embeds") if cfg.get(f) is not None}
    if cfg.get("axes_dims_rope") is not None:
        kw["axes_dims_rope"] = tuple(cfg["axes_dims_rope"])
    return FluxConfig(**{**{f: getattr(base, f) for f in base.__dataclass_fields__}, **kw})


def load_flux_transformer_state(model_dir: str) -> Tuple[StateDict, FluxConfig]:
    """Flux's ``transformer/``: diffusers' names are the port's."""
    sd, cfg = read_component(model_dir, "transformer")
    return sd, flux_config_from_json(cfg)


def load_t5_state(model_dir: str, component: str = "text_encoder_2") -> Tuple[StateDict, T5Config]:
    """An HF T5 encoder directory: its weights and ``config.json`` (depth and
    widths, as the JAX loader reads them)."""
    sd, cfg = read_component(model_dir, component)
    return convert_t5_state_dict(sd), T5Config.from_json(cfg)


def load_cascade_prior_state(model_dir: str) -> Tuple[StateDict, CascadeConfig]:
    """Stable Cascade's ``prior/`` (diffusers ``StableCascadeUNet``, sharded
    or not): diffusers' names are the port's, so the state dict is returned
    as stored, and :func:`load_state` places every key or refuses it. The
    architecture is always ``CascadeConfig.prior()``, as the JAX loader
    builds it; a ``config.json`` that declares other widths or depths (the
    1B "lite" prior) raises, naming the first key that differs."""
    sd, cfg = read_component(model_dir, "prior")
    prior = CascadeConfig.prior()
    for f in dataclasses.fields(CascadeConfig):
        if cfg.get(f.name) is None:
            continue
        want = getattr(prior, f.name)
        got = tuple(cfg[f.name]) if isinstance(cfg[f.name], list) else cfg[f.name]
        if got != want:
            raise ValueError(f"{model_dir}/prior/config.json: {f.name} is {cfg[f.name]!r}, but the prior "
                             f"this port builds (CascadeConfig.prior(), stable-cascade-prior) has {want!r}")
    return sd, prior
