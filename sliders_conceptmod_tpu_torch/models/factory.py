"""Model loading + prompt encoding — counterpart of
``sliders_conceptmod_tpu/models/factory.py`` for the SD1/SD2 and SDXL
families.

``load_models`` (SD1/SD2) and ``load_models_xl`` build the weightless
families, chosen from the name as the JAX factory's ``_family_from_path``
chooses: ``tiny`` (a name containing "tiny"), ``sd21`` (``v2``, or a name
containing "stable-diffusion-2" or "sd2"), ``sd15`` (any other name, e.g.
``runwayml/stable-diffusion-v1-5``); ``tiny-xl`` (a name containing "tiny"
and "xl") and ``sdxl`` (any other name containing "xl", e.g.
``stabilityai/stable-diffusion-xl-base-1.0``) — the true architecture with
random weights made on the target device from a seeded ``torch.Generator``.
The initialisers mirror flax's defaults, which the JAX weightless family
uses, so random-weight models stay finite the same way:

* Linear / Conv kernels: lecun-normal — a normal truncated at ±2σ, rescaled
  to std ``1/sqrt(fan_in)`` (``fan_in`` = in · kh · kw);
* biases zero, norm scales one;
* embeddings: normal with std ``1/sqrt(features)``.

``load_for_training`` is the trainers' one entry: it picks the family from
the config and returns the UNet, scheduler, optional VAE and a one-prompt
encoder. Loading real weights (a diffusers directory or a single-file
checkpoint) waits until such files are in the repository.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler
from sliders_conceptmod_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    clip_skip_hidden_state,
    penultimate_hidden_state,
)
from sliders_conceptmod_tpu_torch.models.tokenizer import load_tokenizer
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@dataclass
class TextEncoderBundle:
    model: CLIPTextEncoder
    tokenizer: object

    def encode(self, prompts: List[str]):
        device = self.model.token_embedding.weight.device
        ids = torch.from_numpy(self.tokenizer(prompts).astype(np.int64)).to(device)
        return self.model(ids)


@torch.no_grad()
def init_flax_default(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter as flax's default initialisers would (see module
    docstring), in ``named_parameters`` order from one generator. Values are
    drawn in fp32 and cast to the parameter's dtype."""
    for name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                p.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                w.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
                p.copy_(w)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = int(np.prod(p.shape[1:]))
                std = fan_in**-0.5 / _TRUNC_STD
                w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                p.copy_(w)
            else:
                raise TypeError(f"no initialiser for {name}.{pname} ({type(mod).__name__})")


def build_module(factory, device, dtype, seed: int) -> nn.Module:
    """Construct on the meta device, materialise on ``device`` at ``dtype``,
    then fill with the seeded flax-default initialisers."""
    with torch.device("meta"):
        model = factory().to(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_flax_default(model, gen)
    return model.eval().requires_grad_(False)


def _family(name_or_path: str, v2: bool = False) -> str:
    """The JAX factory's ``_family_from_path`` rule."""
    p = str(name_or_path).lower()
    if "tiny" in p:
        return "tiny-xl" if "xl" in p else "tiny"
    if "xl" in p:
        return "sdxl"
    if v2 or "stable-diffusion-2" in p or "sd2" in p:
        return "sd21"
    return "sd15"


_XL_FAMILIES = ("sdxl", "tiny-xl")
_UNET_CONFIGS = {"tiny": UNetConfig.tiny, "sd15": UNetConfig.sd15, "sd21": UNetConfig.sd21,
                 "tiny-xl": UNetConfig.tiny_xl, "sdxl": UNetConfig.sdxl}


def unet_config_for(name_or_path: str, v2: bool = False) -> UNetConfig:
    """The UNet architecture the loaders build for this model name."""
    return _UNET_CONFIGS[_family(name_or_path, v2)]()


def _check_target(name_or_path: str, device: str) -> torch.device:
    if os.path.exists(str(name_or_path)):
        raise NotImplementedError(
            f"{name_or_path}: loading diffusers directories and single-file checkpoints is not ported "
            "yet; use a weightless family name (tiny, runwayml/stable-diffusion-v1-5, "
            "stabilityai/stable-diffusion-2-1, tiny-xl, stabilityai/stable-diffusion-xl-base-1.0)"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return device


def load_models(
    name_or_path: str,
    scheduler_name: str = "ddim",
    v2: bool = False,
    v_pred: bool = False,
    weight_dtype: torch.dtype = torch.float32,
    with_vae: bool = False,
    device: str = "cuda",
):
    """SD1/SD2: (tokenizer, te, unet, scheduler[, vae]). Weightless families
    only (see module docstring); module i of (te, unet, vae) is initialised
    from seed i. The scheduler predicts ``v_prediction`` when ``v_pred``; every
    family encodes with the full SD VAE, as the JAX factory does."""
    device = _check_target(name_or_path, device)
    family = _family(name_or_path, v2)
    if family in _XL_FAMILIES:
        raise ValueError(f"load_models: {name_or_path!r} is an SDXL family name; use load_models_xl")
    clip_cfg = {"tiny": CLIPTextConfig.tiny, "sd21": CLIPTextConfig.sd2_te, "sd15": CLIPTextConfig.sd15_te}[family]()
    unet_cfg = _UNET_CONFIGS[family]()
    tok = load_tokenizer("", component="tokenizer")
    te = TextEncoderBundle(build_module(lambda: CLIPTextEncoder(clip_cfg), device, weight_dtype, 0), tok)
    unet = build_module(lambda: UNet2DConditionModel(unet_cfg), device, weight_dtype, 1)
    scheduler = create_noise_scheduler(scheduler_name, prediction_type="v_prediction" if v_pred else "epsilon")
    out = (tok, te, unet, scheduler)
    if with_vae:
        return out + (build_module(lambda: AutoencoderKL(VAEConfig.sd()), device, weight_dtype, 2),)
    return out


def load_models_xl(
    name_or_path: str,
    scheduler_name: str = "euler_a",
    weight_dtype: torch.dtype = torch.float32,
    with_vae: bool = False,
    device: str = "cuda",
):
    """SDXL: ([tok1, tok2], [te1, te2], unet, scheduler[, vae]). te2 pads with
    id 0. Weightless families only (see module docstring); module i of
    (te1, te2, unet, vae) is initialised from seed i."""
    device = _check_target(name_or_path, device)
    family = _family(name_or_path)
    if family == "tiny":
        raise ValueError("load_models_xl: use a 'tiny-xl' name for the weightless XL smoke family")
    if family not in _XL_FAMILIES:
        raise ValueError(f"load_models_xl: {name_or_path!r} is not an SDXL family name")
    if family == "tiny-xl":
        te1_cfg = CLIPTextConfig.tiny(hidden_size=16)
        te2_cfg = CLIPTextConfig.tiny(hidden_size=16, projection_dim=32)
    else:
        te1_cfg, te2_cfg = CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2()
    unet_cfg = _UNET_CONFIGS[family]()
    tok1 = load_tokenizer("", component="tokenizer")
    tok2 = load_tokenizer("", component="tokenizer_2", pad_token_id=0)
    te1 = TextEncoderBundle(build_module(lambda: CLIPTextEncoder(te1_cfg), device, weight_dtype, 0), tok1)
    te2 = TextEncoderBundle(build_module(lambda: CLIPTextEncoder(te2_cfg), device, weight_dtype, 1), tok2)
    unet = build_module(lambda: UNet2DConditionModel(unet_cfg), device, weight_dtype, 2)
    out = ([tok1, tok2], [te1, te2], unet, create_noise_scheduler(scheduler_name))
    if with_vae:
        # both families encode and decode with the full SDXL VAE, as the JAX factory does
        return out + (build_module(lambda: AutoencoderKL(VAEConfig.sdxl()), device, weight_dtype, 3),)
    return out


@torch.inference_mode()
def encode_prompts(te: TextEncoderBundle, prompts: List[str], clip_skip: Optional[int] = None) -> torch.Tensor:
    """SD1/SD2: the final LayerNorm output, or the ``clip_skip`` hidden state
    (``[B, 77, D]``)."""
    return clip_skip_hidden_state(te.encode(prompts), clip_skip)


@torch.inference_mode()
def encode_prompts_xl(text_encoders: List[TextEncoderBundle], prompts: List[str]):
    """Concatenated penultimate hidden states of both towers, and te2's
    projected pool: ``(text [B, 77, D1+D2], pooled [B, P])``."""
    o1 = text_encoders[0].encode(prompts)
    o2 = text_encoders[1].encode(prompts)
    text = torch.cat([penultimate_hidden_state(o1), penultimate_hidden_state(o2)], dim=-1)
    pooled = o2.projected if o2.projected is not None else o2.pooled_output
    return text, pooled


@dataclass
class TrainingModels:
    """What a trainer needs of one model family. ``encode(prompt)`` returns
    ``(text [77, D], pooled [P] or None)`` and holds the text towers: set it
    to None to free them."""

    is_xl: bool
    unet: nn.Module
    scheduler: object
    vae: Optional[nn.Module]
    encode: Optional[Callable[[str], Tuple[torch.Tensor, Optional[torch.Tensor]]]]

    def add_time_ids(self, resolution: int, device) -> Optional[torch.Tensor]:
        """SDXL's micro-conditioning ids at a square resolution; None for SD1/SD2."""
        if not self.is_xl:
            return None
        return torch.from_numpy(get_add_time_ids(resolution, resolution)).to(device)


def load_for_training(model_cfg, scheduler_name: str, weight_dtype: torch.dtype, with_vae: bool = False,
                      device: str = "cuda") -> TrainingModels:
    """The trainers' one loader: the family from ``model_cfg`` (its
    ``name_or_path`` and ``v2``), then ``load_models_xl`` (both towers'
    penultimate states and te2's pool) or ``load_models`` (``v_pred``; the
    ``clip_skip`` state, no pool)."""
    name = model_cfg.name_or_path
    if _family(name, model_cfg.v2) in _XL_FAMILIES:
        _, tes, unet, scheduler, *vae = load_models_xl(name, scheduler_name, weight_dtype, with_vae, device)

        def encode(prompt: str):
            text, pooled = encode_prompts_xl(tes, [prompt])
            return text[0], pooled[0]

        is_xl = True
    else:
        _, te, unet, scheduler, *vae = load_models(name, scheduler_name, model_cfg.v2, model_cfg.v_pred,
                                                   weight_dtype, with_vae, device)

        def encode(prompt: str):
            return encode_prompts(te, [prompt], model_cfg.clip_skip)[0], None

        is_xl = False
    return TrainingModels(is_xl, unet, scheduler, vae[0] if vae else None, encode)
