"""Model loading + prompt encoding — counterpart of
``sliders_conceptmod_tpu/models/factory.py`` for the SDXL family.

``load_models_xl`` builds the weightless families: ``tiny-xl`` (any name
containing "tiny" and "xl") and ``sdxl`` (any other name containing "xl",
e.g. ``stabilityai/stable-diffusion-xl-base-1.0``) — the true architecture
with random weights made on the target device from a seeded
``torch.Generator``. The initialisers mirror flax's defaults, which the JAX
weightless family uses, so random-weight SDXL stays finite the same way:

* Linear / Conv kernels: lecun-normal — a normal truncated at ±2σ, rescaled
  to std ``1/sqrt(fan_in)`` (``fan_in`` = in · kh · kw);
* biases zero, norm scales one;
* embeddings: normal with std ``1/sqrt(features)``.

Loading real weights (a diffusers directory or a single-file checkpoint)
waits until such files are in the repository.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder, penultimate_hidden_state
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


def _family(name_or_path: str) -> str:
    p = str(name_or_path).lower()
    if "tiny" in p:
        if "xl" not in p:
            raise ValueError("load_models_xl: use a 'tiny-xl' name for the weightless XL smoke family")
        return "tiny-xl"
    if "xl" in p:
        return "sdxl"
    raise ValueError(f"load_models_xl: {name_or_path!r} is not an SDXL family name")


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
    if os.path.exists(str(name_or_path)):
        raise NotImplementedError(
            f"{name_or_path}: loading diffusers directories and single-file checkpoints is not ported "
            "yet; use a weightless family name (tiny-xl, stabilityai/stable-diffusion-xl-base-1.0)"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    family = _family(name_or_path)
    if family == "tiny-xl":
        te1_cfg = CLIPTextConfig.tiny(hidden_size=16)
        te2_cfg = CLIPTextConfig.tiny(hidden_size=16, projection_dim=32)
        unet_cfg = UNetConfig.tiny_xl()
    else:
        te1_cfg, te2_cfg = CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2()
        unet_cfg = UNetConfig.sdxl()
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
def encode_prompts_xl(text_encoders: List[TextEncoderBundle], prompts: List[str]):
    """Concatenated penultimate hidden states of both towers, and te2's
    projected pool: ``(text [B, 77, D1+D2], pooled [B, P])``."""
    o1 = text_encoders[0].encode(prompts)
    o2 = text_encoders[1].encode(prompts)
    text = torch.cat([penultimate_hidden_state(o1), penultimate_hidden_state(o2)], dim=-1)
    pooled = o2.projected if o2.projected is not None else o2.pooled_output
    return text, pooled
