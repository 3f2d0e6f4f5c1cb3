"""Baseline-comparison helpers — counterpart of
``sliders_conceptmod_tpu/eval/baselines.py``: UCE, Textual Inversion and
Custom Diffusion, the methods the sliders are compared with (reference
``eval-scripts/generate_images-uce.py``,
``generate_images_textinversion{,_xl}.py``,
``generate_images_customdiffusion.py``).

* UCE ships a whole edited UNet state dict (:func:`load_edited_unet`);
  ``cli/generate_images_uce.py`` samples with the original UNet while
  ``t > start_noise`` and the interpolated one after, through
  ``infer/generate.py::sample_loop``.
* Textual Inversion ships one learned embedding (two for SDXL, one a text
  tower): :func:`load_textual_inversion`, :func:`load_textual_inversion_xl`,
  and :func:`add_inversion_token`, which registers the token and grows the
  tower's token table in place.
* Custom Diffusion ships cross-attention K/V weights (a copy, or the
  compressed ``u @ v`` added to the base): :func:`patch_custom_diffusion_kv`
  writes them into the UNet's parameters.

Files are read with the port's own ``io/safetensors.py`` (``.safetensors``)
or ``torch.load`` (``.pt``/``.bin``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from sliders_conceptmod_tpu_torch.io.safetensors import load_file


def load_edited_unet(path: str) -> Dict[str, torch.Tensor]:
    """A UCE-edited diffusers UNet state dict: a ``.safetensors`` file as
    stored, anything else through ``torch.load(weights_only=True)`` in fp32.
    The port's UNet takes diffusers' names, so the keys are its parameter
    names."""
    if str(path).endswith(".safetensors"):
        return load_file(str(path))
    return {k: v.float() for k, v in torch.load(str(path), map_location="cpu", weights_only=True).items()}


def load_pickle(path: str):
    # A1111 embeddings and Custom Diffusion's delta.bin are pickles of more than tensors, as the JAX loaders read them
    return torch.load(str(path), map_location="cpu", weights_only=False)


def load_textual_inversion(path: str) -> torch.Tensor:
    """The learned embedding vector(s) of a textual-inversion file: the first
    tensor of a diffusers ``learned_embeds.safetensors`` ({token: embedding},
    as stored), else of a ``.pt``/``.bin`` (A1111's ``string_to_param`` or
    diffusers' {token: embedding}) in fp32."""
    if str(path).endswith(".safetensors"):
        return next(iter(load_file(str(path)).values()))
    data = load_pickle(path)
    if "string_to_param" in data:  # A1111
        return next(iter(data["string_to_param"].values())).detach().float()
    return next(iter(data.values())).detach().float()


def load_textual_inversion_xl(path: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDXL's two embeddings (clip_l for te1, clip_g for te2), keys matched
    without case; without those names, the first two tensors in file order,
    and a single tensor serves both towers."""
    if str(path).endswith(".safetensors"):
        sd = {k.lower(): v for k, v in load_file(str(path)).items()}
    else:
        sd = {k.lower(): v.detach().float() for k, v in load_pickle(path).items() if hasattr(v, "detach")}
    if "clip_l" in sd and "clip_g" in sd:
        return sd["clip_l"], sd["clip_g"]
    vals = list(sd.values())
    if len(vals) >= 2:
        return vals[0], vals[1]
    return vals[0], vals[0]


@torch.no_grad()
def grow_token_table(model: nn.Module, rows: int) -> None:
    """Grow the tower's token table to ``rows`` with zero rows
    (``resize_token_embeddings``): the rows before stay bit-equal, and the
    tower's ``config.vocab_size`` follows. A table as long or longer is left
    as it is."""
    table: nn.Embedding = model.token_embedding
    w = table.weight
    if rows <= w.shape[0]:
        return
    grown = torch.zeros((rows, w.shape[1]), dtype=w.dtype, device=w.device)
    grown[: w.shape[0]] = w
    table.weight = nn.Parameter(grown, requires_grad=w.requires_grad)
    table.num_embeddings = rows
    model.config = dataclasses.replace(model.config, vocab_size=rows)


@torch.no_grad()
def inject_textual_inversion_token(model: nn.Module, embedding: torch.Tensor, token_id: int) -> None:
    """Write ``embedding`` at row ``token_id`` of the tower's token table,
    in the table's dtype; an id past the table grows it
    (:func:`grow_token_table`)."""
    grow_token_table(model, token_id + 1)
    w = model.token_embedding.weight
    w[token_id] = torch.as_tensor(embedding).to(device=w.device, dtype=w.dtype)


def add_inversion_token(te_bundle, token: str, embedding: torch.Tensor) -> int:
    """Register ``token`` on the bundle's tokenizer, grow the tower's token
    table and write the embedding (``add_tokens`` +
    ``resize_token_embeddings`` + the write; reference
    generate_images_customdiffusion.py:482-498). A multi-vector embedding
    contributes its first vector, as in JAX. Returns the token id."""
    emb = torch.as_tensor(embedding)
    if emb.ndim > 1:
        emb = emb[0]  # multi-vector TI: first vector (the JAX package's documented deviation)
    token_id = te_bundle.tokenizer.add_tokens(token)
    inject_textual_inversion_token(te_bundle.model, emb, token_id)
    return token_id


def _is_kv(key: str) -> bool:
    return "attn2" in key and (".to_k." in key or ".to_v." in key
                               or key.endswith("to_k.weight") or key.endswith("to_v.weight"))


@torch.no_grad()
def patch_custom_diffusion_kv(unet: nn.Module, delta_sd: Dict) -> None:
    """Apply a Custom Diffusion delta (reference
    generate_images_customdiffusion.py:374-510) to the UNet's parameters in
    place. Only cross-attention ``attn2`` ``to_k``/``to_v`` keys count; a
    plain tensor is copied over the base (cast to its dtype), the compressed
    form ``{"u", "v"}`` adds ``u @ v`` (formed in fp32, cast to the base's
    dtype) to it (the ``compress`` branch, :503-507)."""
    params = dict(unet.named_parameters())
    for key, value in delta_sd.items():
        if not _is_kv(key):
            continue
        p = params[key]
        if isinstance(value, dict) and "u" in value and "v" in value:
            u, v = (torch.as_tensor(value[n]).to(device=p.device, dtype=torch.float32) for n in ("u", "v"))
            p.add_((u @ v).to(p.dtype))
        else:
            p.copy_(torch.as_tensor(value).to(device=p.device, dtype=p.dtype))
