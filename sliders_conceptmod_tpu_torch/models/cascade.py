"""Stable Cascade prior (Würstchen Stage C) — counterpart of
``sliders_conceptmod_tpu/models/cascade.py`` (diffusers ``StableCascadeUNet``
as the ``prior`` of ``StableCascadePriorPipeline``).

16-channel "effnet" latents at ``ceil(res / 42.67)`` a side go through a 1×1
conv embedding, then per level a stack of layers — a depthwise-conv
ResBlock, a FiLM block on the timestep *ratio*, an attention block whose keys
and values are the image tokens followed by the mapped CLIP-G conditioning
(text tokens, the pooled embedding and the image embedding, ``clip_seq``
slots each) — with an unpadded k2/s2 conv between the levels going down and
a k2/s2 transposed conv coming up, and a 1×1 conv head.

Module names are diffusers' (``embedding.1``, ``down_blocks.0.2.attention.
to_q``, ``down_blocks.0.2.kv_mapper.1``, ``down_blocks.0.0.channelwise.2.
gamma``, ``down_downscalers.1.1``, ``up_upscalers.0.1``, ``clf.1``), so a
diffusers ``prior/`` directory loads by name, and joining each index onto the
name before it gives the JAX tree's path (``down_blocks_0_2/attention/to_q``)
and the LoRA keys (``lora_unet_down_blocks_0_2_attention_to_q``).

The boundary is NCHW and the output is cast to the input's dtype; inside,
activations are channels-last ``[B, H, W, C]`` as in the JAX module, so the
channel LayerNorm (no affine, eps 1e-6, statistics in fp32), the channelwise
MLP (exact GELU in fp32) and the GlobalResponseNorm (fp32) work on the last
axis, and the convolutions see a channels-last view. On an odd grid the
down conv floors and the up path resizes back to the skip with half-pixel
bilinear sampling, as the JAX module does (the original uses
``align_corners=True``).

Every attention goes through ``ops/attention.py::dot_product_attention``:
on the card kernel K1 (heads of 64 at the prior's width), K2/K3 in the
backward. ``remat_blocks`` checkpoints each (ResBlock, TimestepBlock,
AttnBlock) layer with ``torch.utils.checkpoint`` and re-enters
``remat_context`` around its recompute (the overlay or merged weights the
forward ran under), as ``models/mmdit.py`` does per block.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sliders_conceptmod_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class CascadeConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 1
    conditioning_dim: int = 2048
    block_out_channels: Tuple[int, ...] = (2048, 2048)
    num_attention_heads: Tuple[int, ...] = (32, 32)
    down_num_layers_per_block: Tuple[int, ...] = (8, 24)
    up_num_layers_per_block: Tuple[int, ...] = (24, 8)
    clip_text_in_channels: int = 1280
    clip_text_pooled_in_channels: int = 1280
    clip_image_in_channels: int = 768
    clip_seq: int = 4
    kernel_size: int = 3
    timestep_ratio_embedding_dim: int = 64
    timestep_conditioning_type: Tuple[str, ...] = ("sca", "crp")
    resolution_multiple: float = 42.67  # latents are ceil(pixels / 42.67) a side

    @classmethod
    def prior(cls) -> "CascadeConfig":
        """stabilityai/stable-cascade-prior (3.6B)."""
        return cls()

    @classmethod
    def tiny(cls) -> "CascadeConfig":
        return cls(
            conditioning_dim=32,
            block_out_channels=(32, 32),
            num_attention_heads=(2, 2),
            down_num_layers_per_block=(1, 1),
            up_num_layers_per_block=(1, 1),
            clip_text_in_channels=16,
            clip_text_pooled_in_channels=16,
            clip_image_in_channels=16,
            clip_seq=2,
            timestep_ratio_embedding_dim=8,
        )

    def attention_calls_by_head_dim(self) -> Dict[int, int]:
        """Attentions in one forward by head dim (the prior: {64: 64})."""
        out: Dict[int, int] = {}
        n = len(self.block_out_channels)
        for level, (c, h) in enumerate(zip(self.block_out_channels, self.num_attention_heads)):
            out[c // h] = out.get(c // h, 0) + self.down_num_layers_per_block[level] \
                + self.up_num_layers_per_block[n - 1 - level]
        return out


_FREQS: Dict[Tuple[int, str], torch.Tensor] = {}


def ratio_embedding(r: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding ``[B, dim]`` fp32 of a [0, 1] timestep ratio
    ``[B]``: [sin(r·P·f), cos(r·P·f)] with f = exp(−ln P · i / (dim/2 − 1))
    (the frequencies rounded to fp32 once, on the host)."""
    half = dim // 2
    key = (half, str(r.device))
    freqs = _FREQS.get(key)
    if freqs is None:
        f = np.exp(-math.log(max_positions) * np.arange(half, dtype=np.float64) / (half - 1))
        freqs = _FREQS[key] = torch.from_numpy(f.astype(np.float32)).to(r.device)
    args = (r.float() * max_positions)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    return F.pad(emb, (0, 1)) if dim % 2 == 1 else emb


def channel_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last (channel) axis: no affine, eps 1e-6,
    statistics in fp32, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A torch conv over channels-last activations ``[B, H, W, C]``."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-v2 GRN over ``[B, H, W, C]`` in fp32: x·(1 + γ·N) + β with
    N = ‖x‖₂ over space divided by its mean over channels (+1e-6).
    ``gamma``/``beta`` are ``(1, 1, 1, C)``, as diffusers and JAX store them.

    The norm is ``torch.linalg.vector_norm`` (diffusers' ``torch.norm``): the
    same value as JAX's √(Σx²), but a channel whose squares all underflow to
    0 (GELU far below 0 over a grid of near-equal tokens, as the full-width
    prior's random weights give in bf16) gets a zero gradient where
    √'s is infinite and the product NaN."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        x32 = x.float()
        agg = torch.linalg.vector_norm(x32, dim=(1, 2), keepdim=True)
        stand = agg / (agg.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma.float() * (x32 * stand) + self.beta.float() + x32).to(x.dtype)


class CascadeResBlock(nn.Module):
    """Depthwise k×k conv, the channel norm, the optional skip concat, then
    the channelwise MLP (Linear → GELU → GRN → Linear) and the residual."""

    def __init__(self, c: int, c_skip: int = 0, kernel_size: int = 3):
        super().__init__()
        self.depthwise = nn.Conv2d(c, c, kernel_size, padding=kernel_size // 2, groups=c)
        self.channelwise = nn.ModuleList([nn.Linear(c + c_skip, c * 4), nn.Identity(), GlobalResponseNorm(c * 4),
                                          nn.Identity(), nn.Linear(c * 4, c)])

    def forward(self, x, x_skip=None):
        h = channel_layer_norm(_conv(self.depthwise, x))
        if x_skip is not None:
            h = torch.cat([h, x_skip.to(h.dtype)], dim=-1)
        h = self.channelwise[0](h)
        h = F.gelu(h.float()).to(h.dtype)
        h = self.channelwise[4](self.channelwise[2](h))
        return h + x


class CascadeTimestepBlock(nn.Module):
    """FiLM on the ratio embedding: x·(1 + a) + b, the (a, b) of ``mapper``
    and of one mapper per extra condition summed."""

    def __init__(self, c: int, c_timestep: int, conds: Tuple[str, ...] = ("sca", "crp")):
        super().__init__()
        self.conds = tuple(conds)
        self.mapper = nn.Linear(c_timestep, c * 2)
        for name in self.conds:
            setattr(self, f"mapper_{name}", nn.Linear(c_timestep, c * 2))

    def forward(self, x, r_embed):
        chunks = r_embed.to(x.dtype).chunk(1 + len(self.conds), dim=1)
        a, b = self.mapper(chunks[0]).chunk(2, dim=1)
        for i, name in enumerate(self.conds):
            ac, bc = getattr(self, f"mapper_{name}")(chunks[i + 1]).chunk(2, dim=1)
            a, b = a + ac, b + bc
        return x * (1 + a[:, None, None, :]) + b[:, None, None, :]


class CascadeAttention(nn.Module):
    """diffusers ``Attention``: to_q / to_k / to_v / to_out.0, all biased."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, q_tokens, kv_tokens):
        B, sq, c = q_tokens.shape
        sk = kv_tokens.shape[1]
        hd = c // self.heads
        q = self.to_q(q_tokens).view(B, sq, self.heads, hd)
        k = self.to_k(kv_tokens).view(B, sk, self.heads, hd)
        v = self.to_v(kv_tokens).view(B, sk, self.heads, hd)
        return self.to_out[0](dot_product_attention(q, k, v).reshape(B, sq, c))


class CascadeAttnBlock(nn.Module):
    """The normed image tokens attend to [themselves, kv_mapper(SiLU(clip))]."""

    def __init__(self, c: int, c_cond: int, heads: int):
        super().__init__()
        self.attention = CascadeAttention(c, heads)
        self.kv_mapper = nn.ModuleList([nn.SiLU(), nn.Linear(c_cond, c)])

    def forward(self, x, clip):
        B, H, W, C = x.shape
        kv = self.kv_mapper[1](F.silu(clip.float()).to(x.dtype))
        tokens = channel_layer_norm(x).reshape(B, H * W, C)
        attn = self.attention(tokens, torch.cat([tokens, kv], dim=1))
        return x + attn.reshape(B, H, W, C)


def _layer(c: int, cfg: CascadeConfig, heads: int, c_skip: int = 0) -> nn.ModuleList:
    return nn.ModuleList([
        CascadeResBlock(c, c_skip, cfg.kernel_size),
        CascadeTimestepBlock(c, cfg.timestep_ratio_embedding_dim, cfg.timestep_conditioning_type),
        CascadeAttnBlock(c, cfg.conditioning_dim, heads),
    ])


def _run_layer(res, ts, attn, h, skip, r_embed, clip):
    return attn(ts(res(h, skip), r_embed), clip)


class StableCascadeUNet(nn.Module):
    """``forward(x [B, 16, H, W], r [B] or scalar ratio, clip_text [B, S,
    1280], clip_text_pooled [B, 1, 1280] or [B, 1280], clip_img [B, 1, 768]
    or [B, 768])`` → the predicted noise, ``x``'s shape and dtype.
    ``down_blocks[i]`` / ``up_blocks[g]`` hold their layers flat (ResBlock,
    TimestepBlock, AttnBlock, ResBlock, …) under diffusers' indices."""

    def __init__(self, config: CascadeConfig):
        super().__init__()
        self.config = cfg = config
        c0, d = cfg.block_out_channels[0], cfg.conditioning_dim
        p = cfg.patch_size
        self.clip_txt_mapper = nn.Linear(cfg.clip_text_in_channels, d)
        self.clip_txt_pooled_mapper = nn.Linear(cfg.clip_text_pooled_in_channels, d * cfg.clip_seq)
        self.clip_img_mapper = nn.Linear(cfg.clip_image_in_channels, d * cfg.clip_seq)
        self.embedding = nn.ModuleList([nn.Identity(), nn.Conv2d(cfg.in_channels * p * p, c0, 1), nn.Identity()])
        n = len(cfg.block_out_channels)
        self.down_downscalers = nn.ModuleList()
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(cfg.block_out_channels):
            self.down_downscalers.append(nn.Identity() if i == 0 else nn.ModuleList([
                nn.Identity(), nn.Conv2d(cfg.block_out_channels[i - 1], c, 2, stride=2)]))
            self.down_blocks.append(nn.ModuleList(
                [m for _ in range(cfg.down_num_layers_per_block[i])
                 for m in _layer(c, cfg, cfg.num_attention_heads[i])]))
        self.up_blocks = nn.ModuleList()
        self.up_upscalers = nn.ModuleList()
        for g in range(n):
            level = n - 1 - g
            c = cfg.block_out_channels[level]
            self.up_blocks.append(nn.ModuleList(
                [m for j in range(cfg.up_num_layers_per_block[g])
                 for m in _layer(c, cfg, cfg.num_attention_heads[level], c if (j == 0 and g > 0) else 0)]))
            self.up_upscalers.append(nn.Identity() if level == 0 else nn.ModuleList([
                nn.Identity(), nn.ConvTranspose2d(c, cfg.block_out_channels[level - 1], 2, stride=2)]))
        self.clf = nn.ModuleList([nn.Identity(), nn.Conv2d(c0, cfg.out_channels * p * p, 1), nn.Identity()])

    def r_embed(self, r: torch.Tensor, extra_conds: dict) -> torch.Tensor:
        dim = self.config.timestep_ratio_embedding_dim
        parts = [ratio_embedding(r, dim)]
        for name in self.config.timestep_conditioning_type:
            cond = extra_conds.get(name)
            parts.append(ratio_embedding(torch.zeros_like(r) if cond is None else cond, dim))
        return torch.cat(parts, dim=1)

    def forward(self, x, r, clip_text, clip_text_pooled, clip_img, *, remat_blocks: bool = False,
                remat_context: Optional[Callable[[], ContextManager]] = None, **extra_conds):
        cfg = self.config
        B = x.shape[0]
        dtype = self.embedding[1].weight.dtype  # the compute dtype (convs are never quantized)
        r = torch.as_tensor(r, dtype=torch.float32, device=x.device).reshape(-1).expand(B)
        r_embed = self.r_embed(r, extra_conds)

        if clip_text_pooled.ndim == 2:
            clip_text_pooled = clip_text_pooled[:, None]
        if clip_img.ndim == 2:
            clip_img = clip_img[:, None]
        d = cfg.conditioning_dim
        txt = self.clip_txt_mapper(clip_text.to(dtype))
        pooled = self.clip_txt_pooled_mapper(clip_text_pooled.to(dtype)).reshape(B, -1, d)
        img = self.clip_img_mapper(clip_img.to(dtype)).reshape(B, -1, d)
        clip = channel_layer_norm(torch.cat([txt, pooled, img], dim=1))

        h = channel_layer_norm(_conv(self.embedding[1], x.to(dtype).permute(0, 2, 3, 1)))

        def run(layers, h, skip=None):
            for j in range(0, len(layers), 3):
                args = (*layers[j:j + 3], h, skip if j == 0 else None, r_embed, clip)
                if remat_blocks and torch.is_grad_enabled():
                    ctx = remat_context or nullcontext
                    h = checkpoint(_run_layer, *args, use_reentrant=False, context_fn=lambda: (nullcontext(), ctx()))
                else:
                    h = _run_layer(*args)
            return h

        level_outputs = []
        for i, layers in enumerate(self.down_blocks):
            if i > 0:
                h = _conv(self.down_downscalers[i][1], channel_layer_norm(h))  # unpadded: an odd grid floors
            h = run(layers, h)
            level_outputs.insert(0, h)

        h = level_outputs[0]
        for g, layers in enumerate(self.up_blocks):
            skip = level_outputs[g] if g > 0 else None
            if skip is not None and h.shape[1:3] != skip.shape[1:3]:
                # an odd grid: half-pixel bilinear back to the skip's size
                h = F.interpolate(h.permute(0, 3, 1, 2).float(), size=tuple(skip.shape[1:3]), mode="bilinear",
                                  align_corners=False, antialias=False).permute(0, 2, 3, 1).to(h.dtype)
            h = run(layers, h, skip)
            if not isinstance(self.up_upscalers[g], nn.Identity):
                h = _conv(self.up_upscalers[g][1], channel_layer_norm(h))

        out = _conv(self.clf[1], channel_layer_norm(h))
        return out.permute(0, 3, 1, 2).to(x.dtype)
