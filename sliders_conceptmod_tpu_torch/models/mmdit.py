"""SD3 MMDiT transformer — counterpart of ``sliders_conceptmod_tpu/models/mmdit.py``
(diffusers ``SD3Transformer2DModel``), NCHW latents at the boundary.

Patchified 16-channel latents and the text context run through joint
(dual-stream) attention blocks with AdaLN-zero conditioning on the timestep
and the pooled text embedding. The last block is ``context_pre_only``: it
has no ``to_add_out`` and no ``ff_context``, and its ``norm1_context`` is the
continuous AdaLN.

Module names follow diffusers (``transformer_blocks.N.attn.to_q``,
``attn.to_out.0``, ``ff.net.0.proj``, ``ff.net.2``, ``norm1.linear``,
``time_text_embed.timestep_embedder.linear_1``, ...), so a diffusers
``transformer/`` state dict loads by name, and joining each index onto the
name before it gives the JAX tree's path (``transformer_blocks_0/attn/
to_out_0``). The SD3 slider's sites are the image stream's q/k/v/out of
every block (``adapters/lora.py``'s ``add_`` skip drops the context stream's).

Every joint attention goes through ``ops/attention.py::dot_product_attention``:
on the card kernel K1 (24 heads of 64 at SD3-Medium's width), K2/K3 in the
backward. The image and context q/k/v are concatenated along the sequence
into one contiguous BSHD tensor each, which the kernel takes as it is.

LayerNorms carry no affine parameters and take their statistics in fp32
(eps 1e-6), then cast back; the tanh GELU runs in fp32. The 2D sin-cos
position table is computed in float64 as diffusers (and JAX) compute it,
only over the centre crop the latent grid uses, and kept per grid size on
the device.

``remat_blocks``: each block under ``torch.utils.checkpoint`` (non-reentrant,
the JAX ``remat_blocks``): the backward recomputes one block at a time.
``remat_context`` (a zero-argument callable returning a context manager) is
entered around each block's recompute: the LoRA overlay or the merged
weights the forward ran under, which are gone by the time the backward runs.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sliders_conceptmod_tpu_torch.models.unet import TimestepEmbedding, timestep_embedding
from sliders_conceptmod_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def sd3_medium(cls) -> "MMDiTConfig":
        """stabilityai/stable-diffusion-3-medium-diffusers transformer/config.json."""
        return cls()

    @classmethod
    def tiny(cls) -> "MMDiTConfig":
        return cls(
            sample_size=8,
            num_layers=2,
            attention_head_dim=8,
            num_attention_heads=4,
            joint_attention_dim=32,
            caption_projection_dim=32,
            pooled_projection_dim=32,
            pos_embed_max_size=16,
        )

    def attention_calls_by_head_dim(self) -> Dict[int, int]:
        """Joint attentions in one forward by head dim: one per block
        (SD3-Medium: {64: 24})."""
        return {self.attention_head_dim: self.num_layers}


def sincos_pos_embed_crop(dim: int, max_size: int, gh: int, gw: int) -> np.ndarray:
    """The centre ``gh × gw`` crop of diffusers' ``get_2d_sincos_pos_embed``
    over a ``max_size²`` grid, ``[gh·gw, dim]`` float64. Every entry depends
    only on its own grid coordinates, so computing the crop alone gives the
    full table's values bit for bit."""
    if gh > max_size or gw > max_size:
        raise ValueError(f"latent grid {gh}x{gw} exceeds pos_embed_max_size {max_size}")
    top, left = (max_size - gh) // 2, (max_size - gw) // 2

    def _1d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(top, top + gh, dtype=np.float64)
    grid_w = np.arange(left, left + gw, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w first (diffusers convention)
    return np.concatenate([_1d(dim // 2, grid[0]), _1d(dim // 2, grid[1])], axis=1)


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, statistics in fp32, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


class PatchEmbedProj(nn.Module):
    """pos_embed.proj — the patchifying conv (the sin-cos table is computed)."""

    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)  # [B, gh·gw, dim], row-major grid


class TimestepTextEmbed(nn.Module):
    """time_text_embed: sinusoidal(256) → MLP, plus the pooled text's MLP."""

    def __init__(self, inner_dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, inner_dim)
        self.text_embedder = TimestepEmbedding(pooled_dim, inner_dim)

    def forward(self, timestep, pooled, dtype):
        t = self.timestep_embedder(timestep_embedding(timestep.float(), 256).to(dtype))
        return t + self.text_embedder(pooled.to(dtype))


class AdaLayerNormZero(nn.Module):
    """norm1: silu(temb) → linear(6·dim); the modulated input and the gates."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim)

    def forward(self, x, temb):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.linear(F.silu(temb)).chunk(6, dim=-1)
        x_mod = _layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return x_mod, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormContinuous(nn.Module):
    """norm_out and the last block's context norm: silu(temb) → linear(2·dim),
    (scale, shift) halves."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return _layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


class JointAttention(nn.Module):
    """Dual-stream attention over the concatenated [image, context] tokens."""

    def __init__(self, dim: int, heads: int, context_pre_only: bool):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.add_q_proj = nn.Linear(dim, dim)
        self.add_k_proj = nn.Linear(dim, dim)
        self.add_v_proj = nn.Linear(dim, dim)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.to_add_out = None if context_pre_only else nn.Linear(dim, dim)

    def forward(self, x, context):
        B, S, d = x.shape
        n = S + context.shape[1]
        hd = d // self.heads
        # the concatenation is the contiguous BSHD tensor the kernel takes
        q = torch.cat([self.to_q(x), self.add_q_proj(context)], dim=1).view(B, n, self.heads, hd)
        k = torch.cat([self.to_k(x), self.add_k_proj(context)], dim=1).view(B, n, self.heads, hd)
        v = torch.cat([self.to_v(x), self.add_v_proj(context)], dim=1).view(B, n, self.heads, hd)
        out = dot_product_attention(q, k, v).reshape(B, n, d)
        x_out = self.to_out[0](out[:, :S])
        if self.to_add_out is None:
            return x_out, None
        return x_out, self.to_add_out(out[:, S:])


class GELUProj(nn.Module):
    """diffusers FeedForward net.0: GELU(approximate='tanh') with .proj, in fp32."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        h = self.proj(x)
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)


class MMDiTFeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class JointTransformerBlock(nn.Module):
    def __init__(self, config: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        d = config.inner_dim
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(d)
        self.norm1_context = AdaLayerNormContinuous(d) if context_pre_only else AdaLayerNormZero(d)
        self.attn = JointAttention(d, config.num_attention_heads, context_pre_only)
        self.ff = MMDiTFeedForward(d)
        self.ff_context = None if context_pre_only else MMDiTFeedForward(d)

    def forward(self, x, context, temb):
        x_mod, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        if self.context_pre_only:
            ctx_mod = self.norm1_context(context, temb)
        else:
            ctx_mod, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(context, temb)
        attn_out, ctx_attn_out = self.attn(x_mod, ctx_mod)

        x = x + gate_msa[:, None] * attn_out
        h = _layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        x = x + gate_mlp[:, None] * self.ff(h)
        if self.context_pre_only:
            return x, None
        context = context + c_gate_msa[:, None] * ctx_attn_out
        ch = _layer_norm(context) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        context = context + c_gate_mlp[:, None] * self.ff_context(ch)
        return x, context


class SD3Transformer2DModel(nn.Module):
    """``forward(latents [B, 16, H, W], timestep [B] or scalar (0..1000),
    encoder_hidden_states [B, Sc, joint_dim], pooled [B, pooled_dim])`` →
    velocity ``[B, 16, H, W]`` in the weights' dtype."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        self.config = config
        d = config.inner_dim
        p = config.patch_size
        self.pos_embed = PatchEmbedProj(config.in_channels, d, p)
        self.time_text_embed = TimestepTextEmbed(d, config.pooled_projection_dim)
        self.context_embedder = nn.Linear(config.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList(
            [JointTransformerBlock(config, context_pre_only=(i == config.num_layers - 1))
             for i in range(config.num_layers)])
        self.norm_out = AdaLayerNormContinuous(d)
        self.proj_out = nn.Linear(d, p * p * config.out_channels)
        self._pos_cache: Dict[Tuple, torch.Tensor] = {}

    def pos_table(self, gh: int, gw: int, device, dtype) -> torch.Tensor:
        key = (gh, gw, str(device), dtype)
        pos = self._pos_cache.get(key)
        if pos is None:
            cfg = self.config
            table = sincos_pos_embed_crop(cfg.inner_dim, cfg.pos_embed_max_size, gh, gw)
            pos = self._pos_cache[key] = torch.from_numpy(table).to(device=device, dtype=dtype)[None]
        return pos

    def forward(self, hidden_states, timestep, encoder_hidden_states, pooled_projections, *,
                remat_blocks: bool = False,
                remat_context: Optional[Callable[[], ContextManager]] = None):
        cfg = self.config
        p = cfg.patch_size
        B, _, H, W = hidden_states.shape
        gh, gw = H // p, W // p
        dtype = self.pos_embed.proj.weight.dtype  # the compute dtype (the conv is never quantized)
        x = self.pos_embed(hidden_states.to(dtype))
        x = x + self.pos_table(gh, gw, x.device, dtype)
        t = torch.as_tensor(timestep, dtype=torch.float32, device=x.device).reshape(-1).expand(B)
        temb = self.time_text_embed(t, pooled_projections, dtype)
        context = self.context_embedder(encoder_hidden_states.to(dtype))
        for block in self.transformer_blocks:
            if remat_blocks and torch.is_grad_enabled():
                ctx = remat_context or nullcontext
                x, context = checkpoint(block, x, context, temb, use_reentrant=False,
                                        context_fn=lambda: (nullcontext(), ctx()))
            else:
                x, context = block(x, context, temb)
        x = self.proj_out(self.norm_out(x, temb))
        # unpatchify → NCHW
        x = x.reshape(B, gh, gw, p, p, cfg.out_channels)
        return torch.einsum("bhwpqc->bchpwq", x).reshape(B, cfg.out_channels, H, W)
