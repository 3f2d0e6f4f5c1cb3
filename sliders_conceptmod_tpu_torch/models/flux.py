"""The Flux transformer — counterpart of ``sliders_conceptmod_tpu/models/flux.py``
(diffusers ``FluxTransformer2DModel``): packed 2×2 latents as tokens, dual-stream
blocks (text and image with qk RMS norms and 3-axis RoPE), single-stream
blocks (attention and MLP in parallel over one ``proj_out``), AdaLN-zero
conditioning on the timestep (× 1000 inside), the pooled CLIP embedding and,
for the dev variant, the guidance.

Order: Flux concatenates [text, image] — text first, the reverse of SD3 — in
the joint attention (the outputs split as ``out[:, :Sc]`` / ``out[:, Sc:]``),
in the single-stream stack (the image tokens are ``combined[:, Sc:]``) and
in the RoPE ids (``cat(txt_ids, img_ids)``, axes (16, 56, 56) over
(constant, row, column)). RoPE rotates interleaved pairs
(``x[..., 0::2]``, ``x[..., 1::2]``), in fp32; the rotated q and k are cast
back to the activations' dtype, as diffusers casts them (JAX keeps them
fp32 in a bf16 model).

Every attention goes through ``ops/attention.py::dot_product_attention``:
on the card kernel K1 at head dim 128 (24 heads at schnell's width, no
padding), K2/K3 in the backward — 19 + 38 = 57 per forward. The q/k/v of a
dual block are concatenated along the sequence into one contiguous BSHD
tensor each.

Module names are diffusers' (``transformer_blocks.N.attn.to_q``,
``attn.to_out.0``, ``ff.net.0.proj``, ``single_transformer_blocks.N.
attn.to_q``, ``…norm.linear``, ``proj_mlp``, ``time_text_embed.
guidance_embedder.linear_1``, ``norm_out.linear``, …), so a diffusers
``transformer/`` state dict loads as it is, with no conversion (JAX's
``convert_flux_state_dict`` renames it into its tree). That tree flattens some of
them (``ff_net_0_proj``, ``attn_to_q``, ``attn_norm_q``, ``norm_linear``):
:meth:`FluxTransformer2DModel.jax_path` maps them, so the weight bridge, the
int8 artifact's paths and the LoRA sites are JAX's — the single-stream
blocks' flat ``attn_to_q`` is no ``Attention`` child there, so a slider has
the dual blocks' q/k/v/out only (76 sites at schnell's depth).

``remat_blocks``: each block under ``torch.utils.checkpoint`` with
``remat_context`` entered around its recompute (``models/mmdit.py``).
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

from sliders_conceptmod_tpu_torch.adapters.lora import module_path
from sliders_conceptmod_tpu_torch.models.mmdit import AdaLayerNormContinuous, AdaLayerNormZero, MMDiTFeedForward, \
    _layer_norm
from sliders_conceptmod_tpu_torch.models.norms import RMSNorm
from sliders_conceptmod_tpu_torch.models.unet import TimestepEmbedding, timestep_embedding
from sliders_conceptmod_tpu_torch.ops.attention import dot_product_attention

DEV_GUIDANCE = 3.5  # diffusers FluxPipeline's default, given to a dev model called without one (JAX's bundle)


@dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5 context
    pooled_projection_dim: int = 768  # CLIP pooled
    guidance_embeds: bool = False  # schnell
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def schnell(cls) -> "FluxConfig":
        return cls()

    @classmethod
    def dev(cls) -> "FluxConfig":
        return cls(guidance_embeds=True)

    @classmethod
    def tiny(cls) -> "FluxConfig":
        return cls(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=8, num_attention_heads=4,
                   joint_attention_dim=32, pooled_projection_dim=32, axes_dims_rope=(2, 4, 2))

    def attention_calls_by_head_dim(self) -> Dict[int, int]:
        """Attentions in one forward by head dim (schnell: {128: 57})."""
        return {self.attention_head_dim: self.num_layers + self.num_single_layers}


def rope_freqs(ids: torch.Tensor, axes_dims: Tuple[int, ...], theta: float = 10000.0):
    """ids ``[..., S, n_axes]`` → (cos, sin) each ``[..., S, head_dim]`` fp32,
    each axis's angles repeated pairwise (the interleaved layout)."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d))
        angles = ids[..., i, None].float() * freqs
        cos_parts.append(torch.cos(angles).repeat_interleave(2, dim=-1))
        sin_parts.append(torch.sin(angles).repeat_interleave(2, dim=-1))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, D]``, cos/sin ``[B or 1, S, D]`` → the rotated x (pairs
    (x₀, x₁) → (x₀c − x₁s, x₁c + x₀s)), in fp32, returned in x's dtype."""
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return (x32 * cos[:, :, None, :] + rotated * sin[:, :, None, :]).to(x.dtype)


def prepare_latent_image_ids(gh: int, gw: int) -> np.ndarray:
    """``[gh·gw, 3]``: (0, row, col) — diffusers' ``_prepare_latent_image_ids``."""
    ids = np.zeros((gh, gw, 3), np.float32)
    ids[..., 1] = np.arange(gh)[:, None]
    ids[..., 2] = np.arange(gw)[None, :]
    return ids.reshape(gh * gw, 3)


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` → ``[B, (H/2)(W/2), 4C]`` (2×2 patches, channel-major)."""
    B, C, H, W = latents.shape
    x = latents.reshape(B, C, H // 2, 2, W // 2, 2)
    return torch.einsum("bchpwq->bhwcpq", x).reshape(B, (H // 2) * (W // 2), C * 4)


def unpack_latents(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """:func:`pack_latents`'s inverse."""
    B, _, D = x.shape
    C = D // 4
    x = x.reshape(B, H // 2, W // 2, C, 2, 2)
    return torch.einsum("bhwcpq->bchpwq", x).reshape(B, C, H, W)


class FluxTimeTextEmbed(nn.Module):
    """time_text_embed: sinusoidal(256) of t·1000 → MLP, plus the guidance's
    (dev), plus the pooled embedding's MLP."""

    def __init__(self, inner_dim: int, pooled_dim: int, guidance_embeds: bool):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, inner_dim)
        self.guidance_embedder = TimestepEmbedding(256, inner_dim) if guidance_embeds else None
        self.text_embedder = TimestepEmbedding(pooled_dim, inner_dim)

    def forward(self, timestep: torch.Tensor, pooled: torch.Tensor, guidance, dtype) -> torch.Tensor:
        emb = self.timestep_embedder(timestep_embedding(timestep.float() * 1000.0, 256).to(dtype))
        if self.guidance_embedder is not None:
            g = torch.as_tensor(guidance, dtype=torch.float32, device=timestep.device).expand(timestep.shape)
            emb = emb + self.guidance_embedder(timestep_embedding(g * 1000.0, 256).to(dtype))
        return emb + self.text_embedder(pooled.to(dtype))


class FluxJointAttention(nn.Module):
    """Dual-stream attention over [text, image] with qk RMS norms and RoPE."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, dim) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(dim, dim) for _ in range(3))
        self.norm_added_q, self.norm_added_k = RMSNorm(hd), RMSNorm(hd)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.to_add_out = nn.Linear(dim, dim)

    def forward(self, x, context, cos, sin):
        B, S, d = x.shape
        Sc = context.shape[1]
        hd = d // self.heads

        def heads_of(t):
            return t.view(t.shape[0], t.shape[1], self.heads, hd)

        q = torch.cat([self.norm_added_q(heads_of(self.add_q_proj(context))), self.norm_q(heads_of(self.to_q(x)))], 1)
        k = torch.cat([self.norm_added_k(heads_of(self.add_k_proj(context))), self.norm_k(heads_of(self.to_k(x)))], 1)
        v = torch.cat([heads_of(self.add_v_proj(context)), heads_of(self.to_v(x))], 1)
        out = dot_product_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v).reshape(B, Sc + S, d)
        return self.to_out[0](out[:, Sc:]), self.to_add_out(out[:, :Sc])


class FluxTransformerBlock(nn.Module):
    def __init__(self, config: FluxConfig):
        super().__init__()
        d = config.inner_dim
        self.norm1 = AdaLayerNormZero(d)
        self.norm1_context = AdaLayerNormZero(d)
        self.attn = FluxJointAttention(d, config.num_attention_heads)
        self.ff = MMDiTFeedForward(d)
        self.ff_context = MMDiTFeedForward(d)

    def forward(self, x, context, temb, cos, sin):
        x_mod, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        ctx_mod, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(context, temb)
        attn_out, ctx_attn_out = self.attn(x_mod, ctx_mod, cos, sin)
        x = x + gate_msa[:, None] * attn_out
        h = _layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        x = x + gate_mlp[:, None] * self.ff(h)
        context = context + c_gate_msa[:, None] * ctx_attn_out
        ch = _layer_norm(context) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        context = context + c_gate_mlp[:, None] * self.ff_context(ch)
        return x, context


class FluxSingleAttention(nn.Module):
    """The single-stream block's q/k/v with their RMS norms (no output
    projection: ``proj_out`` takes the attention and the MLP together)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, dim) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(dim // heads), RMSNorm(dim // heads)

    def forward(self, x, cos, sin):
        B, S, d = x.shape

        def heads_of(t):
            return t.view(B, S, self.heads, d // self.heads)

        q = apply_rope(self.norm_q(heads_of(self.to_q(x))), cos, sin)
        k = apply_rope(self.norm_k(heads_of(self.to_k(x))), cos, sin)
        return dot_product_attention(q, k, heads_of(self.to_v(x))).reshape(B, S, d)


class AdaLayerNormZeroSingle(nn.Module):
    """norm: silu(temb) → linear(3·dim) → (shift, scale, gate)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 3 * dim)

    def forward(self, x, temb):
        shift, scale, gate = self.linear(F.silu(temb)).chunk(3, dim=-1)
        return _layer_norm(x) * (1 + scale[:, None]) + shift[:, None], gate


class FluxSingleTransformerBlock(nn.Module):
    def __init__(self, config: FluxConfig):
        super().__init__()
        d = config.inner_dim
        self.norm = AdaLayerNormZeroSingle(d)
        self.proj_mlp = nn.Linear(d, 4 * d)
        self.attn = FluxSingleAttention(d, config.num_attention_heads)
        self.proj_out = nn.Linear(5 * d, d)

    def forward(self, x, temb, cos, sin):
        normed, gate = self.norm(x, temb)
        mlp = self.proj_mlp(normed)
        mlp = F.gelu(mlp.float(), approximate="tanh").to(mlp.dtype)
        out = self.proj_out(torch.cat([self.attn(normed, cos, sin), mlp], dim=-1))
        return x + gate[:, None] * out


class FluxTransformer2DModel(nn.Module):
    """``forward(hidden_states [B, S_img, in_channels] packed tokens,
    timestep [B] or scalar in [0, 1], encoder_hidden_states [B, S_txt,
    joint_dim], pooled_projections [B, pooled_dim], txt_ids [S_txt, 3],
    img_ids [S_img, 3], guidance=None)`` → velocity tokens ``[B, S_img,
    in_channels]`` in the weights' dtype. A dev model called without a
    guidance takes :data:`DEV_GUIDANCE`."""

    def __init__(self, config: FluxConfig):
        super().__init__()
        self.config = config
        d = config.inner_dim
        self.x_embedder = nn.Linear(config.in_channels, d)
        self.context_embedder = nn.Linear(config.joint_attention_dim, d)
        self.time_text_embed = FluxTimeTextEmbed(d, config.pooled_projection_dim, config.guidance_embeds)
        self.transformer_blocks = nn.ModuleList([FluxTransformerBlock(config) for _ in range(config.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(config) for _ in range(config.num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(d)
        self.proj_out = nn.Linear(d, config.in_channels)

    @staticmethod
    def jax_path(name: str) -> Tuple[str, ...]:
        """The JAX tree's path of a module: a dual block's ``ff`` /
        ``ff_context`` stacks and a single block's ``attn`` / ``norm``
        children are single flat names there (``ff_net_0_proj``,
        ``attn_to_q``, ``norm_linear``)."""
        path = module_path(name)
        if len(path) > 1 and ((path[0].startswith("transformer_blocks_") and path[1] in ("ff", "ff_context"))
                              or (path[0].startswith("single_transformer_blocks_") and path[1] in ("attn", "norm"))):
            return (path[0], "_".join(path[1:]))
        return path

    def forward(self, hidden_states, timestep, encoder_hidden_states, pooled_projections, txt_ids, img_ids,
                guidance=None, *, remat_blocks: bool = False,
                remat_context: Optional[Callable[[], ContextManager]] = None):
        cfg = self.config
        # the compute dtype: a bias, which int8 quantization leaves as it is
        dtype = self.time_text_embed.timestep_embedder.linear_1.bias.dtype
        B = hidden_states.shape[0]
        device = hidden_states.device
        x = self.x_embedder(hidden_states.to(dtype))
        context = self.context_embedder(encoder_hidden_states.to(dtype))
        t = torch.as_tensor(timestep, dtype=torch.float32, device=device).reshape(-1).expand(B)
        if cfg.guidance_embeds and guidance is None:
            guidance = DEV_GUIDANCE
        temb = self.time_text_embed(t, pooled_projections, guidance, dtype)
        ids = torch.cat([torch.as_tensor(txt_ids, device=device).reshape(-1, 3).float(),
                         torch.as_tensor(img_ids, device=device).reshape(-1, 3).float()])
        cos, sin = rope_freqs(ids[None], cfg.axes_dims_rope)  # [1, S, D]: the rows share their ids

        def run(block, *args):
            if remat_blocks and torch.is_grad_enabled():
                ctx = remat_context or nullcontext
                return checkpoint(block, *args, use_reentrant=False, context_fn=lambda: (nullcontext(), ctx()))
            return block(*args)

        for block in self.transformer_blocks:
            x, context = run(block, x, context, temb, cos, sin)
        combined = torch.cat([context, x], dim=1)  # text first
        for block in self.single_transformer_blocks:
            combined = run(block, combined, temb, cos, sin)
        x = combined[:, context.shape[1]:]
        return self.proj_out(self.norm_out(x, temb))
