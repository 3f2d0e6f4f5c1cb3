"""UNet2DCondition — counterpart of ``sliders_conceptmod_tpu/models/unet.py``
(SD1.5, SD2.1, SDXL and the tiny / tiny-xl test topologies), NCHW throughout.

Module names follow the diffusers module paths (``down_blocks.0.attentions.1.
transformer_blocks.0.attn1.to_out.0``); joining each index onto the name
before it gives the JAX tree's path (``down_blocks_0/.../to_out_0``), so the
LoRA key schema ``lora_unet_<path>`` and the weight bridge line up with the
JAX package. Norm statistics are fp32; matmuls and convs run in the weight
dtype. Every self- and cross-attention goes through
``ops/attention.py::dot_product_attention``: on the card kernel K1 for head
dims up to 128 (SDXL's and SD2.1's 64, SD1.5's 40 and 80) and K4a for
SD1.5's 1280-channel level (8 heads of 160 — diffusers' ``attention_head_dim``
means heads).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sliders_conceptmod_tpu_torch.models.norms import GroupNorm32, LayerNorm32
from sliders_conceptmod_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # per-block num-heads (diffusers' misnamed attention_head_dim)
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None  # "text_time" for SDXL
    addition_time_embed_dim: Optional[int] = None  # 256 for SDXL
    projection_class_embeddings_input_dim: Optional[int] = None  # 2816 for SDXL
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    def heads_for_block(self, i: int) -> int:
        a = self.attention_head_dim
        return a[i] if isinstance(a, (tuple, list)) else a

    def tf_layers_for_block(self, i: int) -> int:
        t = self.transformer_layers_per_block
        return t[i] if isinstance(t, (tuple, list)) else t

    @classmethod
    def sd15(cls) -> "UNetConfig":
        """runwayml/stable-diffusion-v1-5 unet/config.json."""
        return cls()

    @classmethod
    def sd21(cls) -> "UNetConfig":
        """stabilityai/stable-diffusion-2-1: 1024-dim context, per-block head
        counts [5,10,20,20], linear projections (v-prediction is the
        scheduler's)."""
        return cls(
            sample_size=96,
            cross_attention_dim=1024,
            attention_head_dim=(5, 10, 20, 20),
            use_linear_projection=True,
        )

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        """stabilityai/stable-diffusion-xl-base-1.0 unet/config.json."""
        return cls(
            sample_size=128,
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            block_out_channels=(320, 640, 1280),
            cross_attention_dim=2048,
            attention_head_dim=(5, 10, 20),
            transformer_layers_per_block=(1, 2, 10),
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=2816,
        )

    @classmethod
    def tiny(cls, cross_attention_dim: int = 32) -> "UNetConfig":
        """Small config for CPU tests: the SD1.5 topology at tiny widths."""
        return cls(
            sample_size=8,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attention_dim=cross_attention_dim,
            attention_head_dim=4,
            norm_num_groups=8,
        )

    @classmethod
    def tiny_xl(cls, cross_attention_dim: int = 32) -> "UNetConfig":
        """Tiny SDXL-topology config (text_time conditioning) for CPU tests."""
        return cls(
            sample_size=8,
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attention_dim=cross_attention_dim,
            attention_head_dim=4,
            transformer_layers_per_block=1,
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=80,
            norm_num_groups=8,
        )

    def attention_calls_by_head_dim(self) -> Dict[int, int]:
        """Self- plus cross-attention calls in one forward, by head dim
        (SDXL: {64: 140}; SD1.5: {40: 10, 80: 10, 160: 12})."""
        calls: Dict[int, int] = {}

        def add(level: int, transformers: int) -> None:
            d = self.block_out_channels[level] // self.heads_for_block(level)
            calls[d] = calls.get(d, 0) + 2 * transformers * self.tf_layers_for_block(level)

        last = len(self.block_out_channels) - 1
        for i, t in enumerate(self.down_block_types):
            if t == "CrossAttnDownBlock2D":
                add(i, self.layers_per_block)
        add(last, 1)  # the mid block
        for i, t in enumerate(self.up_block_types):
            if t == "CrossAttnUpBlock2D":
                add(last - i, self.layers_per_block + 1)
        return calls

    def attention_calls_per_forward(self) -> int:
        """Self- plus cross-attention calls in one forward (SDXL: 140; SD1.5: 32)."""
        return sum(self.attention_calls_by_head_dim().values())


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, freq_shift: float = 0.0, max_period: int = 10000
) -> torch.Tensor:
    """Sinusoidal embedding, diffusers ``get_timestep_embedding`` semantics."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 → silu → linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm32(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm32(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """to_q/to_k/to_v (no bias) + to_out.0; attention through the dispatch."""

    def __init__(self, query_dim: int, heads: int, cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        kv_dim = query_dim if cross_attention_dim is None else cross_attention_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        B, S, inner = x.shape[0], x.shape[1], self.to_q.out_features
        hd = inner // self.heads
        q = self.to_q(x).view(B, S, self.heads, hd)
        k = self.to_k(context).view(B, context.shape[1], self.heads, hd)
        v = self.to_v(context).view(B, context.shape[1], self.heads, hd)
        out = dot_product_attention(q, k, v).reshape(B, S, inner)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate.float(), approximate="none").to(x.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_attention_dim=cross_attention_dim)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, heads: int, cross_attention_dim: int, num_layers: int = 1,
                 use_linear_projection: bool = False, groups: int = 32):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm32(groups, channels, eps=1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if use_linear_projection else (
            lambda: nn.Conv2d(channels, channels, 1)
        )
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, cross_attention_dim) for _ in range(num_layers)
        )
        self.proj_out = proj()

    def forward(self, x, context):
        B, C, H, W = x.shape
        residual = x
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + residual


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class DownBlock2D(nn.Module):
    """Resnets (+ a transformer after each one when ``heads`` is given)."""

    def __init__(self, in_ch: int, out_ch: int, temb: int, num_layers: int, add_downsample: bool, groups: int,
                 heads: Optional[int] = None, cross_attention_dim: int = 0, transformer_layers: int = 1,
                 use_linear_projection: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb, groups) for i in range(num_layers)
        )
        self.attentions = None
        if heads is not None:
            self.attentions = nn.ModuleList(
                Transformer2DModel(out_ch, heads, cross_attention_dim, transformer_layers, use_linear_projection, groups)
                for _ in range(num_layers)
            )
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None

    def forward(self, x, temb, context):
        outputs = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class UpBlock2D(nn.Module):
    """Skip-concat resnets (+ transformers when ``heads`` is given)."""

    def __init__(self, in_ch: int, out_ch: int, skip_chs, temb: int, add_upsample: bool, groups: int,
                 heads: Optional[int] = None, cross_attention_dim: int = 0, transformer_layers: int = 1,
                 use_linear_projection: bool = False):
        super().__init__()
        chans = [in_ch] + [out_ch] * (len(skip_chs) - 1)
        self.resnets = nn.ModuleList(
            ResnetBlock2D(c + s, out_ch, temb, groups) for c, s in zip(chans, skip_chs)
        )
        self.attentions = None
        if heads is not None:
            self.attentions = nn.ModuleList(
                Transformer2DModel(out_ch, heads, cross_attention_dim, transformer_layers, use_linear_projection, groups)
                for _ in range(len(skip_chs))
            )
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, res_samples, temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, channels: int, temb: int, heads: int, cross_attention_dim: int, transformer_layers: int,
                 use_linear_projection: bool, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock2D(channels, channels, temb, groups) for _ in range(2))
        self.attentions = nn.ModuleList(
            [Transformer2DModel(channels, heads, cross_attention_dim, transformer_layers, use_linear_projection, groups)]
        )

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        g = cfg.norm_num_groups
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = None
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        skip_chs = [ch[0]]
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, bt in enumerate(cfg.down_block_types):
            final = i == len(cfg.down_block_types) - 1
            attn = bt == "CrossAttnDownBlock2D"
            if not attn and bt != "DownBlock2D":
                raise ValueError(f"Unknown down block: {bt}")
            self.down_blocks.append(DownBlock2D(
                prev, ch[i], temb, cfg.layers_per_block, not final, g,
                heads=cfg.heads_for_block(i) if attn else None,
                cross_attention_dim=cfg.cross_attention_dim,
                transformer_layers=cfg.tf_layers_for_block(i),
                use_linear_projection=cfg.use_linear_projection,
            ))
            skip_chs += [ch[i]] * (cfg.layers_per_block + (0 if final else 1))
            prev = ch[i]

        last = len(ch) - 1
        self.mid_block = UNetMidBlock2DCrossAttn(
            ch[-1], temb, cfg.heads_for_block(last), cfg.cross_attention_dim,
            cfg.tf_layers_for_block(last), cfg.use_linear_projection, g,
        )

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        n_layers = cfg.layers_per_block + 1
        for i, bt in enumerate(cfg.up_block_types):
            final = i == len(cfg.up_block_types) - 1
            attn = bt == "CrossAttnUpBlock2D"
            if not attn and bt != "UpBlock2D":
                raise ValueError(f"Unknown up block: {bt}")
            block_skips = list(reversed(skip_chs[-n_layers:]))
            del skip_chs[-n_layers:]
            self.up_blocks.append(UpBlock2D(
                prev, rev[i], block_skips, temb, not final, g,
                heads=cfg.heads_for_block(last - i) if attn else None,
                cross_attention_dim=cfg.cross_attention_dim,
                transformer_layers=cfg.tf_layers_for_block(last - i),
                use_linear_projection=cfg.use_linear_projection,
            ))
            prev = rev[i]

        self.conv_norm_out = GroupNorm32(g, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timestep, encoder_hidden_states, added_cond_kwargs: Optional[dict] = None):
        """sample NCHW [B, C, H, W]; timestep scalar or [B];
        encoder_hidden_states [B, S, cross_attention_dim];
        added_cond_kwargs {"text_embeds", "time_ids"} for SDXL."""
        cfg = self.config
        dtype = self.dtype
        B = sample.shape[0]
        x = sample.to(dtype)
        context = encoder_hidden_states.to(dtype)

        if isinstance(timestep, torch.Tensor):
            t = timestep.to(device=x.device, dtype=torch.float32).reshape(-1).expand(B)
        else:  # a host number: a fill, not a host-to-device copy that would sync
            t = torch.full((B,), float(timestep), dtype=torch.float32, device=x.device)
        t_emb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(t_emb.to(dtype))
        if self.add_embedding is not None:
            if added_cond_kwargs is None:
                raise ValueError("XL UNet requires added_cond_kwargs{text_embeds, time_ids}")
            time_ids = added_cond_kwargs["time_ids"]
            time_embeds = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos, cfg.freq_shift
            ).reshape(B, -1)
            add = torch.cat([added_cond_kwargs["text_embeds"].float(), time_embeds], dim=-1)
            emb = emb + self.add_embedding(add.to(dtype))

        x = self.conv_in(x)
        res_samples = [x]
        for block in self.down_blocks:
            x, outs = block(x, emb, context)
            res_samples.extend(outs)
        x = self.mid_block(x, emb, context)
        n_layers = cfg.layers_per_block + 1
        for block in self.up_blocks:
            block_res = res_samples[-n_layers:]
            del res_samples[-n_layers:]
            x = block(x, block_res, emb, context)
        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x)
