"""AutoencoderKL — counterpart of ``sliders_conceptmod_tpu/models/vae.py``:
the decoder that serving runs and the encoder that the image-pair trainer
runs (``encode`` → posterior mean and clipped log-variance,
:func:`sample_latents`), NCHW throughout.

The mid-block attention is single-head over the spatial tokens with head dim
= channels (512 for SD and SDXL), so on the card it runs kernel K4a through the
dispatch (head dims 129..512; see ops/attention.py): 4096 tokens in the
encoder at 512px, 16384 in the decoder at 1024px.

Module order: the decoder and ``post_quant_conv`` are registered before the
encoder and ``quant_conv``, so the seeded flax-default initialisation
(``models/factory.py``) gives the decoder the same weights it had before the
encoder was added.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sliders_conceptmod_tpu_torch.models.norms import GroupNorm32
from sliders_conceptmod_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # the flow families' VAEs (SD3 0.0609): x = z / scaling + shift before
    # the decode (infer/generate_flow.py); 0.0 for the epsilon families
    shift_factor: float = 0.0
    # SD3's VAE ships no (post_)quant_conv (diffusers use_quant_conv=false)
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True

    @classmethod
    def sd(cls) -> "VAEConfig":
        """The SD1.x / SD2.x VAE (scaling 0.18215)."""
        return cls()

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        return cls(scaling_factor=0.13025)

    @classmethod
    def sd3(cls) -> "VAEConfig":
        """The 16-channel SD3 VAE: no quant convs, so the encoder's conv_out
        emits the 2·16 moments directly."""
        return cls(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False,
                   use_post_quant_conv=False)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        # two blocks -> 2x downsampling; latents are H/2 (not the SD H/8)
        return cls(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm32(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head spatial self-attention (diffusers Attention in VAE mid)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm32(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = (proj(h)[:, :, None, :] for proj in (self.to_q, self.to_k, self.to_v))
        out = self.to_out[0](dot_product_attention(q, k, v)[:, :, 0, :])
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEDownsample(nn.Module):
    """diffusers' VAE downsample: an asymmetric (0, 1, 0, 1) pad, then a
    stride-2 VALID 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class DownEncoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, add_downsample: bool, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups) for i in range(num_layers)
        )
        self.downsamplers = nn.ModuleList([VAEDownsample(out_ch)]) if add_downsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, add_upsample: bool, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups) for i in range(num_layers)
        )
        self.upsamplers = nn.ModuleList([VAEUpsample(out_ch)]) if add_upsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(VAEResnetBlock(channels, channels, groups) for _ in range(2))
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    """Images → the 2·latent_channels posterior moments (before quant_conv)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownEncoderBlock(chs[max(i - 1, 0)], ch, cfg.layers_per_block, i < len(chs) - 1, g)
            for i, ch in enumerate(chs)
        )
        self.mid_block = MidBlock(chs[-1], g)
        self.conv_norm_out = GroupNorm32(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList(
            UpDecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, i < len(rev) - 1, g)
            for i, ch in enumerate(rev)
        )
        self.conv_norm_out = GroupNorm32(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """NCHW images in [-1, 1] ↔ NCHW latents. ``encode`` returns (mean,
    logvar); :func:`sample_latents` draws from them."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        # decoder first: see the module docstring
        self.decoder = Decoder(config)
        self.post_quant_conv = (
            nn.Conv2d(config.latent_channels, config.latent_channels, 1) if config.use_post_quant_conv else None
        )
        self.encoder = Encoder(config)
        self.quant_conv = (
            nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1) if config.use_quant_conv else None
        )

    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images → (mean, logvar clipped to [−30, 20]), each ``[B, C, h, w]``
        in the weights' dtype."""
        moments = self.encoder(images.to(self.encoder.conv_in.weight.dtype))
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents.to(self.decoder.conv_in.weight.dtype)
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    forward = decode


def sample_latents(mean: torch.Tensor, logvar: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample() with the normal draw given:
    ``mean + exp(logvar / 2) · noise``."""
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
