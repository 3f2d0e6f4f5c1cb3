"""Normalisation layers that take their statistics in fp32 whatever the
compute dtype, and return the input's dtype (the JAX models' ``GroupNorm`` /
``LayerNorm`` with fp32 statistics followed by a cast back)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm32(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class RMSNorm(nn.Module):
    """Scale-only RMS norm (T5's layer norm, Flux's q/k norms, the JAX
    ``RMSNorm`` / ``T5LayerNorm``): ``x · rsqrt(mean(x²) + eps)`` with the
    statistics in fp32, cast to the scale's dtype, then times the scale. The
    scale is ``weight`` here (diffusers' and transformers' name) and
    ``scale`` in the JAX tree."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.pow(2).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)).to(self.weight.dtype) * self.weight
