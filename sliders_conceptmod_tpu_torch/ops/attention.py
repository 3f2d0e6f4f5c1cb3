"""Attention dispatch: the Hopper flash kernels for CUDA tensors, plain elsewhere.

Counterpart of ``sliders_conceptmod_tpu/ops/attention.py``. Layout is BSHD
``[batch, seq, heads, head_dim]`` throughout.

Dispatch rule (H100), by head dim d:

* d <= 128: kernel K1
  (:func:`~sliders_conceptmod_tpu_torch.ops.flash_attention.flash_attention_fwd`)
  at every sequence length; differentiable (K2/K3 backward).
* 128 < d <= 512: kernel K4a
  (:func:`~sliders_conceptmod_tpu_torch.ops.flash_attention_kgrid.flash_attention_kgrid_fwd`);
  differentiable (K4b/K4c backward). In the models these are SD1.5's
  1280-channel UNet attentions (8 heads of 160, padded to 192) and the
  single-head d = 512 VAE mid-block attention.
* d > 512 on a CUDA tensor raises ``NotImplementedError``: no kernel takes it
  yet (ROADMAP.md queue 2). The card's path never falls back to a plain
  version.

Head dims that are not a multiple of 64 are zero-padded up to one (padded q·k
dims add 0 to the scores; padded V columns are sliced off, and the gradient
flows back through the pad), as the JAX dispatch does. The JAX package's TPU
thresholds (its minimum sequence of 2048 and its VMEM limit) are v5e
measurements and do not apply here.

CPU tensors take the same routes, differentiable as on the card; each
wrapper computes them with its kernel's plain version (fp32 logits and
softmax, output in the input dtype), and d > 512 with K1's plain version
(differentiated by torch autograd).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sliders_conceptmod_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference
from sliders_conceptmod_tpu_torch.ops.flash_attention_kgrid import flash_attention_kgrid_fwd

MAX_KERNEL_HEAD_DIM = 128  # K1
MAX_KGRID_HEAD_DIM = 512  # K4a / K4b / K4c


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Bidirectional (no-mask) attention, BSHD."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    if d <= MAX_KERNEL_HEAD_DIM:
        return kernel_attention(q, k, v, scale)
    if d <= MAX_KGRID_HEAD_DIM:
        return _padded(flash_attention_kgrid_fwd, q, k, v, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)[0]
    raise NotImplementedError(f"head dim {d} > {MAX_KGRID_HEAD_DIM} on the card: no kernel takes it yet "
                              "(ROADMAP.md queue 2)")


def _padded(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """``fn`` with the head dim zero-padded up to a multiple of 64."""
    d = q.shape[-1]
    d_pad = ((d + 63) // 64) * 64
    if d_pad != d:
        pad = (0, d_pad - d)
        return fn(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), scale)[0][..., :d]
    return fn(q, k, v, scale)[0]


def kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K1 with the head dim zero-padded up to a multiple of 64."""
    return _padded(flash_attention_fwd, q, k, v, scale)
