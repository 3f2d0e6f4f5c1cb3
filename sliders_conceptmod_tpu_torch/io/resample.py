"""Pillow's default image resize, in numpy: ``Image.resize((w, h))`` of an
8-bit RGB image, which the JAX image-pair loader calls
(``train/imageslider.py::load_image_array``). The GPU machine has no PIL.

Pillow (``libImaging/Resample.c``) resizes RGB with its bicubic filter
(a = −0.5, support 2), widened by the scale factor when it shrinks (the
antialiasing), in two separable passes — horizontal, then vertical — each
rounded to uint8. The coefficients are computed in double, normalised per
output pixel, and turned into fixed-point integers with 22 fractional bits
(``PRECISION_BITS``); each output is the integer sum plus one half, shifted
and clipped. This module mirrors those steps and their order, so its output
is Pillow's bit for bit. ``torch.nn.functional.interpolate``'s bicubic is a
different filter (a = −0.75, no antialiasing by default).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0  # the bicubic filter's
_A = -0.5


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * _A
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index ``[out]``, fixed-point weights ``[out, ksize]``)
    of one axis, as Pillow's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` make them (weights past an output's window are 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # Pillow sums the weights in tap order
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)), np.trunc(0.5 + w * (1 << PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of ``img`` (``[H, W, C]`` uint8) along ``axis``."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], in_size - 1)  # clipped taps weigh 0
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, other, C]
    acc = np.einsum("okxc,ok->oxc", src[idx], k) + (1 << (PRECISION_BITS - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_like_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``uint8 [H, W, C]`` → ``[h, w, C]`` for ``size`` = (w, h), as Pillow's
    ``Image.fromarray(img).resize(size)`` with its default (bicubic) filter
    gives it for an RGB or grey image. An image already at ``size`` is
    returned as a copy, as Pillow returns one."""
    w, h = size
    out = np.array(img, dtype=np.uint8, copy=True)
    if out.shape[1] != w:
        out = _resample_axis(out, w, axis=1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, axis=0)
    return out
