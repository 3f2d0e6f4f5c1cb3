"""JPEG 2000 inverse wavelet transforms as OpenJPEG 2.5's ``dwt.c`` runs
them, for ``io/jpeg2000.py``: level by level from the lowest resolution,
each level a horizontal pass over every row, then a vertical pass over every
column, each 1-D pass a lifting over the interleaved low-pass and
high-pass samples with whole-sample symmetric extension at both ends; the
parity of the resolution's first coordinate says which samples are low-pass.

* Reversible 5/3 in integers: ``x[2n] −= ⌊(x[2n−1] + x[2n+1] + 2) / 4⌋``,
  then ``x[2n+1] += ⌊(x[2n] + x[2n+2]) / 2⌋``; a lone high-pass sample is
  halved with C's truncation.
* Irreversible 9/7 in float32, in OpenJPEG's order of operations and with
  its constants: low-pass × K and high-pass × 1.625732422 (OpenJPEG's
  ``two_invK``), then four lifting steps, each ``x += (left + right) · c``
  with ``c`` the negated δ, γ, β and α. A lone sample is left as it is.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)


def _interleave(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Rows of ``[low (sn) | high]`` → rows of samples in place order."""
    n = a.shape[1]
    x = np.empty_like(a)
    x[:, cas::2] = a[:, :sn]
    x[:, 1 - cas :: 2] = a[:, sn:n]
    return x


def _neighbours(x: np.ndarray, first: int) -> Tuple[np.ndarray, np.ndarray]:
    """The left and right neighbours of the samples at ``first``,
    ``first + 2``, ..., mirrored at both ends."""
    n = x.shape[1]
    idx = np.arange(first, n, 2)
    left = np.where(idx - 1 >= 0, idx - 1, idx + 1)
    right = np.where(idx + 1 < n, idx + 1, idx - 1)
    return x[:, left], x[:, right]


def _idwt53_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    if n == 1:
        if cas == 0:
            return a
        v = a
        return np.where(v < 0, -((-v) >> 1), v >> 1)
    x = _interleave(a, sn, cas)
    lo, hi = cas, 1 - cas
    left, right = _neighbours(x, lo)
    x[:, lo::2] -= (left + right + 2) >> 2
    left, right = _neighbours(x, hi)
    x[:, hi::2] += (left + right) >> 1
    return x


def _idwt97_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return a
    x = _interleave(a, sn, cas)
    lo, hi = cas, 1 - cas
    x[:, lo::2] *= _K
    x[:, hi::2] *= _TWO_INV_K
    for first, c in ((lo, -_DELTA), (hi, -_GAMMA), (lo, -_BETA), (hi, -_ALPHA)):
        left, right = _neighbours(x, first)
        x[:, first::2] = x[:, first::2] + (left + right) * c
    return x


def inverse(tile: np.ndarray, resolutions: List[Tuple[int, int, int, int]], reversible: bool) -> np.ndarray:
    """``tile`` ``[h, w]`` (int64 for 5/3, float32 for 9/7) holding every
    subband in place, ``resolutions`` each (x0, y0, x1, y1) from the lowest
    → the reconstructed samples, in place."""
    one_d = _idwt53_rows if reversible else _idwt97_rows
    for r in range(1, len(resolutions)):
        px0, py0, px1, py1 = resolutions[r - 1]
        x0, y0, x1, y1 = resolutions[r]
        rw, rh = x1 - x0, y1 - y0
        sn_h, sn_v = px1 - px0, py1 - py0
        if rw == 0 or rh == 0:
            continue
        tile[:rh, :rw] = one_d(tile[:rh, :rw], sn_h, x0 % 2)
        tile[:rh, :rw] = one_d(tile[:rh, :rw].T, sn_v, y0 % 2).T
    return tile
