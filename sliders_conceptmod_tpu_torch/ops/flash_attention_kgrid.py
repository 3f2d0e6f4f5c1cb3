"""K-grid flash attention on Hopper — kernel K4a, the port of the TPU Pallas
kernel ``sliders_conceptmod_tpu/ops/flash_attention_kgrid.py::_fwd_kernel``
(launched by ``_flash_fwd_impl``).

K4a (``csrc/flash_attention_kgrid.cu``) computes what K1 computes — ``O =
softmax(scale·QKᵀ)·V`` and the fp32 row logsumexp, bidirectional, fp32 math,
output in the input dtype — for the head dims K1 does not take: multiples of
64 up to 512. Its path is the VAE mid-block's single-head attention (head dim
= channels = 512): 4096 tokens in the encoder at 512px, 16384 in the decoder
at 1024px.

The TPU kernel carries (m, l, acc) in scratch along a sequential k grid axis.
On the card the key range is split across blocks: each split runs the online
softmax over its 32-key tiles and writes unnormalised fp32 partials, and a
second small kernel merges them (``m* = max mₛ``, ``l* = Σ lₛ·e^(mₛ−m*)``,
``O = Σ accₛ·e^(mₛ−m*) / l*``, ``lse = m* + log l*``). The split count is
chosen from the shape (:func:`pick_splits`) so that enough blocks fill the
H100's 132 SMs; ``splits=`` exists so that tests can force 1 or more. The
source's header says what bounds the kernel and what its design does about
it. It is built with the other kernels (``ops/flash_attention.py::build``).

:func:`flash_attention_kgrid_reference` is its plain PyTorch version, doing
the same split-and-merge math over the same key ranges. The wrapper
:func:`flash_attention_kgrid_fwd` takes it only for CPU tensors; a CUDA
tensor launches the kernel or raises. ``flash_attention_kgrid_fwd.launches``
counts the kernel's launches (one per call, merge included) and
``flash_attention_kgrid_reference.cuda_calls`` the plain version's calls on
CUDA tensors.

The backward (the TPU package's K4b / K4c) is not ported yet (ROADMAP.md
queue 2): a call that autograd would have to differentiate raises.

Layout: BSHD ``[batch, seq, heads, head_dim]``, any batch/seq/head strides,
unit stride over the head dim.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from sliders_conceptmod_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    _check,
    _check_kernel_inputs,
    _library,
    _stream,
    _strides,
)

BQ, BK = 32, 32  # the kernel's q rows per block and keys per tile
KGRID_HEAD_DIMS = tuple(range(64, 513, 64))
MAX_SPLITS = 64
# two waves of blocks over the H100's 132 SMs, and at least 4 key tiles per split
TARGET_BLOCKS = 2 * 132
MIN_TILES_PER_SPLIT = 4
NEG_INF = -1e30  # as in the kernel: exp(NEG_INF − m) is an exact 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_splits(bh: int, sq: int, sk: int) -> int:
    """The launcher's split count for ``bh`` = batch·heads rows of ``sq``
    queries over ``sk`` keys: 1 when the (q tile, batch·head) blocks already
    fill two waves of the card, else enough splits to reach that, each with
    at least 4 key tiles, at most 64."""
    blocks = _cdiv(sq, BQ) * bh
    if blocks >= TARGET_BLOCKS:
        return 1
    by_keys = _cdiv(sk, BK) // MIN_TILES_PER_SPLIT
    return max(1, min(_cdiv(TARGET_BLOCKS, blocks), by_keys, MAX_SPLITS))


def split_ranges(sk: int, splits: int) -> List[Tuple[int, int]]:
    """The key range ``[lo, hi)`` of each split, as the kernel cuts them:
    ``ceil(tiles / splits)`` 32-key tiles each, the last ones possibly
    empty."""
    per = _cdiv(_cdiv(sk, BK), splits) * BK
    return [(min(sk, s * per), min(sk, (s + 1) * per)) for s in range(splits)]


def flash_attention_kgrid_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, splits: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4a: per split, fp32 logits, the split's max
    m, l = Σ e^(s−m) and acc = e^(s−m)·V (an empty split gives m = −1e30,
    l = 0, acc = 0); then the merge. Output in the input dtype, lse fp32
    ``[B·H, Sq]``."""
    if q.device.type == "cuda":
        flash_attention_kgrid_reference.cuda_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = pick_splits(b * h, sq, sk)
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    ms, ls, accs = [], [], []
    for lo, hi in split_ranges(sk, splits):
        if lo == hi:
            ms.append(torch.full((b, h, sq), NEG_INF, device=q.device))
            ls.append(torch.zeros((b, h, sq), device=q.device))
            accs.append(torch.zeros((b, h, sq, d), device=q.device))
            continue
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, lo:hi])
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p, vf[:, lo:hi]))
    m_all = torch.stack(ms)
    m_star = m_all.amax(dim=0)
    w = torch.exp(m_all - m_star)
    l_star = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
    out = (acc / l_star[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m_star + torch.log(l_star)).reshape(b * h, sq)
    return out, lse


flash_attention_kgrid_reference.cuda_calls = 0


def flash_attention_kgrid_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None, *,
    splits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional attention, BSHD. Returns ``(out [B,Sq,H,D], lse [B·H,Sq])``.

    CPU tensors go through :func:`flash_attention_kgrid_reference`. CUDA
    tensors launch kernel K4a on the current stream (plus its merge when the
    key range is split); the head dim must be a multiple of 64 up to 512, the
    dtype float32 or bfloat16, and the head-dim stride 1. ``splits`` forces
    the split count (tests); ``None`` lets :func:`pick_splits` choose."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "the backward of the k-grid attention (K4b/K4c) is not ported yet (ROADMAP.md queue 2)")
    if q.device.type == "cpu":
        return flash_attention_kgrid_reference(q, k, v, scale, splits)
    _check_kernel_inputs(q, k, v, head_dims=KGRID_HEAD_DIMS)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    splits = pick_splits(b * h, sq, sk) if splits is None else int(splits)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in 1..{MAX_SPLITS}, got {splits}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    part_acc = part_m = part_l = None
    if splits > 1:
        part_acc = torch.empty((splits, b * h, sq, d), dtype=torch.float32, device=q.device)
        part_m, part_l = (torch.empty((splits, b * h, sq), dtype=torch.float32, device=q.device) for _ in range(2))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library("kgrid")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_kgrid_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), ptr(part_acc), ptr(part_m),
            ptr(part_l), _DTYPE_CODES[q.dtype], b, h, sq, sk, d, splits, _strides(q, k, v, out), float(scale),
            _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_kgrid_fwd launch failed: cudaError {err}")
    flash_attention_kgrid_fwd.launches += 1
    return out, lse


flash_attention_kgrid_fwd.launches = 0
