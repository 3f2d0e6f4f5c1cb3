"""K-grid flash attention on Hopper — kernels K4a (forward), K4b (dQ) and
K4c (dK/dV), the ports of the TPU Pallas kernels of
``sliders_conceptmod_tpu/ops/flash_attention_kgrid.py``: ``_fwd_kernel``
(launched by ``_flash_fwd_impl``), ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (both launched by ``_vjp_bwd``).

K4a (``csrc/flash_attention_kgrid.cu``) computes what K1 computes — ``O =
softmax(scale·QKᵀ)·V`` and the fp32 row logsumexp, bidirectional, output in
the input dtype — for the head dims K1 does not take: multiples of 64 up to
512. bf16 runs on the tensor cores (``wgmma`` fed by TMA, 64 q rows per
block, up to two consumer warpgroups that each own a slice of O's columns;
20 % of the bound at the VAE decode's 16384², d 512, on an NVIDIA H100 80GB
HBM3 at 700 W, ``PERF.md``). fp32 runs K1's fp32 body (``mma.sync`` TF32
three times a product) at 32 q rows per block, with two (d 128) or four
warps sharing each 16-row slab above d 64 (each owning a slice of the head dim:
its partial scores are summed across the slab, its O columns stay in its
registers) and every warp splitting the operands it reads into TF32 halves,
which measured faster here than splitting once per block (``PERF.md``).
K4b and K4c (``csrc/flash_attention_kgrid_bwd.cu``) are
its backward: K4b computes dQ and ``δ = rowsum(dO∘O)`` from K4a's saved O and
lse, K4c dK and dV from δ. bf16 runs them on the tensor cores (``mma.sync``
fed by ``cp.async``, K2's and K3's loops with the gradient columns split
between the warps that share a 16-row slab above d 128), and fp32 runs the
same loops with every product on the tensor cores in fp32 accuracy
(``mma.sync`` TF32 three times a product over operands split into TF32
halves, as fp32 K2/K3), at 32 owned rows a block up to d 256 and 16 above,
with one to eight warps sharing each 16-row slab. Their paths: the VAE
mid-block's single-head attention (head dim = channels = 512; forward only)
and SD1.5's UNet attentions at 1280 channels (8 heads of 160, padded to 192;
forward and, in training and null-text inversion, backward).

The TPU kernels carry their sums in scratch along a sequential grid axis. On
the card that axis becomes a loop inside the block over tiles of rows, and
where the grid is too small for the H100's 132 SMs the loop's range is split
across blocks: K4a splits the key range — in 32-key units for fp32, in
64-key units for bf16 (:func:`split_unit`); each split writes unnormalised
fp32 partials and a second small kernel merges them: ``m* = max mₛ``,
``l* = Σ lₛ·e^(mₛ−m*)``, ``O = Σ accₛ·e^(mₛ−m*) / l*``, ``lse = m* + log
l*``. K4b splits the key range and K4c the query range, both in 32-row
units and in both dtypes: fp32 partials summed in split order by a merge
kernel, no atomics, so two runs give the same bits. :func:`pick_splits`,
:func:`pick_k4b_splits` and :func:`pick_dkv_splits` choose the counts from
the shape and dtype; ``splits=`` exists so that tests can force 1 or more.
The sources' headers say what bounds the kernels and what their design does
about it. They are built with the other kernels
(``ops/flash_attention.py::build``).

Beside the kernels sit their plain PyTorch versions, doing the same math over
the same split ranges: :func:`flash_attention_kgrid_reference` (K4a),
:func:`kgrid_bwd_dq_reference` (K4b) and :func:`kgrid_bwd_dkv_reference`
(K4c), composed in :func:`flash_attention_kgrid_bwd_reference`. A wrapper
takes the plain version only for CPU tensors; a CUDA tensor launches the
kernel or raises. Each wrapper's ``launches`` counts its kernel's launches
(one per call, merge included) and each plain version's ``cuda_calls`` its
calls on CUDA tensors.

Gradients: :class:`FlashAttentionKGrid` is the ``torch.autograd.Function`` —
K4a forward (saving q, k, v, o and lse), K4b then K4c backward;
:func:`flash_attention_kgrid_fwd` goes through it whenever autograd needs a
graph.

Layout: BSHD ``[batch, seq, heads, head_dim]``, any batch/seq/head strides,
unit stride over the head dim.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from sliders_conceptmod_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    _aligned,
    _cdiv,
    _check,
    _check_kernel_inputs,
    _check_splits,
    _fill_splits,
    _library,
    _ptr,
    _stream,
    _strides,
    split_ranges as _split_ranges,
)

BQ, BK = 32, 32  # fp32 K4a's q rows per block and its split unit (keys); the unit of K4b's and K4c's splits
TC_BQ, TC_SPLIT_KEYS = 64, 64  # bf16 K4a's q rows per block and the unit of its key-range split
KGRID_HEAD_DIMS = tuple(range(64, 513, 64))
NEG_INF = -1e30  # as in the kernel: exp(NEG_INF − m) is an exact 0


def split_unit(dtype: torch.dtype) -> int:
    """Keys per unit of K4a's key-range split for inputs of ``dtype``: 32
    for the fp32 kernel (whose 32-, 16- or 8-key tiles divide it), or 64
    for the bf16 kernel (whose 32- or 64-key tiles both divide it)."""
    return TC_SPLIT_KEYS if dtype == torch.bfloat16 else BK


def pick_splits(bh: int, sq: int, sk: int, dtype: torch.dtype = torch.float32) -> int:
    """K4a's split count of the key range for ``bh`` = batch·heads rows of
    ``sq`` queries over ``sk`` keys, as the kernel for ``dtype`` (by default
    the fp32 one) runs them (blocks: one per q tile — 32 rows in fp32, 64 in
    bf16 — and batch·head; tiles: the :func:`split_unit` units of the
    keys)."""
    q_rows = TC_BQ if dtype == torch.bfloat16 else BQ
    return _fill_splits(_cdiv(sq, q_rows) * bh, _cdiv(sk, split_unit(dtype)))


def bwd_rows_per_block(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Rows a K4b/K4c block owns (q rows for dQ, key rows for dK/dV). The
    fp32 kernels: 32 at head dims up to 256, 16 above, where two fp32
    resident tiles of 32 rows and the streamed ring would not fit shared
    memory. The bf16 kernels: 64 up to 128, 32 above. In both, several warps
    (up to four in bf16, eight in fp32) share each 16-row slab and own a
    part of its gradient columns."""
    if dtype == torch.bfloat16:
        return 64 if d <= 128 else 32
    return 32 if d <= 256 else 16


def pick_k4b_splits(bh: int, sq: int, sk: int, d: int, dtype: torch.dtype) -> int:
    """K4b's split count of the key range, as the kernel for ``dtype`` runs
    it (blocks: one per owned q tile — :func:`bwd_rows_per_block` — and
    batch·head; tiles: the 32-key units, both dtypes' unit)."""
    return _fill_splits(_cdiv(sq, bwd_rows_per_block(d, dtype)) * bh, _cdiv(sk, BK))


def pick_dkv_splits(bh: int, sq: int, sk: int, d: int, dtype: torch.dtype = torch.float32) -> int:
    """K4c's split count of the query range, as the kernel for ``dtype`` (by
    default the fp32 one) runs it (blocks: one per owned key tile and
    batch·head; tiles: the 32-row q tiles, both dtypes' unit)."""
    return _fill_splits(_cdiv(sk, bwd_rows_per_block(d, dtype)) * bh, _cdiv(sq, BQ))


def split_ranges(n: int, splits: int) -> List[Tuple[int, int]]:
    """The range ``[lo, hi)`` of each split of a length-``n`` axis, as K4b
    and K4c cut them: ``ceil(tiles / splits)`` 32-row tiles each, the last
    ones possibly empty."""
    return _split_ranges(n, splits, BK)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_attention_kgrid_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, splits: Optional[int] = None,
    cut_as: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4a: per split, fp32 logits, the split's max
    m, l = Σ e^(s−m) and acc = e^(s−m)·V (an empty split gives m = −1e30,
    l = 0, acc = 0); then the merge. The key range is cut as the kernel for
    ``cut_as`` (default: q's dtype) cuts it — :func:`split_unit`, and
    :func:`pick_splits` when ``splits`` is None. Output in the input dtype,
    lse fp32 ``[B·H, Sq]``."""
    if q.device.type == "cuda":
        flash_attention_kgrid_reference.cuda_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    cut_as = q.dtype if cut_as is None else cut_as
    if splits is None:
        splits = pick_splits(b * h, sq, sk, cut_as)
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    ms, ls, accs = [], [], []
    for lo, hi in _split_ranges(sk, splits, split_unit(cut_as)):
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


def kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale, splits: Optional[int] = None,
                           cut_as: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4b: ``(dQ in q's dtype, δ fp32 [B·H, Sq])``, with
    the scores recomputed from the pre-scaled q as K4a computes them. Per
    split of the key range (:func:`split_ranges`; ``None``: what
    :func:`pick_k4b_splits` gives the kernel for ``cut_as``, by default q's
    dtype), the unscaled fp32 partial ``Σ dS·K`` over the split's keys;
    the partials summed in split order, then scaled, as the kernel's merge
    sums them. One split is the unsplit formula."""
    if q.device.type == "cuda":
        kgrid_bwd_dq_reference.cuda_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = pick_k4b_splits(b * h, sq, sk, d, q.dtype if cut_as is None else cut_as)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)  # [B, H, Sq]
    qs, gf, kf, vf = q.float() * scale, do.float(), k.float(), v.float()
    lse4 = lse.reshape(b, h, sq, 1)
    dq = None
    for lo, hi in split_ranges(sk, splits):
        if lo == hi:
            continue
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, kf[:, lo:hi]) - lse4)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf[:, lo:hi])
        ds = p * (dp - delta[..., None])
        part = torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, lo:hi])
        dq = part if dq is None else dq + part
    return (dq * scale).to(q.dtype), delta.reshape(b * h, sq)


kgrid_bwd_dq_reference.cuda_calls = 0


def kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits: Optional[int] = None,
                            cut_as: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4c: per split of the query range (:func:`split_ranges`;
    ``None``: what :func:`pick_dkv_splits` gives the kernel for ``cut_as``,
    by default q's dtype), fp32 partial ``dK = Σ dSᵀ·(scale·Q)`` and ``dV =
    Σ Pᵀ·dO`` (an empty split adds nothing), summed in split order; then
    ``(dK, dV)`` in k's / v's dtype."""
    if q.device.type == "cuda":
        kgrid_bwd_dkv_reference.cuda_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = pick_dkv_splits(b * h, sq, sk, d, q.dtype if cut_as is None else cut_as)
    qs, kf, vf, gf = q.float() * scale, k.float(), v.float(), do.float()
    lse4, delta4 = lse.reshape(b, h, sq, 1), delta.reshape(b, h, sq, 1)
    dk = torch.zeros((b, sk, h, d), device=q.device)
    dv = torch.zeros((b, sk, h, d), device=q.device)
    for lo, hi in split_ranges(sq, splits):
        if lo == hi:
            continue
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs[:, lo:hi], kf) - lse4[:, :, lo:hi])
        dp = torch.einsum("bqhd,bkhd->bhqk", gf[:, lo:hi], vf)
        ds = p * (dp - delta4[:, :, lo:hi])
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qs[:, lo:hi])
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, gf[:, lo:hi])
    return dk.to(k.dtype), dv.to(v.dtype)


kgrid_bwd_dkv_reference.cuda_calls = 0


def flash_attention_kgrid_bwd_reference(q, k, v, o, lse, do, scale, splits: Optional[int] = None
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward (K4b then K4c): fp32 math with P
    recomputed from the forward's lse; gradients in the inputs' dtypes."""
    dq, delta = kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale)
    dk, dv = kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, splits: Optional[int]
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a (or its plain version for CPU tensors), without autograd."""
    if q.device.type == "cpu":
        return flash_attention_kgrid_reference(q, k, v, scale, splits)
    _check_kernel_inputs(q, k, v, head_dims=KGRID_HEAD_DIMS)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    splits = _check_splits(pick_splits(b * h, sq, sk, q.dtype) if splits is None else splits)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)  # TMA (bf16) and 16-byte loads (fp32)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    part_acc = part_m = part_l = None
    if splits > 1:
        part_acc = torch.empty((splits, b * h, sq, d), dtype=torch.float32, device=q.device)
        part_m, part_l = (torch.empty((splits, b * h, sq), dtype=torch.float32, device=q.device) for _ in range(2))
    lib = _library("kgrid")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_kgrid_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(part_acc), _ptr(part_m),
            _ptr(part_l), _DTYPE_CODES[q.dtype], b, h, sq, sk, d, splits, _strides(q, k, v, out), float(scale),
            _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_kgrid_fwd launch failed: cudaError {err}")
    flash_attention_kgrid_fwd.launches += 1
    return out, lse


def flash_attention_kgrid_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None, *,
    splits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional attention, BSHD. Returns ``(out [B,Sq,H,D], lse [B·H,Sq])``.

    CPU tensors go through :func:`flash_attention_kgrid_reference`. CUDA
    tensors launch kernel K4a on the current stream (plus its merge when the
    key range is split); the head dim must be a multiple of 64 up to 512, the
    dtype float32 or bfloat16, and the head-dim stride 1. ``splits`` forces
    the split count (tests); ``None`` lets :func:`pick_splits` choose for the
    inputs' dtype. When autograd needs a graph the call goes through
    :class:`FlashAttentionKGrid`: ``out`` is differentiable (K4b/K4c),
    ``lse`` is not."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionKGrid.apply(q, k, v, float(scale), splits)
    return _fwd(q, k, v, scale, splits)


flash_attention_kgrid_fwd.launches = 0


def flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale, *, splits: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4b: ``(dQ [B,Sq,H,D] in q's dtype, δ fp32 [B·H, Sq])`` from K4a's O and
    lse. Both dtypes run the tensor-core kernel (fp32 as 3×TF32) over
    ``splits`` ranges of the key axis (plus the sum of their partials when
    there are more than one); ``None`` lets :func:`pick_k4b_splits` choose
    for the inputs' dtype, a number forces it (tests). CPU tensors go
    through :func:`kgrid_bwd_dq_reference`."""
    if q.device.type == "cpu":
        return kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale, splits)
    _check_kernel_inputs(q, k, v, o, do, head_dims=KGRID_HEAD_DIMS)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    splits = _check_splits(pick_k4b_splits(b * h, sq, sk, d, q.dtype) if splits is None else splits)
    q, k, v, o, do = _aligned(q), _aligned(k), _aligned(v), _aligned(o), _aligned(do)  # 16-byte loads
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    part_dq = None
    if splits > 1:
        part_dq = torch.empty((splits, b * h, sq, d), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    lib = _library("kgrid_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_kgrid_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _ptr(part_dq), _DTYPE_CODES[q.dtype], b, h, sq, sk, d, splits,
            _strides(q, k, v, o, do, dq), float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_kgrid_bwd_dq launch failed: cudaError {err}")
    flash_attention_kgrid_bwd_dq.launches += 1
    return dq, delta


flash_attention_kgrid_bwd_dq.launches = 0


def flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale, *, splits: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4c: ``(dK, dV)`` in k's / v's dtype, from K4b's δ (plus the sum of
    the splits' partials when the query range is split). Both dtypes run
    the tensor-core kernel (fp32 as 3×TF32) and split in 32-row units.
    ``splits`` forces the split count (tests); ``None`` lets
    :func:`pick_dkv_splits` choose for the inputs' dtype. CPU tensors go
    through :func:`kgrid_bwd_dkv_reference`."""
    if q.device.type == "cpu":
        return kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits)
    _check_kernel_inputs(q, k, v, do, head_dims=KGRID_HEAD_DIMS)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    splits = _check_splits(pick_dkv_splits(b * h, sq, sk, d, q.dtype) if splits is None else splits)
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)  # cp.async's 16-byte loads
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    part_dk = part_dv = None
    if splits > 1:
        part_dk, part_dv = (torch.empty((splits, b * h, sk, d), dtype=torch.float32, device=q.device)
                            for _ in range(2))
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _library("kgrid_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_kgrid_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(part_dk), _ptr(part_dv), _DTYPE_CODES[q.dtype], b, h, sq, sk, d,
            splits, _strides(q, k, v, do, dk, dv), float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_kgrid_bwd_dkv launch failed: cudaError {err}")
    flash_attention_kgrid_bwd_dkv.launches += 1
    return dk, dv


flash_attention_kgrid_bwd_dkv.launches = 0


def flash_attention_kgrid_bwd(q, k, v, o, lse, do, scale, *, splits: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_kgrid_fwd`: K4b (dQ and δ), then
    K4c (dK, dV) on the same stream, so K4c reads the δ that K4b wrote. CPU
    tensors go through the plain versions."""
    dq, delta = flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
    return dq, dk, dv


class FlashAttentionKGrid(torch.autograd.Function):
    """K4a forward, K4b + K4c backward. ``apply(q, k, v, scale, splits) →
    (out, lse)``; ``splits`` is K4a's (None: the launcher's choice); lse is
    returned for the caller and is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, splits):
        out, lse = _fwd(q, k, v, scale, splits)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if d_out.stride(-1) != 1:  # the kernels read dO with unit head-dim stride
            d_out = d_out.contiguous()
        dq, dk, dv = flash_attention_kgrid_bwd(q, k, v, o, lse, d_out, ctx.scale)
        return dq, dk, dv, None, None
