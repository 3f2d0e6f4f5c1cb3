"""Ring attention: sequence parallelism over the mesh's data axis —
counterpart of ``sliders_conceptmod_tpu/parallel/ring_attention.py``.

Bidirectional attention with q, k and v sequence-sharded over a group of n
ranks (Liu et al., arXiv 2310.01889). Each rank keeps its query block; the
K/V blocks travel the ring, one point-to-point hop per step
(``mesh.ring_exchange``), n steps.

* Blocks: each (query block, K/V block) pair runs the kernel the port's
  dispatch rule picks for the head dim (``ops/attention.py``): K1 for
  d <= 128, K4a for 129 <= d <= 512, the head dim zero-padded to a multiple
  of 64 as the dispatch pads it. JAX's block is plain ``jnp``; on the card
  the port's block is its kernel, never SDPA. CPU tensors take the kernels'
  plain versions, as every wrapper does.
* The merge: the blocks' outputs merge by their row logsumexp, in fp32
  plain torch ops (not a TPU kernel in JAX either):
  ``lse = logaddexp(lse_a, lse_b)``, ``o = o_a·e^(lse_a−lse) + o_b·e^(lse_b−lse)``.
* Backward (:class:`RingAttention`), the reverse ring: K2 (K4b) gives each
  block's dQ from the global lse and the merged O, so δ = rowsum(dO∘O) is of
  the final output; K3 (K4c) gives each block's dK and dV, summed in fp32 in
  a buffer that travels with its block and is back with its owner after n
  hops.

Numerics: exact softmax attention (the lse merge is exact); bf16 blocks
round each block's output and gradients to bf16 before the fp32 merge.
Layout: BSHD ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as fk
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.parallel.mesh import DATA_AXIS

MAX_K1_HEAD_DIM = 128  # K1/K2/K3; above it K4a/K4b/K4c, up to 512
MAX_KGRID_HEAD_DIM = 512


def _block_fwd(q, k, v, scale):
    """One block: ``(o in q's dtype, lse fp32 [B·H, Sq])`` — K1 or K4a."""
    if q.shape[-1] <= MAX_K1_HEAD_DIM:
        return fa._fwd(q, k, v, scale)
    return fk._fwd(q, k, v, scale, None)


def _block_bwd(q, k, v, o, lse, do, scale):
    """One block's ``(dq, dk, dv)`` against the global lse and merged O: K2
    then K3, or K4b then K4c."""
    if q.shape[-1] <= MAX_K1_HEAD_DIM:
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
    else:
        dq, delta = fk.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fk.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale)
    return dq, dk, dv


def _rows(lse: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``[B·H, Sq]`` → ``[B, Sq, H, 1]``, to scale BSHD rows."""
    return lse.reshape(b, h, -1).permute(0, 2, 1).unsqueeze(-1)


def merge_blocks(o_acc, lse_acc, o_blk, lse_blk):
    """The lse merge of two partial attentions (fp32)."""
    b, _, h, _ = o_blk.shape
    if o_acc is None:
        return o_blk.float(), lse_blk
    lse = torch.logaddexp(lse_acc, lse_blk)
    o = o_acc * torch.exp(_rows(lse_acc - lse, b, h)) + o_blk.float() * torch.exp(_rows(lse_blk - lse, b, h))
    return o, lse


class RingAttention(torch.autograd.Function):
    """``apply(q, k, v, scale, ranks, group) → out``: this rank's blocks in,
    this rank's output block out; the backward is the reverse ring."""

    @staticmethod
    def forward(ctx, q, k, v, scale, ranks, group):
        n = len(ranks)
        o, lse = None, None
        kc, vc = k, v
        for step in range(n):
            o_blk, lse_blk = _block_fwd(q, kc, vc, scale)
            o, lse = merge_blocks(o, lse, o_blk, lse_blk)
            if step < n - 1:
                kc, vc = mesh_lib.ring_exchange([kc, vc], ranks, group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.ranks, ctx.group = scale, ranks, group
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, o, lse = ctx.saved_tensors
        n = len(ctx.ranks)
        do = d_out.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for step in range(n):
            dq_b, dk_b, dv_b = _block_bwd(q, kc, vc, o, lse, do, ctx.scale)
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
            # the partial dK/dV travel with their block: after n hops each is home
            if step < n - 1:
                kc, vc, dk, dv = mesh_lib.ring_exchange([kc, vc, dk, dv], ctx.ranks, ctx.group)
            elif n > 1:
                dk, dv = mesh_lib.ring_exchange([dk, dv], ctx.ranks, ctx.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh, scale: Optional[float] = None,
                   axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Bidirectional attention with q/k/v sequence-sharded over
    ``mesh[axis_name]``: this rank's blocks ``[B, S/n, H, D]`` in, this
    rank's output block out (a one-rank axis: the block itself). The head
    dim is zero-padded to a multiple of 64 for the kernels (padded q·k dims
    add 0; padded V columns are sliced off, and autograd takes the gradient
    back through the pad)."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if d > MAX_KGRID_HEAD_DIM:
        raise NotImplementedError(f"ring attention: head dim {d} > {MAX_KGRID_HEAD_DIM}: no kernel takes it")
    d_pad = ((d + 63) // 64) * 64
    if d_pad != d:
        pad = (0, d_pad - d)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    out = RingAttention.apply(q, k, v, float(scale), tuple(mesh.axis_ranks(axis_name)), mesh.group(axis_name))
    return out[..., :d] if d_pad != d else out


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh, scale: float,
                               axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Attention over a whole sequence that every rank of the axis holds
    alike, its work shared by the ring: each rank takes its sequence block
    of q, k and v (the backward gathers their gradients), runs
    :func:`ring_attention`, and the output blocks are gathered along the
    sequence (the backward keeps this rank's block of the gradient). The
    dispatch's route under :func:`ops.attention.sequence_parallel`."""
    n, i, group = mesh.shape[axis_name], mesh.axis_index(axis_name), mesh.group(axis_name)
    q, k, v = (mesh_lib.ScatterAlong.apply(t, 1, i, n, group) for t in (q, k, v))
    out = ring_attention(q, k, v, mesh=mesh, scale=scale, axis_name=axis_name)
    return mesh_lib.GatherAlong.apply(out, 1, i, n, group)
