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

Sequence parallelism (JAX's rule): inside :func:`sequence_parallel` a
self-attention (q_seq == kv_seq) of at least ``min_seq`` tokens, whose
sequence the axis size (> 1) divides, runs ring attention over the mesh axis
(``parallel/ring_attention.py::sequence_sharded_attention``: each rank's
sequence block through the same kernels, K/V travelling the ring).
Cross-attention and shorter sequences keep the route above.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Optional

import torch
import torch.nn.functional as F

from sliders_conceptmod_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference
from sliders_conceptmod_tpu_torch.ops.flash_attention_kgrid import flash_attention_kgrid_fwd

MAX_KERNEL_HEAD_DIM = 128  # K1
MAX_KGRID_HEAD_DIM = 512  # K4a / K4b / K4c

# the active (mesh, axis_name, min_seq) of sequence_parallel, or None
_SP_CTX = None


@contextmanager
def sequence_parallel(mesh, axis_name: str = "data", min_seq: int = 4096):
    """Route self-attention through ring attention, sequence-sharded over
    ``mesh[axis_name]``, for the calls made inside the block. Only
    self-attention (q_seq == kv_seq) at ``min_seq``+ tokens with a sequence
    divisible by the axis size reroutes; cross-attention against short
    contexts stays local. Every rank of the axis must run the same model
    calls on the same inputs (the ring is a collective)."""
    global _SP_CTX
    old = _SP_CTX
    _SP_CTX = (mesh, axis_name, int(min_seq))
    try:
        yield
    finally:
        _SP_CTX = old


def sequence_parallel_from_config(tpu_cfg):
    """``tpu.sequence_parallel: true`` → the context above on the config's
    mesh; otherwise a no-op context (trainer loops wrap themselves in this)."""
    if not getattr(tpu_cfg, "sequence_parallel", False):
        return nullcontext()
    from sliders_conceptmod_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tpu_cfg.mesh_data, tpu_cfg.mesh_model)
    return sequence_parallel(mesh, min_seq=tpu_cfg.sp_min_seq)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Bidirectional (no-mask) attention, BSHD."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    if _SP_CTX is not None:
        mesh, axis_name, min_seq = _SP_CTX
        n = int(mesh.shape[axis_name])
        q_seq = q.shape[1]
        if n > 1 and q_seq == k.shape[1] and q_seq >= min_seq and q_seq % n == 0:
            from sliders_conceptmod_tpu_torch.parallel.ring_attention import sequence_sharded_attention

            return sequence_sharded_attention(q, k, v, mesh=mesh, scale=scale, axis_name=axis_name)
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
