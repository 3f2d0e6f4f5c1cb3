"""Flash attention on Hopper — the port of the TPU Pallas kernels, forward and
backward.

Three hand-written CUDA kernels, each replacing one kernel of
``sliders_conceptmod_tpu/ops/flash_attention.py``:

* K1 (``csrc/flash_attention_fwd.cu``) replaces ``_fwd_kernel`` (launched by
  ``_flash_fwd_impl``): ``O = softmax(scale·QKᵀ)·V`` plus the fp32 row
  logsumexp, bidirectional, output in the input dtype.
* K2 (``csrc/flash_attention_bwd.cu``) replaces ``_bwd_dq_kernel``
  (launched by ``_vjp_bwd``): dQ from P recomputed from K1's lse. It also
  computes ``δ = rowsum(dO∘O)``, which the JAX package computes with an XLA
  reduction outside its kernels, and writes it for K3.
* K3 (same source) replaces ``_bwd_dkv_kernel`` (launched by ``_vjp_bwd``):
  dK and dV.

What bounds them on the H100 (K1 does 4·B·H·Sq·Sk·D flops, K2 6·, K3 8·,
at the unpadded head dim, against their tensors moved once): the bf16
tensor-core rate (989 TFLOP/s) at the paths' self-attentions of 1024 and
4096 tokens; the bytes (3.35 TB/s) at the 77-key cross-attentions and at
256 tokens, where a call takes a few microseconds. The designs, by dtype:

* bfloat16 (the paths' dtype), on the tensor cores:

  - K1: ``wgmma`` (S = QKᵀ from shared memory, O += PV with P from
    registers); 128 q rows per block (two warpgroups) against 128-key K/V
    tiles in a 2-stage ring filled by TMA on mbarriers; 80 KB of shared
    memory at d 64, 160 KB at d 128; 127 / 173 registers, no spills; 42 %
    of the bound at serving's 4096², 7–36 % at the other path shapes.
  - K2: ``mma.sync`` m16n8k16 (S = QKᵀ, dP = dOVᵀ, dQ += dSK, dS from
    registers); 64 q rows per block (four warps) against 64-key K/V tiles
    in a 2-stage ``cp.async`` ring; δ = rowsum(dO∘O) in its prologue; 48 /
    96 KB of shared memory; 160 / 232 registers, no spills; 15 % of the
    bound at SDXL's 1024² and SD1.5's 4096², 10–26 % elsewhere.
  - K3: ``mma.sync`` m16n8k16 (Sᵀ = KQᵀ, dV += PᵀdO, dPᵀ = VdOᵀ, dK +=
    dSᵀQ, P and dS from registers); 64 keys per block (four warps) against
    q tiles of 64 rows (d 64) or 32 (d 128) in a 2-stage ``cp.async``
    ring; 49 / 64.5 KB of shared memory; 198 / 241 registers, no spills;
    13 % of the bound at SDXL's 1024², 14–17 % at 4096², 4–12 % elsewhere.

  (ptxas and the device times of ``bench_attention.py``, NVIDIA H100 80GB
  HBM3, 700.00 W; every path shape in ``PERF.md``.) When their grids fill
  less than two waves of the card, K2 splits its key range
  (:func:`pick_k2_splits`) and K3 its query range (:func:`pick_k3_splits`,
  K4c's rule) across blocks: fp32 partials summed in split order by a
  second kernel, no atomics, so two runs give the same bits. TMA and
  ``cp.async`` need 16-byte-aligned bases and row strides: the wrappers
  make one contiguous copy of a bf16 tensor that fails the check
  (:func:`_aligned`).
* float32: the first (SIMT) kernels, fp32 math on the CUDA cores, which
  keep the fp32 bound of 1e-4; K2 and K3 do not split there.

Each CUDA source of the port — these two, K4a's
(``csrc/flash_attention_kgrid.cu``) and K4b/K4c's
(``csrc/flash_attention_kgrid_bwd.cu``), both wrapped in
``ops/flash_attention_kgrid.py`` — is compiled with ``nvcc`` for ``sm_90a``
into a shared library of its own with a plain C interface at first use —
into ``build/kernels/`` at the repository root — and bound with ``ctypes``;
:func:`build` compiles them all at once. The tensor-core kernels share the
building blocks of ``csrc/hopper_tc.cuh``.

Beside the kernels sit their plain PyTorch versions:
:func:`flash_attention_reference` (K1) and :func:`bwd_dq_reference` /
:func:`bwd_dkv_reference` (K2 / K3, over the same key / query splits),
composed in :func:`flash_attention_bwd_reference`. A wrapper takes the plain
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises. Each kernel wrapper's ``launches`` counts its calls that launch the
kernel (K2's and K3's merges included) and nothing else, so a run can show
that its main path went through the kernel; each plain version's
``cuda_calls`` counts its calls on CUDA tensors, so a run can show that its
main path never reached it.

Gradients: :class:`FlashAttention` is the ``torch.autograd.Function`` — K1
forward (saving q, k, v, o and lse), K2 then K3 backward.
:func:`flash_attention_fwd` goes through it whenever autograd needs a graph.

Layout: BSHD ``[batch, seq, heads, head_dim]``. The kernels read strides, so
views such as ``to_q(x).view(B, S, H, D)`` and autograd's gradients go in
without a copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every kernel source of the port; "kgrid" is K4a and "kgrid_bwd" K4b/K4c
# (ops/flash_attention_kgrid.py)
SOURCES = {
    "fwd": CSRC / "flash_attention_fwd.cu",
    "bwd": CSRC / "flash_attention_bwd.cu",
    "kgrid": CSRC / "flash_attention_kgrid.cu",
    "kgrid_bwd": CSRC / "flash_attention_kgrid_bwd.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# exported C functions of each library and their ctypes argument types
_SIGNATURES = {
    "fwd": {"flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_STRIDES, ctypes.c_float, _P]},
    "bwd": {
        "flash_attention_bwd_dq": [_P] * 9 + [_I] * 7 + [_STRIDES, ctypes.c_float, _P],
        "flash_attention_bwd_dkv": [_P] * 10 + [_I] * 7 + [_STRIDES, ctypes.c_float, _P],
    },
    "kgrid": {"flash_attention_kgrid_fwd": [_P] * 8 + [_I] * 7 + [_STRIDES, ctypes.c_float, _P]},
    "kgrid_bwd": {
        "flash_attention_kgrid_bwd_dq": [_P] * 9 + [_I] * 7 + [_STRIDES, ctypes.c_float, _P],
        "flash_attention_kgrid_bwd_dkv": [_P] * 10 + [_I] * 7 + [_STRIDES, ctypes.c_float, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
build_info: Dict[str, dict] = {}  # per source name: path, seconds, cached, ptxas

# Splitting a kernel's sequential loop across blocks (K2 and K3 here, K4a,
# K4b and K4c in ops/flash_attention_kgrid.py): two waves of blocks over the
# H100's 132 SMs, at least 4 loop tiles per split, at most 64 splits.
MAX_SPLITS = 64
TARGET_BLOCKS = 2 * 132
MIN_TILES_PER_SPLIT = 4
K2_TILE = 64  # K2's q rows per block, and the unit of its key-range split
K3_TILE = 64  # K3's keys per block, and the unit of its query-range split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fill_splits(blocks: int, tiles: int) -> int:
    """1 when ``blocks`` already fill two waves of the card, else enough
    splits of the ``tiles``-long loop to reach that, each with at least 4
    tiles, at most 64."""
    if blocks >= TARGET_BLOCKS:
        return 1
    return max(1, min(_cdiv(TARGET_BLOCKS, blocks), tiles // MIN_TILES_PER_SPLIT, MAX_SPLITS))


def split_ranges(n: int, splits: int, tile: int) -> List[Tuple[int, int]]:
    """The range ``[lo, hi)`` of each split of a length-``n`` axis, as the
    kernels cut them: ``ceil(tiles / splits)`` ``tile``-row tiles each, the
    last ones possibly empty."""
    per = _cdiv(_cdiv(n, tile), splits) * tile
    return [(min(n, s * per), min(n, (s + 1) * per)) for s in range(splits)]


def _check_splits(splits: int) -> int:
    splits = int(splits)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in 1..{MAX_SPLITS}, got {splits}")
    return splits


def pick_k2_splits(bh: int, sq: int, sk: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """K2's split count of the key range for ``bh`` = batch·heads (blocks:
    one per 64-row q tile and batch·head; tiles: the 64-key units). The fp32
    kernel does not split: 1."""
    if dtype == torch.float32:
        return 1
    return _fill_splits(_cdiv(sq, K2_TILE) * bh, _cdiv(sk, K2_TILE))


def pick_k3_splits(bh: int, sq: int, sk: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """K3's split count of the query range for ``bh`` = batch·heads (blocks:
    one per 64-key tile and batch·head; tiles: the 64-row q units). The fp32
    kernel does not split: 1."""
    if dtype == torch.float32:
        return 1
    return _fill_splits(_cdiv(sk, K3_TILE) * bh, _cdiv(sq, K3_TILE))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the flash-attention kernels cannot be built")
    return found


def set_build_dir(path) -> None:
    """Build the kernels into, and reuse them from, ``path`` (created at the
    first build; ``utils/debug.py::apply_tpu_runtime_flags``'s
    ``compilation_cache_dir``). A library already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _library_path(name: str) -> Path:
    # the source and every header of csrc/ it may include
    src = SOURCES[name].read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{SOURCES[name].stem}_{tag}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile the named sources (all when none is named), once per source
    content, and return ``{name: library path}``.

    One ``nvcc`` per source, all started together. A file name carries a
    hash of its source and flags, so an edited source never loads a stale
    library; each compile writes to a temporary name and renames, so two
    processes compiling at once never load a half-written file."""
    names = names or tuple(SOURCES)
    out, jobs = {}, {}
    for name in names:
        path = _library_path(name)
        out[name] = path
        if path.is_file():
            build_info[name] = dict(path=str(path), seconds=0.0, cached=True)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        jobs[name] = (tmp, time.time(), subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (tmp, t0, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{err[-4000:]}")
            continue
        os.replace(tmp, out[name])
        build_info[name] = dict(path=str(out[name]), seconds=time.time() - t0, cached=False, ptxas=err)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def _library(name: str) -> ctypes.CDLL:
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: fp32 logits and softmax, output in the
    input dtype, lse fp32 ``[B·H, Sq]``."""
    if q.device.type == "cuda":
        flash_attention_reference.cuda_calls += 1
    b, sq, h, _ = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, sq)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    return out, lse


flash_attention_reference.cuda_calls = 0


def bwd_dq_reference(q, k, v, o, lse, do, scale, splits: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``(dQ in q's dtype, δ fp32 [B·H, Sq])``. Per
    split of the key range (:func:`split_ranges` in 64-key units; ``None``:
    :func:`pick_k2_splits` for the inputs' shape and dtype), the fp32 partial
    ``Σ dS·K`` over the split's keys, summed in split order and then scaled,
    as the kernel's merge sums them."""
    if q.device.type == "cuda":
        bwd_dq_reference.cuda_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = pick_k2_splits(b * h, sq, sk, q.dtype)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)  # [B, H, Sq]
    qf, gf, lse4 = q.float(), do.float(), lse.reshape(b, h, sq, 1)
    dq = torch.zeros((b, sq, h, d), device=q.device)
    for lo, hi in split_ranges(sk, splits, K2_TILE):
        if lo == hi:
            continue
        ks, vs = k[:, lo:hi].float(), v[:, lo:hi].float()
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, ks) * scale - lse4)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vs)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, ks)
    return (dq * scale).to(q.dtype), delta.reshape(b * h, sq)


bwd_dq_reference.cuda_calls = 0


def bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``(dK, dV)`` in k's / v's dtype. Per split of the
    query range (:func:`split_ranges` in 64-row units; ``None``:
    :func:`pick_k3_splits` for the inputs' shape and dtype), fp32 partial
    ``dK = scale·Σ dSᵀQ`` and ``dV = Σ PᵀdO`` over the split's rows, summed
    in split order as the kernel's merge sums them."""
    if q.device.type == "cuda":
        bwd_dkv_reference.cuda_calls += 1
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = pick_k3_splits(b * h, sq, sk, q.dtype)
    lse4, delta4 = lse.reshape(b, h, sq, 1), delta.reshape(b, h, sq, 1)
    kf, vf = k.float(), v.float()
    dk = torch.zeros((b, sk, h, d), device=q.device)
    dv = torch.zeros((b, sk, h, d), device=q.device)
    for lo, hi in split_ranges(sq, splits, K3_TILE):
        if lo == hi:
            continue
        qs, gs = q[:, lo:hi].float(), do[:, lo:hi].float()
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, kf) * scale - lse4[:, :, lo:hi])
        dp = torch.einsum("bqhd,bkhd->bhqk", gs, vf)
        ds = p * (dp - delta4[:, :, lo:hi])
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qs) * scale
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, gs)
    return dk.to(k.dtype), dv.to(v.dtype)


bwd_dkv_reference.cuda_calls = 0


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale, splits: Optional[int] = None,
                                  dq_splits: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward (K2 then K3; ``dq_splits`` as
    :func:`bwd_dq_reference` takes its ``splits``, ``splits`` as
    :func:`bwd_dkv_reference` does): fp32 math with P recomputed from the
    forward's lse; gradients in the inputs' dtypes."""
    dq, delta = bwd_dq_reference(q, k, v, o, lse, do, scale, dq_splits)
    dk, dv = bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes BSHD [batch, seq, heads, head_dim] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"incompatible shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _check_kernel_inputs(*tensors: torch.Tensor, head_dims=KERNEL_HEAD_DIMS) -> None:
    """What every kernel needs of its BSHD tensors on the card."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not {t0.device}")
    b, _, h, d = t0.shape
    if d not in head_dims:
        raise ValueError(f"kernel head dim must be one of {head_dims}, got {d}")
    if t0.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {t0.dtype}")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError("kernel tensors must share one device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("kernel needs unit stride over the head dim")
    if b * h > 65535:
        raise ValueError(f"batch·heads = {b * h} exceeds the grid limit 65535")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` when its base and its batch/seq/head strides (of dims longer
    than 1) sit on 16 bytes, as TMA (K1, K4a) and 16-byte loads (K2, K3)
    need for bf16 rows; else one contiguous copy, which does."""
    b, s, h, _ = t.shape  # one read of the shape, the strides and the base: this runs on every call
    sb, ss, sh, _ = t.stride()
    item = t.element_size()
    ok = (t.data_ptr() % 16 == 0 and (b == 1 or sb > 0 and sb * item % 16 == 0)
          and (s == 1 or ss > 0 and ss * item % 16 == 0) and (h == 1 or sh > 0 and sh * item % 16 == 0))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(*tensors: torch.Tensor):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (or its plain version for CPU tensors), without autograd."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check_kernel_inputs(q, k, v)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel's TMA loads
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    lib = _library("fwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, _strides(q, k, v, out), float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional attention, BSHD. Returns ``(out [B,Sq,H,D], lse [B·H,Sq])``.

    CPU tensors go through :func:`flash_attention_reference`. CUDA tensors
    launch kernel K1 on the current stream; the head dim must be 64 or 128,
    the dtype float32 or bfloat16, and the head-dim stride 1. When autograd
    needs a graph (grad mode on and an input that requires grad) the call
    goes through :class:`FlashAttention`: ``out`` is differentiable, ``lse``
    is not."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, float(scale))
    return _fwd(q, k, v, scale)


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, o, lse, do, scale, *, splits: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dQ [B,Sq,H,D] in q's dtype, δ fp32 [B·H, Sq])``. bf16 runs the
    tensor-core kernel over ``splits`` ranges of the key axis (plus the sum
    of their partials when there are more than one); ``None`` lets
    :func:`pick_k2_splits` choose, a number forces it (tests). fp32 runs the
    SIMT kernel, which does not split (a forced count above 1 raises). CPU
    tensors go through :func:`bwd_dq_reference`."""
    if q.device.type == "cpu":
        return bwd_dq_reference(q, k, v, o, lse, do, scale, splits)
    _check_kernel_inputs(q, k, v, o, do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    splits = _check_splits(pick_k2_splits(b * h, sq, sk, q.dtype) if splits is None else splits)
    if q.dtype == torch.float32 and splits != 1:
        raise ValueError(f"the fp32 K2 kernel does not split the key range (splits={splits})")
    if q.dtype == torch.bfloat16:  # the tensor-core kernel's 16-byte loads
        q, k, v, o, do = _aligned(q), _aligned(k), _aligned(v), _aligned(o), _aligned(do)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    part_dq = None
    if splits > 1:
        part_dq = torch.empty((splits, b * h, sq, d), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    lib = _library("bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _ptr(part_dq), _DTYPE_CODES[q.dtype], b, h, sq, sk, d, splits,
            _strides(q, k, v, o, do, dq), float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: cudaError {err}")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, *, splits: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(dK, dV)`` in k's / v's dtype, from K2's δ. bf16 runs the
    tensor-core kernel over ``splits`` ranges of the query axis (plus the
    sum of their partials when there are more than one); ``None`` lets
    :func:`pick_k3_splits` choose, a number forces it (tests). fp32 runs the
    SIMT kernel, which does not split (a forced count above 1 raises). CPU
    tensors go through :func:`bwd_dkv_reference`."""
    if q.device.type == "cpu":
        return bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits)
    _check_kernel_inputs(q, k, v, do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    splits = _check_splits(pick_k3_splits(b * h, sq, sk, q.dtype) if splits is None else splits)
    if q.dtype == torch.float32 and splits != 1:
        raise ValueError(f"the fp32 K3 kernel does not split the query range (splits={splits})")
    if q.dtype == torch.bfloat16:  # the tensor-core kernel's cp.async loads
        q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    part_dk = part_dv = None
    if splits > 1:
        part_dk, part_dv = (torch.empty((splits, b * h, sk, d), dtype=torch.float32, device=q.device)
                            for _ in range(2))
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _library("bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(part_dk), _ptr(part_dv), _DTYPE_CODES[q.dtype], b, h, sq, sk, d,
            splits, _strides(q, k, v, do, dk, dv), float(scale), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: cudaError {err}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, scale) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_fwd`: K2 (dQ and δ), then K3
    (dK, dV) on the same stream. CPU tensors go through the plain versions."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward. ``apply(q, k, v, scale) → (out, lse)``;
    lse is returned for the caller and is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, d_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if d_out.stride(-1) != 1:  # the kernels read dO with unit head-dim stride
            d_out = d_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, d_out, ctx.scale)
        return dq, dk, dv, None
