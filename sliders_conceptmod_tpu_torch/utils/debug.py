"""Debug utilities — counterpart of ``sliders_conceptmod_tpu/utils/debug.py``
(reference ``conceptmod/textsliders/debug_util.py:1-16`` and ``flush.py``).

* :func:`apply_tpu_runtime_flags` honours the YAML ``tpu:`` runtime knobs
  that must be set before the first kernel build; the entry points call it
  first (every trainer, and ``serve.py --compilation_cache_dir``).
* :func:`check_trainable` and :func:`check_dtypes` print what JAX's print
  for the same LoRA tree: the trainable leaves, and the dtypes and
  parameter counts.
* :func:`flush` frees the CUDA caching allocator's unused blocks.
"""

from __future__ import annotations

import gc
import os
from collections import Counter

import torch

from sliders_conceptmod_tpu_torch.ops import flash_attention as fa


def apply_tpu_runtime_flags(tpu) -> None:
    """The ``tpu:`` knobs that take effect before any kernel is built.

    - ``compilation_cache_dir``: the directory the CUDA kernels are built
      into and reused from (``ops/flash_attention.py::set_build_dir``;
      default ``build/kernels/`` beside the package). JAX keeps its XLA
      executables there; here a process that finds the kernels of its
      sources and flags there loads them instead of running ``nvcc``.
    - ``persistent_cache_min_compile_seconds``: accepted for the YAML's
      sake; it has no meaning for the ``nvcc`` builds, which are always
      kept.
    - ``debug_nans``: each trainer checks its own losses (a non-finite step
      raises; ``train/esd.py``), so nothing is set here.
    """
    if tpu is None:
        return
    cache_dir = getattr(tpu, "compilation_cache_dir", None)
    if cache_dir:
        fa.set_build_dir(os.path.expanduser(cache_dir))


def _leaves(tree, prefix: str = ""):
    """(path, tensor) of a nested dict of tensors, in JAX's flattening order
    (keys sorted), the path joined with ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def check_trainable(lora_params, max_entries: int = 5) -> None:
    """Print the first trainable leaves (name, shape, dtype), then the leaf
    and parameter counts — the functional analogue of the reference's
    check_requires_grad."""
    flat = list(_leaves(lora_params))
    for name, leaf in flat[:max_entries]:
        print(f"trainable: {name} {tuple(leaf.shape)} {_dtype_name(leaf)}")
    print(f"... {len(flat)} trainable leaves, {sum(l.numel() for _, l in flat):,} params")


def check_dtypes(params, max_entries: int = 5) -> None:
    """The parameters' dtypes and count — the analogue of the reference's
    check_training_mode. ``params`` is a nested dict of tensors or a module."""
    flat = list(params.named_parameters()) if isinstance(params, torch.nn.Module) else list(_leaves(params))
    counts = Counter(_dtype_name(l) for _, l in flat)
    total = sum(l.numel() for _, l in flat)
    print(f"param dtypes: {dict(counts)}; {total:,} params total")


def flush() -> None:
    """``gc.collect()`` and ``torch.cuda.empty_cache()`` (reference
    flush.py:1-5) where a CUDA device is in use; a no-op on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gc.collect()
        torch.cuda.empty_cache()
