"""Trainer-loop observability: the metrics jsonl and steps/s — counterpart
of ``sliders_conceptmod_tpu/train/loop_utils.py``.

Reading a loss as a Python float every step makes the host wait for the
card and empties the launch queue, so :class:`MetricsLogger` buffers the
device scalars and reads them in one batch every ``FLUSH_EVERY`` steps; it
reads every step only in ``verbose`` mode, where the user asked for per-step
prints. steps/s leaves out the first step (it carries the kernel build and
the lazy CUDA set-up): the clock starts when the first step has finished on
the device.
"""

from __future__ import annotations

import atexit
import json
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.diffusion.sampling import dynamic_resolution_buckets

FLUSH_EVERY = 64  # buffered steps per device-to-host read


def resolution_bucket_picker(dynamic: bool, resolution: int,
                             seed: int) -> Tuple[List[Tuple[int, int]], Optional[Callable[[int], int]]]:
    """``(buckets, pick)`` for dynamic-resolution training, as the JAX
    package has it: the buckets of ``dynamic_resolution_buckets`` and
    ``pick(i)``, the bucket of iteration i from
    ``np.random.default_rng((seed, i))`` (so the port's sequence is JAX's,
    and a resumed run replays it). ``dynamic=False``: the one square
    bucket and no picker."""
    if not dynamic:
        return [(resolution, resolution)], None
    buckets = dynamic_resolution_buckets(resolution)

    def pick(step_i: int) -> int:
        return int(np.random.default_rng((seed, step_i)).integers(len(buckets)))

    return buckets, pick


def steps_per_sec(n_steps: int, seconds: float) -> float:
    return n_steps / seconds if n_steps and seconds > 0 else float("nan")


def _sync(value) -> None:
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


class MetricsLogger:
    """Appends one JSON line per step to ``{name}_metrics.jsonl`` in
    ``save_path`` and a closing ``{"steps_per_sec": ...}`` line. Tensor
    metrics are buffered; host numbers are written as they are. ``write``
    False (a mesh rank other than 0) keeps the rows and writes and prints
    nothing."""

    def __init__(self, save_path, name: str, verbose: bool = False, write: bool = True):
        self.path = Path(save_path)
        self._f = None
        if write:
            self.path.mkdir(parents=True, exist_ok=True)
            # line-buffered, and flushed at exit: a crash mid-run keeps the rows
            self._f = open(self.path / f"{name}_metrics.jsonl", "a", buffering=1)
            atexit.register(self._flush_safe)
        self.verbose = verbose and write
        self._t_start: Optional[float] = None
        self._n = 0
        self._pending: List[Tuple[int, dict]] = []
        self._last_loss = None
        self.losses: List[float] = []
        self.rows: List[dict] = []

    def log(self, step: int, metrics: dict) -> None:
        if self._t_start is None:
            _sync(metrics["loss"])  # the first step has finished: start the clock
            self._t_start = time.time()
        else:
            self._n += 1
        self._last_loss = metrics["loss"]
        self._pending.append((step, metrics))
        if self.verbose or len(self._pending) >= FLUSH_EVERY:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        # one transfer for the whole buffer
        names = [[k for k, v in m.items() if isinstance(v, torch.Tensor)] for _, m in pending]
        values = torch.cat([torch.stack([m[k].float().reshape(()) for k in ks]) for (_, m), ks in zip(pending, names)])
        values = iter(values.cpu().tolist())
        for (step, m), ks in zip(pending, names):
            row = {"step": step}
            row.update({k: next(values) for k in ks})
            row.update({k: v for k, v in m.items() if k not in ks})
            self.losses.append(row["loss"])
            self.rows.append(row)
            if self._f is not None:
                self._f.write(json.dumps(row) + "\n")
            if self.verbose:
                print(f"step {step} loss*1k {row['loss'] * 1000:.4f}")

    def current_loss(self) -> Optional[float]:
        """The latest loss as a float: flushes the buffer (a device read)."""
        self.flush()
        return self.losses[-1] if self.losses else None

    def _flush_safe(self) -> None:
        if self._f is not None and not self._f.closed:
            self.flush()

    def close(self) -> float:
        """Flush, write steps/s (device-synchronised), close; returns steps/s."""
        atexit.unregister(self._flush_safe)
        _sync(self._last_loss)  # the last step has finished on the device
        sps = steps_per_sec(self._n, time.time() - self._t_start) if self._t_start else float("nan")
        self.flush()
        if self._f is not None:
            self._f.write(json.dumps({"steps_per_sec": sps}) + "\n")
            self._f.close()
        return sps
