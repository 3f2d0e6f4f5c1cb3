"""Würstchen / Stable Cascade diffusion math — counterpart of
``sliders_conceptmod_tpu/diffusion/wuerstchen.py``.

* :class:`WuerstchenScheduler` — diffusers' ``DDPMWuerstchenScheduler``
  (scaler 1, s = 0.008): timesteps are ratios in [0, 1], linspace 1 → 0 over
  n + 1 points; ᾱ(t) = cos²((t+s)/(1+s)·π/2) / cos²(s/(1+s)·π/2), clipped
  to [1e-4, 0.9999]. ``step`` takes its ancestral noise as an argument (or
  draws it from a generator, as ``diffusion/schedulers.py`` does) and drops
  it on the last step, where the previous ratio is 0.
* :func:`get_t_conditioning` — a beta scheduler's integer timestep → the
  Stage-C cosine ratio (s = 0.003, not the scheduler's 0.008). The float
  timesteps of the σ-space kinds truncate to an int first.

The schedule's numbers are host fp32 values, computed as the JAX package
computes them on its CPU backend, so the ratios a trainer feeds the prior
are the JAX trainer's bits: the linspace as ``1 − i·fp32(1/n)`` and the
arccos as ``atan2(√((1−x)(1+x)), x)`` with the C library's ``atan2f``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.diffusion.schedulers import Generators, draw_step_noise

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.atan2f.restype = ctypes.c_float
_LIBM.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]


def _acos_f32(x: np.ndarray) -> np.ndarray:
    """fp32 arccos, the way XLA's CPU backend lowers it."""
    x = np.asarray(x, np.float32)
    one = np.float32(1.0)
    y = np.sqrt((one - x) * (one + x))
    out = [_LIBM.atan2f(float(a), float(b)) for a, b in zip(y.reshape(-1), x.reshape(-1))]
    return np.asarray(out, np.float32).reshape(x.shape)


def _alpha_cumprod(t, s: float = 0.008) -> np.ndarray:
    """ᾱ at ratio t ∈ [0, 1] (0 clean, 1 pure noise), fp32 on the host."""
    t = np.asarray(t, np.float32)
    init = np.float32(np.cos(s / (1 + s) * np.pi / 2) ** 2)
    a = np.cos((t + np.float32(s)) / np.float32(1 + s) * np.float32(np.pi / 2)) ** 2 / init
    return np.clip(a, np.float32(1e-4), np.float32(0.9999)).astype(np.float32)


@dataclass(frozen=True)
class WuerstchenSchedule:
    """``timesteps``: fp32 [n + 1] ratios, 1 → 0 (step i goes from ratio i to
    ratio i + 1)."""

    num_inference_steps: int
    timesteps: np.ndarray
    init_noise_sigma: float = 1.0


class WuerstchenScheduler:
    kind = "wuerstchen"
    prediction_type = "epsilon"

    def __init__(self, s: float = 0.008):
        self.s = s

    def set_timesteps(self, num_inference_steps: int) -> WuerstchenSchedule:
        n = num_inference_steps
        ratios = np.float32(1.0) - np.arange(n, dtype=np.float32) * np.float32(1.0 / n)
        return WuerstchenSchedule(n, np.concatenate([ratios, np.zeros(1, np.float32)]))

    @staticmethod
    def scale_model_input(schedule, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        return sample  # ratio-space DDPM: the identity

    def alpha_cumprod(self, t) -> np.ndarray:
        return _alpha_cumprod(t, self.s)

    def step(self, schedule: WuerstchenSchedule, model_output: torch.Tensor, step_index: int, sample: torch.Tensor,
             *, noise: Optional[torch.Tensor] = None, generator: Generators = None) -> torch.Tensor:
        """x_t → x_{t_prev} in fp32, returned in the sample's dtype; the
        ancestral noise (``noise``, else drawn from ``generator``) is dropped
        on the last step (diffusers' ``prev_t != 0`` mask)."""
        in_dtype = sample.dtype
        x, eps = sample.float(), model_output.float()
        t, t_prev = schedule.timesteps[step_index], schedule.timesteps[step_index + 1]
        a, a_prev = (float(v) for v in self.alpha_cumprod(np.array([t, t_prev])))
        alpha = a / a_prev
        mu = alpha**-0.5 * (x - ((1 - alpha) * (1 - a) ** -0.5) * eps)
        if t_prev != 0:
            if noise is None:
                noise = draw_step_noise(x.shape, generator, x.device)
            mu = mu + math.sqrt((1 - alpha) * (1 - a_prev) / (1 - a)) * noise.to(x.device, torch.float32)
        return mu.to(in_dtype)

    def add_noise(self, schedule, original: torch.Tensor, noise: torch.Tensor, ratio) -> torch.Tensor:
        """√ᾱ(r)·x₀ + √(1−ᾱ(r))·ε at a scalar ratio or one per row, in fp32,
        returned in the original's dtype."""
        a = torch.from_numpy(np.atleast_1d(self.alpha_cumprod(np.asarray(ratio, np.float32)))).to(original.device)
        a = a.reshape((-1,) + (1,) * (original.ndim - 1))
        return (torch.sqrt(a) * original.float() + torch.sqrt(1 - a) * noise.float()).to(original.dtype)


def get_t_conditioning(t, alphas_cumprod) -> np.ndarray:
    """Beta-scheduler timestep(s) → Stage-C ratio(s), fp32 on the host:
    acos(√(ᾱ[t]·min_var)) / (π/2) · (1+s) − s with s = 0.003, ᾱ clipped to
    [0, 1], a float timestep truncated to an int (the reference's
    ``t.long()``)."""
    s = 0.003
    min_var = np.float32(np.cos(s / (1 + s) * np.pi / 2) ** 2)
    t = np.asarray(t).astype(np.int32)
    var = np.clip(np.asarray(alphas_cumprod, np.float32)[t], np.float32(0.0), np.float32(1.0))
    ratio = _acos_f32(np.sqrt(var * min_var)) / np.float32(np.pi / 2) * np.float32(1 + s) - np.float32(s)
    return ratio.astype(np.float32)
