"""Flow-matching Euler scheduler (SD3) — counterpart of
``sliders_conceptmod_tpu/diffusion/flow_match.py`` (diffusers
``FlowMatchEulerDiscreteScheduler``), stateless: the step index is an
argument.

Math (num_train_timesteps T = 1000):

* base sigmas σ_i = t_i / T over t ∈ linspace(T, 1, n), in float64;
* static shift (SD3, shift 3): σ' = s·σ / (1 + (s − 1)·σ); dynamic
  time-shift (Flux): σ' = e^μ / (e^μ + (1/σ − 1)), μ from
  :func:`calculate_shift`;
* timesteps σ'·T; the sigmas get a final 0; both cast to fp32 once, as the
  JAX schedule's ``jnp.asarray(..., float32)`` casts them;
* ``step``: x ← x + (σ_{i+1} − σ_i)·v in fp32, returned in the sample's
  dtype (the serving carry is bf16);
* ``add_noise``: x = (1 − σ)·x₀ + σ·ε in fp32, in the original's dtype.

The schedule's values are host fp32 numbers: the coefficient of a step is
the fp32 difference of two fp32 sigmas, as JAX computes it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def calculate_shift(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """μ for dynamic time-shifting (Flux) — linear in the sequence length."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


@dataclass(frozen=True)
class FlowSchedule:
    """The initial noise is N(0, 1) (diffusers' ``init_noise_sigma`` 1)."""

    num_inference_steps: int
    timesteps: torch.Tensor  # fp32 [n], descending (σ·1000), on the CPU
    sigmas: torch.Tensor  # fp32 [n + 1], last entry 0, on the CPU

    def dt(self, step_index: int) -> float:
        """σ_{i+1} − σ_i, subtracted in fp32."""
        s = self.sigmas.numpy()
        return float(s[step_index + 1] - s[step_index])


class FlowMatchScheduler:
    def __init__(self, num_train_timesteps: int = 1000, shift: float = 3.0, use_dynamic_shifting: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting

    def set_timesteps(self, num_inference_steps: int, mu: Optional[float] = None) -> FlowSchedule:
        n = num_inference_steps
        T = self.num_train_timesteps
        sigmas = np.linspace(T, 1, n, dtype=np.float64) / T
        if self.use_dynamic_shifting:
            if mu is None:
                raise ValueError("dynamic shifting requires mu (calculate_shift)")
            sigmas = math.exp(mu) / (math.exp(mu) + (1 / sigmas - 1))
        else:
            sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        timesteps = sigmas * T
        sigmas = np.concatenate([sigmas, [0.0]])
        return FlowSchedule(n, torch.from_numpy(timesteps.astype(np.float32)),
                            torch.from_numpy(sigmas.astype(np.float32)))

    @staticmethod
    def step(schedule: FlowSchedule, model_output: torch.Tensor, step_index: int, sample: torch.Tensor) -> torch.Tensor:
        """x ← x + (σ_next − σ)·v, in fp32, returned in the sample's dtype."""
        out = sample.float() + schedule.dt(step_index) * model_output.float()
        return out.to(sample.dtype)

    @staticmethod
    def add_noise(schedule: FlowSchedule, original: torch.Tensor, noise: torch.Tensor, step_index: int) -> torch.Tensor:
        """scale_noise: x = (1 − σ)·x₀ + σ·ε at the given schedule index."""
        sigma = schedule.sigmas.numpy()[step_index]
        keep = float(np.float32(1.0) - sigma)
        return (keep * original.float() + float(sigma) * noise.float()).to(original.dtype)
