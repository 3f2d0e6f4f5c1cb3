"""Null-text inversion — real-image slider editing; counterpart of
``sliders_conceptmod_tpu/infer/null_inversion.py`` (the reference's
``NullInversion`` class and edit loop, ``demo_image_editing.ipynb`` cells 6
and 13):

1. :func:`ddim_invert`: from the VAE posterior *mean* · scaling factor, the
   DDIM loop run *backwards* (``next_step``) over every schedule step at CFG
   1 (the conditional prediction only), the trajectory kept;
2. :func:`null_optimization`: walking forward from x_T, the *unconditional
   embedding* is optimised at each timestep (Adam, lr 1e-2 decaying by step,
   at most ``num_inner_steps`` iterations, an early stop under
   ``epsilon + i·2e-5``) so that the CFG-7.5 ``prev_step`` reconstruction
   matches the recorded trajectory. The embedding is an fp32 leaf and the
   only tensor with a gradient: the backward runs through the whole UNet to
   it, so on the card every attention's backward kernel (K2/K3, K4b/K4c)
   runs wherever a path from the embedding reaches it;
3. :func:`edit_with_slider`: from the inverted x_T with the per-step
   embeddings, the base weights until ``flip_step`` (``t > start_noise``),
   then the merged slider weights.

``unet`` is any callable ``unet(sample, t, emb) → ε`` (the UNet module);
``t`` is a host integer. Latents stay fp32 whatever the model's dtype.
Inversion and the edit run under ``torch.no_grad()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.lora import merged_weights, model_lock
from sliders_conceptmod_tpu_torch.diffusion.schedulers import Schedule
from sliders_conceptmod_tpu_torch.train.optim import AdamW

NUM_DDIM_STEPS = 50
GUIDANCE_SCALE = 7.5

UNetFn = Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor]


def _alpha(schedule: Schedule, t: int) -> np.float32:
    """ᾱ_t from the fp32 table; a negative t is the clean image, ᾱ = 1
    (``set_alpha_to_one``)."""
    return np.float32(schedule.alphas_cumprod[t]) if t >= 0 else np.float32(1.0)


def _ddim_move(eps: torch.Tensor, sample: torch.Tensor, a_from: np.float32, a_to: np.float32) -> torch.Tensor:
    """x0 = (x − √(1−ᾱ_from)·ε)/√ᾱ_from, then √ᾱ_to·x0 + √(1−ᾱ_to)·ε, with
    the square roots taken in fp32 as JAX takes them."""
    one = np.float32(1.0)
    x0 = (sample - float(np.sqrt(one - a_from)) * eps) / float(np.sqrt(a_from))
    return float(np.sqrt(a_to)) * x0 + float(np.sqrt(one - a_to)) * eps


def ddim_next_step(schedule: Schedule, eps: torch.Tensor, t: int, t_next: int, sample: torch.Tensor) -> torch.Tensor:
    """Inversion step x_t → x_{t+1} (the notebook's ``next_step``)."""
    return _ddim_move(eps, sample, _alpha(schedule, t), _alpha(schedule, t_next))


def ddim_prev_step(schedule: Schedule, eps: torch.Tensor, t: int, t_prev: int, sample: torch.Tensor) -> torch.Tensor:
    """Denoising step x_t → x_{t−1} (the notebook's ``prev_step``)."""
    return _ddim_move(eps, sample, _alpha(schedule, t), _alpha(schedule, t_prev))


def _step_ratio(schedule: Schedule) -> int:
    return 1000 // schedule.num_inference_steps


@torch.no_grad()
def ddim_invert(unet: UNetFn, schedule: Schedule, latent0: torch.Tensor, cond_emb: torch.Tensor) -> torch.Tensor:
    """The inversion trajectory ``[T+1, 1, 4, h, w]`` (x_0 … x_T) at CFG 1.
    ``latent0`` is the VAE posterior mean · scaling factor."""
    step_ratio = _step_ratio(schedule)
    lat = latent0.float()
    traj = [lat]
    for t in schedule.timesteps[::-1].tolist():  # ascending
        eps = unet(lat, t, cond_emb).float()
        lat = ddim_next_step(schedule, eps, t - step_ratio, t, lat)
        traj.append(lat)
    return torch.stack(traj)


@dataclass(frozen=True)
class NullOptConfig:
    num_inner_steps: int = 10
    epsilon: float = 1e-5
    lr: float = 1e-2


def _guided(unet: UNetFn, lat, t: int, uncond, eps_cond):
    eps_u = unet(lat, t, uncond).float()
    return eps_u + GUIDANCE_SCALE * (eps_cond - eps_u)


def null_optimization(
    unet: UNetFn,
    schedule: Schedule,
    trajectory: torch.Tensor,  # [T+1, 1, 4, h, w] from ddim_invert
    cond_emb: torch.Tensor,
    uncond_emb0: torch.Tensor,  # [1, S, D] embedding of ""
    cfg: NullOptConfig = NullOptConfig(),
    inner_steps: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep optimised uncond embeddings ``[T, 1, S, D]`` (fp32) and
    the final latents.

    At step i (descending t) ‖prev_step(CFG_7.5(ε)) − x_{T−1−i}‖² is
    minimised over the uncond embedding with a fresh Adam (the port's
    :class:`AdamW` at weight decay 0, optax ``adam``'s update) at lr
    ``1e-2·(1 − i/100)``. JAX's order is kept: the iteration whose loss
    falls under ``epsilon + i·2e-5`` still applies its update, and only then
    does the loop stop (an eager ``break`` in place of JAX's masked
    ``fori_loop``). ``inner_steps``, when given, receives the number of
    updates each step applied."""
    T = schedule.num_inference_steps
    step_ratio = _step_ratio(schedule)
    cond = cond_emb.detach().clone()
    uncond = uncond_emb0.detach().float().clone()  # Adam on a bf16 leaf rounds the late, small updates away
    traj = trajectory.detach().float().clone()
    lat = traj[-1]
    per_step = []
    for i, t in enumerate(schedule.timesteps.tolist()):
        target = traj[T - 1 - i]
        with torch.no_grad():
            eps_cond = unet(lat, t, cond).float()
        lr = float(np.float32(cfg.lr) * (np.float32(1.0) - np.float32(i) / np.float32(100.0)))
        opt = AdamW(lambda count, lr=lr: lr, weight_decay=0.0)
        state = opt.init([uncond])
        threshold = float(np.float32(cfg.epsilon) + np.float32(i) * np.float32(2e-5))
        applied = 0
        for _ in range(cfg.num_inner_steps):
            leaf = uncond.detach().requires_grad_(True)
            prev = ddim_prev_step(schedule, _guided(unet, lat, t, leaf, eps_cond), t, t - step_ratio, lat)
            loss = torch.mean((prev - target) ** 2)
            (grad,) = torch.autograd.grad(loss, [leaf])
            opt.step([uncond], [grad], state)  # in place, outside autograd
            applied += 1
            if loss.item() < threshold:  # after the update, as the reference breaks after optimizer.step()
                break
        if inner_steps is not None:
            inner_steps.append(applied)
        with torch.no_grad():
            lat = ddim_prev_step(schedule, _guided(unet, lat, t, uncond, eps_cond), t, t - step_ratio, lat)
        per_step.append(uncond.clone())
    return torch.stack(per_step), lat


@torch.no_grad()
def edit_with_slider(
    unet: nn.Module,
    merged: Optional[Dict[str, torch.Tensor]],
    flip_step: int,
    schedule: Schedule,
    x_t: torch.Tensor,
    cond_emb: torch.Tensor,
    uncond_per_step: torch.Tensor,  # [T, 1, S, D]
) -> torch.Tensor:
    """The notebook's cell 13: denoise from the inverted x_T with the
    per-step uncond embeddings, the base weights for steps before
    ``flip_step`` and the merged slider weights (``merge_lora_params``;
    None: the base) from it on."""
    step_ratio = _step_ratio(schedule)
    lat = x_t.float()
    with model_lock(unet):
        for i, t in enumerate(schedule.timesteps.tolist()):
            slider = merged if (merged is not None and i >= flip_step) else {}
            with merged_weights(unet, slider):
                eps_u = unet(lat, t, uncond_per_step[i]).float()
                eps_c = unet(lat, t, cond_emb).float()
            eps = eps_u + GUIDANCE_SCALE * (eps_c - eps_u)
            lat = ddim_prev_step(schedule, eps, t, t - step_ratio, lat)
    return lat
