"""Slider inference — counterpart of ``sliders_conceptmod_tpu/infer/generate.py``.

Two samplers over one denoising loop, each with the slider gated off while
``t > start_noise`` (steps before ``flip_step``):

* ``sample_loop`` — the two-phase trajectory of the sweep CLIs: the base
  weights before the flip, the merged slider weights
  (``adapters/lora.py::merge_lora_params``) after it, swapped in for each
  call (``merged_weights``); one scheduler state carries across the
  flip (the LMS derivative history spans it);
* ``sample_loop_scales`` — every row of a batch in ONE trajectory, each row
  under its own slider scale via the per-row LoRA overlay (serving and
  ``--batch_scales``).

The loop is eager Python over host step indices: weights stay resident,
scheduler coefficients are host floats, and nothing in the loop reads a value
back from the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite, merged_weights, model_lock
from sliders_conceptmod_tpu_torch.diffusion.sampling import rescale_noise_cfg
from sliders_conceptmod_tpu_torch.diffusion.schedulers import Generators, NoiseScheduler, Schedule


def flip_step_for_start_noise(schedule: Schedule, start_noise: float) -> int:
    """First step index whose train timestep is <= start_noise (timesteps
    descend)."""
    ts = np.asarray(schedule.timesteps)
    if ts[0] <= start_noise:  # slider active from the very start
        return 0
    if not np.any(ts <= start_noise):
        return len(ts)
    return int(np.argmax(ts <= start_noise))


@torch.inference_mode()
def sample_loop_scales(
    unet: nn.Module,
    sites: Sequence[LoRASite],
    lora_params: LoRAParams,
    scales: Union[Sequence[float], torch.Tensor],  # [S] slider scales, one row-group each
    flip_step: int,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    latents: torch.Tensor,  # [S*N, C, H, W] scale-major
    text_embeddings: torch.Tensor,  # [2*S*N, S_txt, D] uncond ++ cond
    *,
    guidance_scale: Union[float, torch.Tensor] = 7.5,
    guidance_rescale: float = 0.0,
    added_cond_kwargs: Optional[dict] = None,
    generators: Generators = None,
    step_noise: Optional[torch.Tensor] = None,
    overlay: Optional[LoRAOverlay] = None,
    adapter_idx: Optional[Union[Sequence[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """Every slider scale of a batch in one trajectory.

    CFG: a Python ``guidance_scale <= 1`` runs the conditional rows only (the
    cond-only fast path); a tensor guidance always runs CFG — the JAX
    sampler's semantics for a traced guidance, which is what serving passes.

    Stochastic schedulers take their noise from ``step_noise`` ([n_steps,
    *latents.shape], injected — the parity tests) or else from
    ``generators`` (one per row: a row's noise then depends only on its own
    generator, whatever rows share the batch). ``overlay`` reuses a bound
    :class:`LoRAOverlay` (serving binds one per slider).

    ``adapter_idx`` (``[B]`` ints) routes each row through its own adapter of
    stacked factors (``adapters/lora.py::stack_adapters``): rows of different
    sliders share the trajectory (serving's cross-slider batches).
    """
    B = latents.shape[0]
    device = latents.device
    scales = torch.as_tensor(scales, dtype=torch.float32).to(device)
    row_scales = scales.repeat_interleave(B // scales.shape[0])
    use_cfg = _use_cfg(guidance_scale)
    if overlay is None:
        overlay = LoRAOverlay(unet, sites, lora_params)
    row_idx = None if adapter_idx is None else torch.as_tensor(adapter_idx, dtype=torch.long).to(device)
    if use_cfg:
        row_scales = torch.cat([row_scales] * 2)
        row_idx = None if row_idx is None else torch.cat([row_idx] * 2)

    def call(i, scaled, t, emb, added):
        # slider off while t > start_noise: every row scale is 0, which is
        # exactly the base model — no hooks to run, but the model's lock is
        # still held so no other thread's hooks reach these rows
        with overlay(row_scales if i >= flip_step else None, row_idx):
            return unet(scaled, t, emb, added_cond_kwargs=added)

    return _denoise(call, use_cfg, scheduler, schedule, latents, text_embeddings, guidance_scale,
                    guidance_rescale, added_cond_kwargs, generators, step_noise)


@torch.inference_mode()
def sample_loop(
    unet: nn.Module,
    merged: Optional[Dict[str, torch.Tensor]],  # merge_lora_params(unet, ...) at the scale, or None
    flip_step: int,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    latents: torch.Tensor,  # [B, C, H, W]
    text_embeddings: torch.Tensor,  # [2B, S_txt, D] uncond ++ cond
    *,
    guidance_scale: Union[float, torch.Tensor] = 7.5,
    guidance_rescale: float = 0.0,
    added_cond_kwargs: Optional[dict] = None,
    generators: Generators = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full denoise with the one-time slider flip at ``flip_step``: steps
    before it run the model's own weights, the rest run ``merged`` in place
    of the site weights (``None``: the base weights throughout).

    ``merged_weights`` swaps the merged tensors into the module for the
    length of one call, so each call holds the model's lock (as an overlay
    does): another thread's calls on the same model wait and never see the
    merged weights. CFG and randomness as :func:`sample_loop_scales`."""

    def call(i, scaled, t, emb, added):
        with model_lock(unet):
            if i < flip_step or merged is None:
                return unet(scaled, t, emb, added_cond_kwargs=added)
            with merged_weights(unet, merged):
                return unet(scaled, t, emb, added_cond_kwargs=added)

    return _denoise(call, _use_cfg(guidance_scale), scheduler, schedule, latents, text_embeddings,
                    guidance_scale, guidance_rescale, added_cond_kwargs, generators, step_noise)


def _use_cfg(guidance_scale) -> bool:
    """A Python guidance <= 1 takes the cond-only path; a tensor guidance
    always runs CFG (the JAX samplers' rule for a traced guidance)."""
    return True if isinstance(guidance_scale, torch.Tensor) else float(guidance_scale) > 1.0


def _denoise(call: Callable, use_cfg: bool, scheduler: NoiseScheduler, schedule: Schedule, latents: torch.Tensor,
             text_embeddings: torch.Tensor, guidance_scale, guidance_rescale: float,
             added_cond_kwargs: Optional[dict], generators: Generators,
             step_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The loop both samplers share: ``call(i, scaled, t, emb, added)`` is
    the UNet at step ``i``; one scheduler state for the whole trajectory."""
    B = latents.shape[0]
    if use_cfg:
        emb, added = text_embeddings, added_cond_kwargs
    else:
        emb = text_embeddings[B:]
        added = {k: v[v.shape[0] // 2:] for k, v in added_cond_kwargs.items()} if added_cond_kwargs else None
    lat = latents
    state = scheduler.init_step_state(latents.shape, device=latents.device)
    for i in range(schedule.num_inference_steps):
        t = schedule.timesteps[i].item()
        model_in = torch.cat([lat] * 2) if use_cfg else lat
        eps = call(i, scheduler.scale_model_input(schedule, model_in, i), t, emb, added)
        if use_cfg:
            uncond, cond = eps.chunk(2)
            guided = uncond.float() + guidance_scale * (cond - uncond).float()
            if guidance_rescale > 0:
                guided = rescale_noise_cfg(guided, cond, guidance_rescale)
        else:
            guided = eps
        noise = None if step_noise is None else step_noise[i]
        lat, state = scheduler.step(schedule, guided, i, lat, state, noise=noise, generator=generators)
    return lat


@torch.inference_mode()
def latents_to_images(vae_decode, latents: torch.Tensor, scaling_factor: float) -> np.ndarray:
    """latents → uint8 HWC images (VAE decode fed fp32, [-1,1] → [0,255]).
    Raises on non-finite pixels rather than casting NaNs into an image."""
    imgs = vae_decode((latents / scaling_factor).float()).float()
    if not bool(torch.isfinite(imgs).all()):
        raise FloatingPointError("VAE decode produced non-finite pixels")
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
    return torch.round(imgs * 255).to(torch.uint8).cpu().numpy()
