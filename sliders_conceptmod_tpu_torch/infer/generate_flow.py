"""Slider inference for the flow-matching families (SD3, Flux) — counterpart
of ``sliders_conceptmod_tpu/infer/generate_flow.py``.

:func:`sample_flow_loop` is the two-phase flow-Euler sampler: the base
weights while ``t > start_noise`` (steps before ``flip_step``), then the
slider — merged weights swapped in for each call
(``adapters/lora.py::merged_weights``), or the per-row LoRA overlay (serving,
the int8 base, where nothing can be merged). The loop is eager Python over
host step indices; the schedule's coefficients are host floats.

:func:`sample_packed_flow` is Flux's (JAX's
``make_packed_overlay_sampler``, plain or ``indexed``): the same two phases
over packed tokens, one un-guided forward per step (no CFG rows; a dev model
takes ``guidance`` as its distilled-guidance input), the timestep in [0, 1]
(``t / 1000``); on the overlay every float scale rides one call, and an
``adapter_idx`` per row routes stacked factors.

:func:`sd3_latents_to_images` is the 16-channel VAEs' convention:
``z / scaling + shift`` before the decode, with the VAE's own factors —
SD3's 1.5305 and 0.0609, and Flux's from its ``vae/config.json``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, merged_weights, model_lock
from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler, FlowSchedule


def flip_step_for_start_noise(schedule: FlowSchedule, start_noise: float) -> int:
    """First step index whose (continuous) timestep is <= start_noise."""
    ts = schedule.timesteps.numpy()
    if ts[0] <= start_noise:
        return 0
    if not np.any(ts <= start_noise):
        return len(ts)
    return int(np.argmax(ts <= start_noise))


@torch.inference_mode()
def sample_flow_loop(
    transformer: nn.Module,
    flip_step: int,
    schedule: FlowSchedule,
    latents: torch.Tensor,  # [B, 16, h, w]
    text_embeddings: torch.Tensor,  # [2B] uncond ++ cond, or [B] cond-only
    pooled: torch.Tensor,
    *,
    guidance_scale: Union[float, torch.Tensor] = 7.0,
    merged: Optional[Dict[str, torch.Tensor]] = None,
    overlay: Optional[LoRAOverlay] = None,
    row_scale: Optional[torch.Tensor] = None,
    adapter_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-phase flow-Euler sampling with CFG (the uncond rows first); the
    cond rows only when the embeddings' batch is the latents'. A Python
    ``guidance_scale <= 1`` takes the cond rows only (diffusers' semantics);
    a tensor guidance always runs CFG, as a traced guidance does in JAX.

    After ``flip_step``: the ``overlay`` at ``row_scale`` (``[rows]`` of the
    model call, CFG-doubled by the caller; ``adapter_idx`` routes stacked
    factors), else ``merged`` in place of the site weights, else the base."""
    n = schedule.num_inference_steps
    b = latents.shape[0]
    use_cfg = text_embeddings.shape[0] != b
    if use_cfg and not isinstance(guidance_scale, torch.Tensor) and float(guidance_scale) <= 1.0:
        text_embeddings = text_embeddings[b:]
        if pooled is not None and pooled.shape[0] == 2 * b:
            pooled = pooled[b:]
        use_cfg = False
    rows = 2 * b if use_cfg else b
    timesteps = schedule.timesteps.to(latents.device)

    def forward(i, x, t):
        if i < flip_step:
            with (overlay(None) if overlay is not None else model_lock(transformer)):
                return transformer(x, t, text_embeddings, pooled)
        if overlay is not None:
            with overlay(row_scale, adapter_idx):
                return transformer(x, t, text_embeddings, pooled)
        with model_lock(transformer):
            if merged is None:
                return transformer(x, t, text_embeddings, pooled)
            with merged_weights(transformer, merged):
                return transformer(x, t, text_embeddings, pooled)

    lat = latents
    for i in range(n):
        t = timesteps[i].expand(rows)
        if use_cfg:
            v_u, v_c = forward(i, torch.cat([lat] * 2), t).chunk(2)
            if isinstance(guidance_scale, torch.Tensor):  # a traced fp32 guidance promotes, as in JAX
                v_u, v_c = v_u.float(), v_c.float()
            guided = v_u + guidance_scale * (v_c - v_u)
        else:
            guided = forward(i, lat, t)
        lat = FlowMatchScheduler.step(schedule, guided, i, lat)
    return lat


@torch.inference_mode()
def sample_packed_flow(
    transformer: nn.Module,
    flip_step: int,
    schedule: FlowSchedule,
    tokens: torch.Tensor,  # [B, S_img, 4C] packed latents
    text: torch.Tensor,  # [B, S_txt, joint_dim]
    pooled: torch.Tensor,  # [B, pooled_dim]
    img_ids,  # [S_img, 3]
    *,
    guidance=None,
    merged: Optional[Dict[str, torch.Tensor]] = None,
    overlay: Optional[LoRAOverlay] = None,
    row_scale: Optional[torch.Tensor] = None,
    adapter_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-phase flow-Euler over Flux's packed tokens: the base weights for
    steps below ``flip_step``, then the ``overlay`` at ``row_scale``
    (``[B]``; ``adapter_idx`` routes stacked factors), else ``merged`` in
    place of the site weights, else the base. ``guidance`` feeds a dev
    model's guidance embedding (schnell ignores it). Returns the final
    tokens in ``tokens``' dtype."""
    b = tokens.shape[0]
    txt_ids = torch.zeros((text.shape[1], 3), device=tokens.device)
    timesteps = schedule.timesteps.to(tokens.device)

    def forward(i, x):
        t = (timesteps[i] / 1000.0).expand(b)
        args = (x, t, text, pooled, txt_ids, img_ids, guidance)
        if i < flip_step:
            with (overlay(None) if overlay is not None else model_lock(transformer)):
                return transformer(*args)
        if overlay is not None:
            with overlay(row_scale, adapter_idx):
                return transformer(*args)
        with model_lock(transformer):
            if merged is None:
                return transformer(*args)
            with merged_weights(transformer, merged):
                return transformer(*args)

    tok = tokens
    for i in range(schedule.num_inference_steps):
        tok = FlowMatchScheduler.step(schedule, forward(i, tok), i, tok)
    return tok


@torch.inference_mode()
def sd3_latents_to_images(vae_decode, latents: torch.Tensor, scaling_factor: float = 1.5305,
                          shift_factor: float = 0.0609) -> np.ndarray:
    """latents → uint8 HWC images: ``x = z / scaling + shift`` in fp32 before
    the decode, [-1, 1] → [0, 255]. Raises on non-finite pixels."""
    z = latents.float() / scaling_factor + shift_factor
    imgs = vae_decode(z).float()
    if not bool(torch.isfinite(imgs).all()):
        raise FloatingPointError("VAE decode produced non-finite pixels")
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
    return torch.round(imgs * 255).to(torch.uint8).cpu().numpy()
