"""Initial latents, the CFG noise prediction, the partial denoise of the
training warm-up, SDXL micro-conditioning and CFG rescale — counterparts from
``sliders_conceptmod_tpu/diffusion/sampling.py``.

The JAX loop ``denoise_partial`` is a ``lax.fori_loop`` with a traced trip
count; here it is a Python loop over a host ``total_steps``. The stochastic
schedulers' per-step noise is injected (``noise[i]`` for step i, as the
parity tests derive it from the JAX key) or drawn from a
``torch.Generator``; the two packages draw different numbers from one seed.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.diffusion.schedulers import NoiseScheduler, Schedule

UNET_IN_CHANNELS = 4
VAE_SCALE_FACTOR = 8
UNET_ATTENTION_TIME_EMBED_DIM = 256
TEXT_ENCODER_2_PROJECTION_DIM = 1280
UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM = 2816


def get_initial_latents(
    schedule: Schedule,
    n_imgs: int,
    height: int,
    width: int,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """N(0,1) noise · init_noise_sigma, ``[n_imgs, 4, H/8, W/8]`` fp32:
    ``noise`` if given, else drawn from ``generator``."""
    shape = (n_imgs, UNET_IN_CHANNELS, height // VAE_SCALE_FACTOR, width // VAE_SCALE_FACTOR)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise {tuple(noise.shape)} != {shape}")
    return noise.float() * schedule.init_noise_sigma


# unet(sample, timestep, encoder_hidden_states, added_cond_kwargs=None)
UNetCall = Callable[..., torch.Tensor]


def predict_noise(
    unet: UNetCall,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    latents: torch.Tensor,  # [B, C, H, W]
    text_embeddings: torch.Tensor,  # [2B, S, D] uncond ++ cond, or [B] cond-only
    *,
    step_index: Optional[int] = None,  # schedule-index timestep (sampler loops)
    train_t=None,  # raw train timestep (teacher/student branches), a host int
    guidance_scale: float = 7.5,
    added_cond_kwargs: Optional[dict] = None,
) -> torch.Tensor:
    """One ε-prediction; exactly one of ``step_index`` / ``train_t``.

    When ``text_embeddings`` has the latents' batch the call is cond-only
    (guidance 1: u + 1·(c − u) ≡ c, half the UNet rows); otherwise the
    latents are doubled, the rows go through one UNet call and the CFG
    combine ``u + g·(c − u)`` is applied."""
    if (step_index is None) == (train_t is None):
        raise ValueError("predict_noise: pass exactly one of step_index / train_t")
    use_cfg = text_embeddings.shape[0] != latents.shape[0]
    model_in = torch.cat([latents] * 2, dim=0) if use_cfg else latents
    if step_index is not None:
        scaled = scheduler.scale_model_input(schedule, model_in, step_index)
        timestep = schedule.timesteps[step_index].item()
    else:
        if use_cfg and isinstance(train_t, torch.Tensor) and train_t.ndim >= 1:
            train_t = train_t.repeat(2)  # per-row timesteps double with the CFG rows
        scaled = scheduler.scale_model_input_train_t(schedule, model_in, train_t)
        timestep = train_t
    eps = unet(scaled, timestep, text_embeddings, added_cond_kwargs=added_cond_kwargs)
    if not use_cfg:
        return eps
    uncond, cond = eps.chunk(2, dim=0)
    return uncond + guidance_scale * (cond - uncond)


def denoise_partial(
    unet: UNetCall,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    latents: torch.Tensor,
    text_embeddings: torch.Tensor,
    *,
    total_steps: int,
    guidance_scale: float = 1.0,
    added_cond_kwargs: Optional[dict] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Denoise steps ``[0, total_steps)``. Stochastic schedulers take
    ``noise[i]`` at step i (``noise`` is ``[total_steps, *latents.shape]``),
    or draw from ``generator``."""
    state = scheduler.init_step_state(latents.shape, device=latents.device)
    for i in range(total_steps):
        eps = predict_noise(
            unet, scheduler, schedule, latents, text_embeddings,
            step_index=i, guidance_scale=guidance_scale, added_cond_kwargs=added_cond_kwargs,
        )
        latents, state = scheduler.step(
            schedule, eps, i, latents, state, noise=None if noise is None else noise[i], generator=generator
        )
    return latents


def denoise_partial_per_row(
    unet: UNetCall,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    latents: torch.Tensor,  # [S, C, H, W]: independent samples as rows
    text_embeddings: torch.Tensor,
    *,
    total_steps: Sequence[int],  # per-row trip counts
    guidance_scale: float = 1.0,
    added_cond_kwargs: Optional[dict] = None,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Like :func:`denoise_partial`, but row s denoises its own
    ``total_steps[s]`` steps inside one loop to ``max(total_steps)``: every
    step runs all rows in one call and a finished row keeps its latent (and
    its LMS history) — the fused-sample warm-up of ``samples_per_step``.
    ``noise`` is ``[max(total_steps), *latents.shape]``."""
    state = scheduler.init_step_state(latents.shape, device=latents.device)
    n = max(total_steps)
    active = torch.tensor([[i < t for t in total_steps] for i in range(n)], device=latents.device)
    row = (len(total_steps),) + (1,) * (latents.ndim - 1)
    for i in range(n):
        eps = predict_noise(
            unet, scheduler, schedule, latents, text_embeddings,
            step_index=i, guidance_scale=guidance_scale, added_cond_kwargs=added_cond_kwargs,
        )
        new_lat, new_state = scheduler.step(schedule, eps, i, latents, state, noise=noise[i])
        mask = active[i].reshape(row)
        latents = torch.where(mask, new_lat, latents)
        if new_state is not state:  # LMS: the derivative history, [order, S, ...]
            state = type(state)(torch.where(mask[None], new_state.derivatives, state.derivatives))
    return latents


def denoise_shared_snapshots(
    unet: UNetCall,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    latents: torch.Tensor,  # [1, C, H, W]: one shared chain
    text_embeddings: torch.Tensor,  # [1 or 2, S, D]
    *,
    total_steps: Sequence[int],  # per-row snapshot depths, each ≥ 1
    guidance_scale: float = 1.0,
    added_cond_kwargs: Optional[dict] = None,
    noise: torch.Tensor,
) -> torch.Tensor:
    """The shared-prefix warm-up (``tpu.share_warmup``): one batch-1 chain
    to ``max(total_steps)``; row s of the ``[len(total_steps), ...]`` result
    is the chain after ``total_steps[s]`` steps. The samples' warm-ups are
    snapshots of one trajectory (one initial latent, one noise draw per
    step), not independent chains — the JAX package's documented deviation.
    ``noise`` is ``[max(total_steps), 1, ...]``."""
    state = scheduler.init_step_state(latents.shape, device=latents.device)
    snaps: List[Optional[torch.Tensor]] = [None] * len(total_steps)
    for i in range(max(total_steps)):
        eps = predict_noise(
            unet, scheduler, schedule, latents, text_embeddings,
            step_index=i, guidance_scale=guidance_scale, added_cond_kwargs=added_cond_kwargs,
        )
        latents, state = scheduler.step(schedule, eps, i, latents, state, noise=noise[i])
        for s, t in enumerate(total_steps):
            if t == i + 1:
                snaps[s] = latents
    return torch.cat(snaps)


def current_train_timestep(timesteps_to: int, max_denoising_steps: int, num_train_timesteps: int = 1000) -> int:
    """The raw train timestep of the teacher/student branches: the reference
    re-sets the scheduler to 1000 steps (timesteps [999..0]) and indexes
    ``int(timesteps_to · 1000 / max_steps)``."""
    return num_train_timesteps - 1 - (timesteps_to * num_train_timesteps) // max_denoising_steps


def get_add_time_ids(
    height: int, width: int, dynamic_crops: bool = False, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """XL micro-conditioning ids [1, 6] (original size, crop top-left,
    target size); host-side numpy."""
    if dynamic_crops:
        rng = rng or np.random.default_rng()
        random_scale = rng.random() * 2 + 1
        original_size = (int(height * random_scale), int(width * random_scale))
        crops_coords_top_left = (
            int(rng.integers(0, max(1, original_size[0] - height))),
            int(rng.integers(0, max(1, original_size[1] - width))),
        )
    else:
        original_size = (height, width)
        crops_coords_top_left = (0, 0)
    add_time_ids = list(original_size + crops_coords_top_left + (height, width))
    passed = UNET_ATTENTION_TIME_EMBED_DIM * len(add_time_ids) + TEXT_ENCODER_2_PROJECTION_DIM
    if passed != UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM:
        raise ValueError(
            f"Model expects an added time embedding vector of length "
            f"{UNET_PROJECTION_CLASS_EMBEDDING_INPUT_DIM}, but a vector of {passed} was created."
        )
    return np.array([add_time_ids], dtype=np.float32)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float = 0.0):
    """CFG-rescale (arXiv 2305.08891 §3.4), inference path only."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def dynamic_resolution_buckets(bucket_resolution: int = 512, step: int = 64) -> List[Tuple[int, int]]:
    """The JAX package's fixed ≤4-shape quantisation of the reference's
    per-iteration resolution range [r/2, r) in 64px steps: the two scale
    extremes and both aspect orientations (deduplicated, in order)."""
    r = bucket_resolution
    lo = max(step, (r // 2 // step) * step)
    hi = max(lo, ((r - step) // step) * step)
    mid = max(lo, ((lo + hi) // 2 // step) * step)
    out: List[Tuple[int, int]] = []
    for b in [(lo, lo), (hi, mid), (mid, hi), (hi, hi)]:
        if b not in out:
            out.append(b)
    return out
