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

from typing import Callable, Optional

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
