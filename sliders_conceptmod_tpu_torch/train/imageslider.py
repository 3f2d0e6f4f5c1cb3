"""Image-pair ("visual") slider training — counterpart of
``sliders_conceptmod_tpu/train/imageslider.py`` (reference
``trainscripts/imagesliders``).

Per iteration (reference ``train_lora-scale.py:173-343``): draw a |scale|
pair u (its folders hold the −s and +s renders), an image index and
``timesteps_to ∈ [1, max_denoising_steps − 1)``; take both images' VAE
posterior samples from ONE normal draw, scale them, noise both with ONE noise
draw at ``schedule.timesteps[timesteps_to]``; then the student for rows
(high image, positive prompt) at slider +s and (low image, neutral prompt)
at −s, and loss = mean((ε_high − noise)²) + mean((ε_low − noise)²), its
gradient and the optimizer update.

Two student routes, as in JAX (``student_overlay``): one 2-row call through
the LoRA overlay with per-row multipliers [+s, −s] (the JAX CLI's default),
or the reference's two merged students — the site weights merged at +s and
at −s inside autograd's region, and one 1-row call through each
(``train/esd.py::merged_call``). Every image is VAE-encoded once
into an :class:`ImageBank` of posterior moments on the device; on the card the
encoder's mid-block attention runs kernel K4a, and the student's attentions
run K1 forward and K2/K3 backward.

Images: PNG or JPEG of any size, read as PIL's ``convert("RGB")`` reads them
(``io/image.py``; the GPU machine has no PIL), resized to the training
resolution as the JAX ``load_image_array`` resizes them — PIL's default
bicubic with antialiasing, mirrored bit for bit in numpy
(``io/resample.py``). The JAX bank prefers its native loader when
``libimload.so`` loads, which resizes bilinearly; the port follows the PIL
path, the reference's. WebP raises ``ValueError`` (ROADMAP.md queue 1,
item 14).

Randomness: the step takes its draws (:class:`Draws`) — as the parity tests
derive them from the JAX key — or makes them from ``esd.TrainRNG``: pair,
image and ``timesteps_to`` from the CPU generator, the posterior and noise
draws from the device generator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite
from sliders_conceptmod_tpu_torch.diffusion.sampling import current_train_timestep
from sliders_conceptmod_tpu_torch.diffusion.schedulers import NoiseScheduler, Schedule
from sliders_conceptmod_tpu_torch.io.image import load_rgb
from sliders_conceptmod_tpu_torch.io.resample import resize_like_pil
from sliders_conceptmod_tpu_torch.models.vae import sample_latents
from sliders_conceptmod_tpu_torch.train.esd import TrainRNG, merged_call, raise_if_nonfinite
from sliders_conceptmod_tpu_torch.train.optim import Optimizer, flat_params

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp")


@dataclass
class ImageBank:
    """VAE posterior moments of every (folder, image): ``[F, N, C, h, w]``,
    folders in the ``folders`` argument's order; ``pair_table[u]`` is the
    (low folder, high folder) of the u-th |scale| in ``pair_scales``."""

    mean: torch.Tensor
    logvar: torch.Tensor
    pair_table: List[Tuple[int, int]]
    pair_scales: List[float]


def list_paired_images(folder_main: str, folders: Sequence[str]) -> List[str]:
    """Image file names of the first folder, sorted; the other folders hold
    the same names (reference ``train_lora-scale.py:216-220``)."""
    first = os.path.join(folder_main, folders[0])
    ims = [f for f in sorted(os.listdir(first)) if f.lower().endswith(IMAGE_EXTENSIONS)]
    if not ims:
        raise FileNotFoundError(f"No images in {first}")
    return ims


def load_image_array(path: str, resolution: int) -> np.ndarray:
    """A PNG or JPEG → ``[1, 3, R, R]`` float32 in [-1, 1], as the JAX
    loader's ``Image.open(p).convert("RGB").resize((R, R))``: the file as
    ``io/image.py::load_rgb`` reads it, then PIL's default resize
    (``io/resample.py``; an image at ``R × R`` passes unchanged)."""
    img = resize_like_pil(load_rgb(path), (resolution, resolution))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = arr * 2.0 - 1.0
    return arr.transpose(2, 0, 1)[None]


@torch.no_grad()
def build_image_bank(
    folder_main: str,
    folders: Sequence[str],
    scales: Sequence[float],
    vae_encode: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    resolution: int,
    device=None,
) -> ImageBank:
    """Encode each folder's images in one call; build the |scale| → (−s, +s)
    folder table."""
    scales_arr = np.asarray(scales, dtype=np.float32)
    names = list_paired_images(folder_main, folders)
    means, logvars = [], []
    for folder in folders:
        batch = np.concatenate([load_image_array(os.path.join(folder_main, folder, n), resolution) for n in names])
        mean, logvar = vae_encode(torch.from_numpy(batch).to(device))
        means.append(mean)
        logvars.append(logvar)
    table, pair_scales = [], []
    for s in sorted({abs(float(s)) for s in scales_arr if s != 0}):
        table.append((int(np.nonzero(scales_arr == -s)[0][0]), int(np.nonzero(scales_arr == s)[0][0])))
        pair_scales.append(s)
    return ImageBank(mean=torch.stack(means), logvar=torch.stack(logvars), pair_table=table, pair_scales=pair_scales)


@dataclass(frozen=True)
class ImageSliderConfig:
    max_denoising_steps: int = 50
    scaling_factor: float = 0.18215
    num_train_timesteps: int = 1000


@dataclass
class Draws:
    """One iteration's random draws."""

    pair: int
    image: int
    timesteps_to: int
    posterior_noise: torch.Tensor  # [C, h, w], shared by the low and the high image
    noise: torch.Tensor  # [1, C, h, w], shared too


def draw(rng: TrainRNG, bank: ImageBank, cfg: ImageSliderConfig, device) -> Draws:
    pair = int(torch.randint(0, len(bank.pair_table), (), generator=rng.host))
    image = int(torch.randint(0, bank.mean.shape[1], (), generator=rng.host))
    timesteps_to = int(torch.randint(1, cfg.max_denoising_steps - 1, (), generator=rng.host))
    shape = tuple(bank.mean.shape[2:])
    posterior_noise = torch.randn(shape, generator=rng.device, device=device)
    noise = torch.randn((1,) + shape, generator=rng.device, device=device)
    return Draws(pair, image, timesteps_to, posterior_noise, noise)


def make_image_slider_step(
    unet: torch.nn.Module,
    sites: Sequence[LoRASite],
    lora_params: LoRAParams,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    optimizer: Optimizer,
    cfg: ImageSliderConfig,
    positive_emb: torch.Tensor,  # [S, D]
    neutral_emb: torch.Tensor,
    pooled: Optional[Dict[str, torch.Tensor]] = None,  # XL: {"positive", "neutral"} [Dp]
    add_time_ids: Optional[torch.Tensor] = None,  # XL: [1, 6]
    student_overlay: bool = True,
    debug_nans: bool = False,
) -> Callable[..., dict]:
    """Build ``step(opt_state, bank, rng=None, draws=None) -> {"loss",
    "loss_high", "loss_low", "grad_norm", "timesteps_to", "scale"}`` (device
    scalars, the pre-clip global gradient norm, then the draw's host int and
    the pair's |scale|). SD1 rows when
    ``pooled`` is None; the XL text_time conditioning otherwise.
    ``student_overlay`` picks the 2-row overlay student, else the two merged
    1-row students. The factors and ``opt_state`` are updated in place.
    ``debug_nans``: ``esd.raise_if_nonfinite`` before the update."""
    overlay = LoRAOverlay(unet, sites, lora_params)
    params = flat_params(sites, lora_params)
    device = params[0].device
    rows = torch.stack([positive_emb, neutral_emb])
    added = None
    if pooled is not None:
        added = {"text_embeds": torch.stack([pooled["positive"], pooled["neutral"]]),
                 "time_ids": add_time_ids.expand(2, add_time_ids.shape[-1])}

    def step(opt_state: dict, bank: ImageBank, rng: Optional[TrainRNG] = None,
             draws: Optional[Draws] = None) -> dict:
        if draws is None:
            draws = draw(rng, bank, cfg, device)
        scale = bank.pair_scales[draws.pair]
        low_f, high_f = bank.pair_table[draws.pair]

        def latents(folder):  # the posterior sample, scaled: [1, C, h, w]
            z = sample_latents(bank.mean[folder, draws.image], bank.logvar[folder, draws.image],
                               draws.posterior_noise)
            return (cfg.scaling_factor * z)[None]

        z_low, z_high = latents(low_f), latents(high_f)
        noise = draws.noise.to(z_low.dtype)
        t_noise = float(schedule.timesteps[draws.timesteps_to])
        noisy = torch.cat([scheduler.add_noise(schedule, z, noise, t_noise) for z in (z_high, z_low)])
        current_t = current_train_timestep(draws.timesteps_to, cfg.max_denoising_steps, cfg.num_train_timesteps)

        with torch.enable_grad():
            if student_overlay:
                with overlay(torch.tensor([scale, -scale], device=device)):
                    scaled = scheduler.scale_model_input_train_t(schedule, noisy, current_t)
                    eps = unet(scaled, current_t, rows, added_cond_kwargs=added)
            else:  # the merged ±s students, one row each
                eps = []
                with overlay(None):
                    for i, mult in enumerate((scale, -scale)):
                        student = merged_call(unet, lora_lib.merge_lora_params(unet, sites, lora_params, mult,
                                                                                grad=True))
                        scaled = scheduler.scale_model_input_train_t(schedule, noisy[i:i + 1], current_t)
                        row_added = None if added is None else {k: v[i:i + 1] for k, v in added.items()}
                        eps.append(student(scaled, current_t, rows[i:i + 1], added_cond_kwargs=row_added))
                eps = torch.cat(eps)
            eps_high, eps_low = eps.float().chunk(2)
            l_high = torch.mean((eps_high - noise.float()) ** 2)
            l_low = torch.mean((eps_low - noise.float()) ** 2)
            loss = l_high + l_low
            grads = torch.autograd.grad(loss, params)
        if debug_nans:
            raise_if_nonfinite(loss, grads)

        g_norm = optimizer.global_norm(grads)
        optimizer.step(params, grads, opt_state, g_norm=g_norm)
        return {"loss": loss.detach(), "loss_high": l_high.detach(), "loss_low": l_low.detach(), "grad_norm": g_norm,
                "timesteps_to": draws.timesteps_to, "scale": scale}

    return step
