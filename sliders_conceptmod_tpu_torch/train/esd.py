"""The ESD slider training step — counterpart of
``sliders_conceptmod_tpu/train/esd.py`` for ``samples_per_step == 1``.

One iteration (reference ``conceptmod/textsliders/train_lora_xl.py:165-351``):

1. draw a prompt pair and ``timesteps_to ∈ [1, max_denoising_steps)``;
2. denoise from pure noise for ``timesteps_to`` steps with the slider ON,
   gradient-free (the warm-up);
3. teacher ε for rows [positive, neutral, negative] (plus the uncond row
   first when ``train.cfg ≠ 1``) with the slider OFF, in one UNet call;
4. student ε for the target prompt with the slider ON and gradients flowing;
5. loss = MSE(student, neutral + sign·g·(positive − negative)) in fp32, then
   the global gradient norm, the clip and AdamW.

The slider takes the JAX step's routes (``ESDConfig.student_overlay`` /
``overlay_warmup``, resolved by ``core/config.py::resolve_student_overlay``):

* the warm-up through the per-row LoRA overlay, or through the site weights
  merged once per step at multiplier 1 (``merge_fn``, detached; every
  warm-up call with them in place, ``adapters/lora.py::merged_weights``,
  and no hooks) —
  the merged warm-up rounds ΔW into bf16 weights, as the JAX default does;
* the student through the overlay (only the rank-r path is differentiated),
  or through weights merged inside autograd's region (the merged student:
  full dL/dW′ per site, back through the merge to the fp32 factors). DoRA
  always merges (``adapters/dora.py::merge_lora_params``).

The teacher is the bare base. On the card every UNet attention runs kernel
K1 (K4a at head dims 129…512), and the student's backward runs K2 and K3
(K4b and K4c) (``ops/flash_attention.py``, ``ops/flash_attention_kgrid.py``).

Randomness: the step takes the draws (:class:`Draws`) — as the parity tests
derive them from the JAX key — or makes them from :class:`TrainRNG`: the
pair and ``timesteps_to`` from a CPU generator (reading them never waits on
the card), the latents and the warm-up noise from a generator on the device.
The LoRA factors and the optimizer state are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite
from sliders_conceptmod_tpu_torch.core.prompts import action_sign
from sliders_conceptmod_tpu_torch.diffusion.sampling import (
    current_train_timestep,
    denoise_partial,
    get_initial_latents,
    predict_noise,
)
from sliders_conceptmod_tpu_torch.diffusion.schedulers import NoiseScheduler, Schedule
from sliders_conceptmod_tpu_torch.train.optim import AdamW, flat_params

# role order inside the stacked bank
ROLE_TARGET, ROLE_POSITIVE, ROLE_NEGATIVE, ROLE_UNCOND, ROLE_NEUTRAL = range(5)


@dataclass
class PromptBank:
    """All prompt-pair embeddings, stacked.

    text:     [P, 5, S, D]  (roles: target, positive, negative, uncond, neutral)
    pooled:   [P, 5, Dp] or None (XL only)
    guidance: per-pair guidance_scale g of the loss (host floats)
    sign:     per-pair −1 erase / +1 enhance (host floats)
    """

    text: torch.Tensor
    guidance: List[float]
    sign: List[float]
    pooled: Optional[torch.Tensor] = None


def build_prompt_bank(settings_list, encode_fn) -> PromptBank:
    """Encode each pair's 5 prompts (deduplicated by string) and stack.
    ``encode_fn(prompt) -> (text [S, D], pooled [Dp] | None)``.

    The bank is built outside inference mode (an encoder that returns
    inference tensors is cloned out of it): the student's cross-attention
    LoRA sites take the embeddings into autograd's graph."""
    cache: Dict[str, tuple] = {}

    def enc(p: str):
        if p not in cache:
            with torch.inference_mode(False):
                cache[p] = tuple(None if t is None else t.clone() for t in encode_fn(p))
        return cache[p]

    texts, pooleds, gs, signs = [], [], [], []
    for s in settings_list:
        roles = [s.target, s.positive, s.negative, s.unconditional, s.neutral]
        t_list, p_list = zip(*[enc(p) for p in roles])
        texts.append(torch.stack(t_list))
        if p_list[0] is not None:
            pooleds.append(torch.stack(p_list))
        gs.append(float(s.guidance_scale))
        signs.append(action_sign(s.action))
    return PromptBank(
        text=torch.stack(texts),
        pooled=torch.stack(pooleds) if pooleds else None,
        guidance=gs,
        sign=signs,
    )


@dataclass(frozen=True)
class ESDConfig:
    max_denoising_steps: int = 50
    train_cfg_scale: float = 1.0  # config.train.cfg — warm-up and branch guidance
    batch_size: int = 1
    height: int = 512
    width: int = 512
    num_train_timesteps: int = 1000
    # the JAX ESDConfig's route knobs: the student through the overlay, or
    # merged with autograd through the merge; overlay_warmup None follows
    # student_overlay. The trainer passes resolve_student_overlay's pair; the
    # defaults keep the overlay throughout.
    student_overlay: bool = True
    overlay_warmup: Optional[bool] = None


def merged_call(unet: torch.nn.Module, merged: Dict[str, torch.Tensor]) -> Callable[..., torch.Tensor]:
    """The UNet with ``merged`` in place of its site weights, for one call at
    a time (``adapters/lora.py::merged_weights``); run it inside
    ``overlay(None)``, which holds the model's lock and checks that no hook
    would add the slider again."""

    def call(sample, timestep, text, added_cond_kwargs=None):
        with lora_lib.merged_weights(unet, merged):
            return unet(sample, timestep, text, added_cond_kwargs=added_cond_kwargs)

    return call


@dataclass
class Draws:
    """One iteration's random draws."""

    pair: int
    timesteps_to: int
    latents0: torch.Tensor  # [B, 4, H/8, W/8] initial latents (noise · init_noise_sigma)
    warm_noise: torch.Tensor  # [timesteps_to, B, 4, H/8, W/8] per-step scheduler noise


class TrainRNG:
    """The trainer's generators: ``host`` (CPU) draws the pair and
    ``timesteps_to``; ``device`` draws the latents and the warm-up noise."""

    def __init__(self, seed: int, device):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)

    def get_state(self) -> dict:
        return {"host": self.host.get_state(), "device": self.device.get_state()}

    def set_state(self, state: dict) -> None:
        self.host.set_state(state["host"])
        self.device.set_state(state["device"])


def draw(rng: TrainRNG, n_pairs: int, schedule: Schedule, cfg: ESDConfig, device) -> Draws:
    pair = int(torch.randint(0, n_pairs, (), generator=rng.host))
    timesteps_to = int(torch.randint(1, cfg.max_denoising_steps, (), generator=rng.host))
    latents0 = get_initial_latents(schedule, cfg.batch_size, cfg.height, cfg.width, generator=rng.device,
                                   device=device)
    warm_noise = torch.randn((timesteps_to,) + tuple(latents0.shape), generator=rng.device, device=device)
    return Draws(pair, timesteps_to, latents0, warm_noise)


def raise_if_nonfinite(loss: torch.Tensor, grads: Sequence[torch.Tensor]) -> None:
    """``FloatingPointError`` unless the loss and every gradient are finite —
    ``tpu.debug_nans``, where the JAX trainers set ``jax_debug_nans`` and
    stop at the first NaN. One device-to-host read; a caller without the
    flag never calls it, so the default step adds no sync."""
    finite = torch.stack([torch.isfinite(loss).all()] + [torch.isfinite(g).all() for g in grads]).all()
    if not bool(finite):
        raise FloatingPointError("non-finite loss or gradient (tpu.debug_nans)")


def make_esd_train_step(
    unet: torch.nn.Module,
    sites: Sequence[LoRASite],
    lora_params: LoRAParams,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    optimizer: AdamW,
    cfg: ESDConfig,
    add_time_ids: Optional[torch.Tensor] = None,  # [1, 6] for XL
    merge_fn: Optional[Callable] = None,  # adapter merge (LoRA default; DoRA passes its own)
    debug_nans: bool = False,
) -> Callable[..., dict]:
    """Build ``step(opt_state, bank, rng=None, draws=None) -> {"loss",
    "grad_norm", "timesteps_to"}``: device scalars (the pre-clip global
    gradient norm) and the host int of the warm-up's length.

    ``lora_params`` (fp32 leaves that require grad) and ``opt_state`` are
    updated in place; the overlay binds the factors once. The JAX step's
    refusals hold: the overlay is LoRA's only, and an overlay warm-up needs
    the overlay student. ``debug_nans`` (``tpu.debug_nans``) checks the loss
    and the gradients before the update: :func:`raise_if_nonfinite`."""
    merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
    if cfg.student_overlay and merge is not lora_lib.merge_lora_params:
        raise ValueError("student_overlay supports the LoRA overlay only (DoRA merges)")
    if cfg.overlay_warmup and not cfg.student_overlay:
        raise ValueError("overlay_warmup=True requires student_overlay=True")
    overlay_warmup = cfg.overlay_warmup if cfg.overlay_warmup is not None else cfg.student_overlay
    is_xl = add_time_ids is not None
    b = cfg.batch_size
    use_cfg = float(cfg.train_cfg_scale) != 1.0
    overlay = LoRAOverlay(unet, sites, lora_params)
    params = flat_params(sites, lora_params)
    device = params[0].device
    one = torch.ones((1,), device=device)

    def tile(x):  # [S, D] -> [b, S, D]
        return x[None].expand((b,) + tuple(x.shape)).contiguous()

    def rows(text, pooled, role):
        """(text rows, XL kwargs) of one role — [uncond, role] under CFG."""
        roles = (ROLE_UNCOND, role) if use_cfg else (role,)
        t = torch.cat([tile(text[r]) for r in roles])
        kw = None
        if is_xl:
            kw = {"text_embeds": torch.cat([tile(pooled[r]) for r in roles]),
                  "time_ids": add_time_ids.expand(len(roles) * b, 6)}
        return t, kw

    def step(opt_state: dict, bank: PromptBank, rng: Optional[TrainRNG] = None,
             draws: Optional[Draws] = None) -> dict:
        if draws is None:
            draws = draw(rng, bank.text.shape[0], schedule, cfg, device)
        text = bank.text[draws.pair]
        pooled = bank.pooled[draws.pair] if bank.pooled is not None else None
        g_pair, sign = bank.guidance[draws.pair], bank.sign[draws.pair]
        target_rows, target_kw = rows(text, pooled, ROLE_TARGET)

        # (2) warm-up: slider ON, no gradients — the overlay, or one merge per step
        with torch.no_grad(), overlay(one if overlay_warmup else None):
            warm_unet = unet if overlay_warmup else merged_call(unet, merge(unet, sites, lora_params, 1.0))
            denoised = denoise_partial(
                warm_unet, scheduler, schedule, draws.latents0, target_rows,
                total_steps=draws.timesteps_to, guidance_scale=cfg.train_cfg_scale,
                added_cond_kwargs=target_kw, noise=draws.warm_noise,
            )
            del warm_unet  # the merged warm-up weights go before the student's are made
        current_t = current_train_timestep(draws.timesteps_to, cfg.max_denoising_steps, cfg.num_train_timesteps)

        # (3) teacher: slider OFF, one batched call
        roles = (ROLE_POSITIVE, ROLE_NEUTRAL, ROLE_NEGATIVE)
        if use_cfg:
            roles = (ROLE_UNCOND,) + roles
        n = len(roles)
        with torch.no_grad(), overlay(None):
            scaled = scheduler.scale_model_input_train_t(schedule, torch.cat([denoised] * n), current_t)
            kw = None
            if is_xl:
                kw = {"text_embeds": torch.cat([tile(pooled[r]) for r in roles]),
                      "time_ids": add_time_ids.expand(n * b, 6)}
            eps = unet(scaled, current_t, torch.cat([tile(text[r]) for r in roles]), added_cond_kwargs=kw)
            if use_cfg:
                e_u, e_pos, e_neu, e_neg = eps.chunk(4)
                gs = cfg.train_cfg_scale
                e_pos, e_neu, e_neg = (e_u + gs * (e - e_u) for e in (e_pos, e_neu, e_neg))
            else:
                e_pos, e_neu, e_neg = eps.chunk(3)
            # ESD target neutral ∓ g·(positive − negative), fp32 as the JAX step promotes it
            target = e_neu.float() + (sign * g_pair) * (e_pos - e_neg).float()

        # (4) student: slider ON, gradients through the factors (overlay) or through the merge
        with torch.enable_grad():
            with overlay(one if cfg.student_overlay else None):
                student_unet = (unet if cfg.student_overlay
                                else merged_call(unet, merge(unet, sites, lora_params, 1.0, grad=True)))
                student = predict_noise(
                    student_unet, scheduler, schedule, denoised, target_rows, train_t=current_t,
                    guidance_scale=cfg.train_cfg_scale, added_cond_kwargs=target_kw,
                )
            loss = torch.mean((student.float() - target) ** 2)
            grads = torch.autograd.grad(loss, params)
        if debug_nans:
            raise_if_nonfinite(loss, grads)

        # (5) clip + AdamW
        g_norm = optimizer.global_norm(grads)
        optimizer.step(params, grads, opt_state, g_norm=g_norm)
        return {"loss": loss.detach(), "grad_norm": g_norm, "timesteps_to": draws.timesteps_to}

    return step
