"""The Stable Cascade ESD slider step (the Stage-C prior) — counterpart of
``sliders_conceptmod_tpu/train/esd_cascade.py`` (reference
``train_lora_cascade.py:163-305`` with ``predict_noise_cascade``), with the
JAX step's repairs (the sampled pair, not the one leaked from the caching
loop; both the beta schedulers and the ratio-space ``wuerstchen`` one).

The reference's quirks, kept:

* ``timesteps_to`` is fixed at T − 1 (``max_denoising_steps − 1``), so the
  warm-up always runs T − 1 prior calls;
* the prediction guidance is 4 (``predict_guidance``), whatever the pair's
  loss guidance;
* the CFG uncond row is the *empty* prompt, encoded once, not the pair's
  ``unconditional``;
* the loss compares raw guided predictions, never scheduler-stepped ones;
* the warm-up runs slider-ON and gradient-free on the pair's
  ``unconditional`` prompt;
* the ratio the teacher and student see re-indexes a 1000-step schedule:
  ``current_train_t = 999 − (t_to·1000 // T)`` through
  :func:`~sliders_conceptmod_tpu_torch.diffusion.wuerstchen.get_t_conditioning`
  (``wuerstchen``: the ratio ``1 − (t_to·1000 // T)/1000``);
* for euler_a the branch input is divided by √(σ² + 1) at that train
  timestep; lms raises.

Routes (``core/config.py::resolve_student_overlay(tpu, False, peft_type)``,
as the JAX trainer resolves them): the merged student by default (autograd
through the merge, ``adapters/lora.py`` / ``adapters/dora.py``) with the
merged warm-up; ``student_overlay`` the overlay student (LoRA only) with the
merged warm-up; ``warm_prior`` + ``overlay_warmup`` (``tpu.w8a8_warmup``)
the dual-tree W8A8 warm-up: the chain runs an int8 copy of the prior
(``adapters/quant.py::quantized_copy(prior, act_quant=True)``) with the
slider through the overlay on it (LoRA only). The student runs each
(ResBlock, TimestepBlock, AttnBlock) layer under ``torch.utils.checkpoint``
when ``cfg.remat`` is set, re-entering the overlay or the merged weights for
each recompute.

``samples_per_step`` S > 1: the mean of S independent samples (each its
own pair, initial latents and warm-up noise; JAX vmaps them), run one after
the other, each sample's gradient accumulated as it goes.
``share_warmup``: one batch-1 warm-up chain from sample 0's draws; each
sample's teacher and student keep its own pair (JAX's deviations).

On the card every attention is kernel K1 (heads of 64), the student's
backward K2/K3: per step and sample 64·(T − 1 + 3) K1 launches at the
prior's depth (the warm-up, the teacher, the student and its recompute) and
64 each of K2 and K3.

Randomness: the step takes the draws (a list of :class:`Draw`, as the
parity tests derive them from the JAX key) or makes them from
``esd.TrainRNG``: the pair from its CPU generator, the latents and the
warm-up noise from its device generator.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, ContextManager, List, Optional, Sequence

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite
from sliders_conceptmod_tpu_torch.diffusion.schedulers import NoiseScheduler
from sliders_conceptmod_tpu_torch.diffusion.wuerstchen import WuerstchenScheduler, get_t_conditioning
from sliders_conceptmod_tpu_torch.train.esd import (
    ROLE_NEGATIVE,
    ROLE_NEUTRAL,
    ROLE_POSITIVE,
    ROLE_TARGET,
    ROLE_UNCOND,
    PromptBank,
    TrainRNG,
    mesh_reduce,
    raise_if_nonfinite,
)
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train.optim import Optimizer, flat_params


@dataclass(frozen=True)
class CascadeESDConfig:
    max_denoising_steps: int = 20
    predict_guidance: float = 4.0  # the reference hard-codes 4
    batch_size: int = 1
    height: int = 1024
    width: int = 1024
    latent_channels: int = 16
    resolution_multiple: float = 42.67
    remat: bool = True  # the student's layers under torch.utils.checkpoint
    samples_per_step: int = 1
    share_warmup: bool = False
    student_overlay: bool = False
    overlay_warmup: bool = False
    mesh: Optional[object] = None  # the samples shard over its data axis (parallel/mesh.py); None: one process

    @property
    def latent_hw(self):
        return (math.ceil(self.height / self.resolution_multiple), math.ceil(self.width / self.resolution_multiple))


@dataclass
class Draw:
    """One sample's draws: the pair, the N(0, 1) initial latents (before
    ``init_noise_sigma``) and the T − 1 warm-up steps' noise."""

    pair: int
    latents0: torch.Tensor  # [B, C, h, w] fp32
    warm_noise: torch.Tensor  # [T − 1, B, C, h, w] fp32


def draw_step(rng: TrainRNG, n_pairs: int, cfg: CascadeESDConfig, device) -> List[Draw]:
    """One iteration's draws, one per sample."""
    shape = (cfg.batch_size, cfg.latent_channels) + cfg.latent_hw
    out = []
    for _ in range(cfg.samples_per_step):
        pair = int(torch.randint(0, n_pairs, (), generator=rng.host))
        lat0 = torch.randn(shape, generator=rng.device, device=device)
        noise = torch.randn((cfg.max_denoising_steps - 1,) + shape, generator=rng.device, device=device)
        out.append(Draw(pair, lat0, noise))
    return out


class CascadeESDStep:
    """``step(opt_state, bank, rng=None, draws=None) -> {"loss",
    "grad_norm"}`` (device scalars; no gradient is clipped). The factors and
    the optimizer state are updated in place."""

    def __init__(self, prior, sites: Sequence[LoRASite], lora_params: LoRAParams, scheduler, schedule,
                 optimizer: Optimizer, cfg: CascadeESDConfig, empty_text: torch.Tensor, empty_pooled: torch.Tensor,
                 clip_image_dim: int, merge_fn: Optional[Callable] = None, warm_prior=None, debug_nans: bool = False):
        # the JAX step's refusals, word for word
        if cfg.student_overlay and merge_fn is not None and merge_fn is not lora_lib.merge_lora_params:
            raise ValueError("student_overlay supports the LoRA overlay only (DoRA merges)")
        if warm_prior is not None and not cfg.overlay_warmup:
            raise ValueError(
                "warm_apply (the w8a8 dual-tree warm-up) requires overlay_warmup=True "
                "— an int8 warm-up copy cannot host a merged slider"
            )
        if cfg.overlay_warmup and merge_fn is not None and merge_fn is not lora_lib.merge_lora_params:
            raise ValueError("overlay_warmup supports the LoRA overlay only (DoRA merges)")
        if cfg.share_warmup and (cfg.samples_per_step == 1 or cfg.batch_size != 1):
            raise ValueError(
                "share_warmup needs the multi-sample path "
                "(samples_per_step > 1, batch_size == 1)"
            )
        self.is_wuerstchen = isinstance(scheduler, WuerstchenScheduler)
        if not self.is_wuerstchen and schedule.kind == "lms":
            raise NotImplementedError("cascade trainer: lms needs state threading; use euler_a/ddim/ddpm/wuerstchen")
        self.model, self.sites, self.lora_params = prior, sites, lora_params
        self.scheduler, self.schedule, self.optimizer, self.cfg = scheduler, schedule, optimizer, cfg
        self.merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
        self.debug_nans = debug_nans
        self.empty_text, self.empty_pooled, self.clip_image_dim = empty_text, empty_pooled, clip_image_dim
        self.overlay = LoRAOverlay(prior, sites, lora_params)
        self.warm_model = prior if warm_prior is None else warm_prior
        self.warm_overlay = self.overlay if warm_prior is None else LoRAOverlay(warm_prior, sites, lora_params)
        self.params = flat_params(sites, lora_params)
        self.device = self.params[0].device
        self.one = torch.ones((1,), device=self.device)

        T = cfg.max_denoising_steps
        self.t_to = T - 1  # fixed, reference train_lora_cascade.py:238
        self.branch_divisor = None  # euler_a / lms: √(σ² + 1) at the raw train timestep
        if self.is_wuerstchen:
            self.warm_ratios = np.asarray(schedule.timesteps[:T], np.float32)
            self.current_ratio = np.float32(1.0 - (self.t_to * 1000 // T) / 1000.0)
            self.init_sigma = 1.0
        else:
            acp = np.asarray(schedule.alphas_cumprod, np.float32)
            self.warm_ratios = get_t_conditioning(schedule.timesteps, acp)
            current_train_t = 999 - (self.t_to * 1000 // T)
            self.current_ratio = get_t_conditioning(current_train_t, acp)
            if schedule.kind in ("euler_a", "lms"):
                sigma = np.sqrt((np.float32(1.0) - acp[current_train_t]) / acp[current_train_t])
                self.branch_divisor = float(np.sqrt(sigma * sigma + np.float32(1.0)))
            self.init_sigma = float(schedule.init_noise_sigma)

    # --- rows ---------------------------------------------------------------

    def _tile(self, x):  # [S, D] -> [b, S, D]
        b = self.cfg.batch_size
        return x[None].expand((b,) + tuple(x.shape))

    def _ratio(self, value, rows: int) -> torch.Tensor:
        return torch.full((rows,), float(value), dtype=torch.float32, device=self.device)

    def predict_guided(self, call: Callable, x_in: torch.Tensor, ratio, text_c, pooled_c) -> torch.Tensor:
        """CFG rows [cond, uncond('')] → u + g·(c − u)."""
        b = x_in.shape[0]
        text = torch.cat([text_c, self._tile(self.empty_text)])
        pooled = torch.cat([pooled_c, self._tile(self.empty_pooled)])
        img = x_in.new_zeros((2 * b, 1, self.clip_image_dim))
        pred_c, pred_u = call(torch.cat([x_in, x_in]), self._ratio(ratio, 2 * b), text, pooled, img).chunk(2)
        return pred_u + self.cfg.predict_guidance * (pred_c - pred_u)

    def _sched_step(self, model_output, i: int, sample, noise):
        out = self.scheduler.step(self.schedule, model_output, i, sample, noise=noise)
        return out if self.is_wuerstchen else out[0]  # a beta scheduler also returns its (unused) state

    def _scale_in(self, sample, i: int):
        return sample if self.is_wuerstchen else NoiseScheduler.scale_model_input(self.schedule, sample, i)

    # --- warm-up ------------------------------------------------------------

    @contextmanager
    def _merged(self, merged) -> ContextManager:
        """The merged weights in place, under the model's lock."""
        with self.overlay(None), lora_lib.merged_weights(self.model, merged):
            yield

    @contextmanager
    def _warm(self):
        """Slider ON, no gradients: the overlay (on the warm-up's model), or
        the weights merged once at multiplier 1."""
        if self.cfg.overlay_warmup:
            with torch.no_grad(), self.warm_overlay(self.one):
                yield self.warm_model
            return
        with torch.no_grad():
            merged = self.merge(self.model, self.sites, self.lora_params, 1.0)
            with self._merged(merged):
                yield self.model

    def warm_up(self, bank: PromptBank, draw: Draw) -> torch.Tensor:
        """The (T − 1)-step warm-up from the draw's latents on its pair's
        unconditional prompt, scaled to the branch input."""
        text = self._tile(bank.text[draw.pair, ROLE_UNCOND])
        pooled = self._tile(bank.pooled[draw.pair, ROLE_UNCOND])
        lat = draw.latents0 * self.init_sigma
        with self._warm() as model:
            for i in range(self.t_to):
                guided = self.predict_guided(model, self._scale_in(lat, i), self.warm_ratios[i], text, pooled)
                lat = self._sched_step(guided, i, lat, draw.warm_noise[i])
        if self.branch_divisor is None:
            return lat
        return (lat / self.branch_divisor).to(lat.dtype)

    # --- teacher, student, loss --------------------------------------------

    def sample_loss(self, bank: PromptBank, pair: int, x_in: torch.Tensor) -> torch.Tensor:
        """Teacher target and the student's loss for ``pair`` from the
        gradient-free warm-up context ``x_in``."""
        cfg = self.cfg
        g = cfg.predict_guidance
        b = x_in.shape[0]
        with torch.no_grad(), self.overlay(None):
            roles = (ROLE_POSITIVE, ROLE_NEUTRAL, ROLE_NEGATIVE)
            text = torch.cat([self._tile(bank.text[pair, r]) for r in roles] + [self._tile(self.empty_text)])
            pooled = torch.cat([self._tile(bank.pooled[pair, r]) for r in roles] + [self._tile(self.empty_pooled)])
            preds = self.model(torch.cat([x_in] * 4), self._ratio(self.current_ratio, 4 * b), text, pooled,
                               x_in.new_zeros((4 * b, 1, self.clip_image_dim)))
            p_pos, p_neu, p_neg, p_unc = preds.chunk(4)
            guided = lambda p: p_unc + g * (p - p_unc)  # noqa: E731
            scale = bank.sign[pair] * bank.guidance[pair]
            target = (guided(p_neu) + scale * (guided(p_pos) - guided(p_neg))).float()

        if cfg.student_overlay:
            ctx = lambda: self.overlay(self.one)  # noqa: E731 — re-entered by each layer's recompute
        else:
            merged = self.merge(self.model, self.sites, self.lora_params, 1.0, grad=True)
            ctx = lambda: self._merged(merged)  # noqa: E731

        def student(*args):
            return self.model(*args, remat_blocks=cfg.remat, remat_context=ctx if cfg.remat else None)

        with ctx():
            tgt = self.predict_guided(student, x_in, self.current_ratio, self._tile(bank.text[pair, ROLE_TARGET]),
                                      self._tile(bank.pooled[pair, ROLE_TARGET]))
        return torch.mean((tgt.float() - target) ** 2)

    # --- the step -------------------------------------------------------------

    def draw(self, bank: PromptBank, rng: TrainRNG) -> List[Draw]:
        return draw_step(rng, bank.text.shape[0], self.cfg, self.device)

    def __call__(self, opt_state: dict, bank: PromptBank, rng: Optional[TrainRNG] = None,
                 draws: Optional[List[Draw]] = None) -> dict:
        cfg = self.cfg
        if draws is None:
            draws = self.draw(bank, rng)
        if len(draws) != cfg.samples_per_step:
            raise ValueError(f"{len(draws)} draws for samples_per_step={cfg.samples_per_step}")
        n = len(draws)
        lo, hi = mesh_lib.data_share(n, cfg.mesh)  # this rank's samples (all of them off-mesh)

        def tails():
            """(pair, warm-up context) of each of this rank's samples."""
            if cfg.share_warmup:  # one chain from sample 0's draws; the tails keep their pairs
                x_in = self.warm_up(bank, draws[0])
                for d in draws[lo:hi]:
                    yield d.pair, x_in
            else:
                for d in draws[lo:hi]:
                    yield d.pair, self.warm_up(bank, d)

        loss, grads = None, None
        with torch.enable_grad():
            for pair, x_in in tails():
                l_j = self.sample_loss(bank, pair, x_in)
                g = torch.autograd.grad(l_j / n, self.params)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                loss = l_j.detach() / n if loss is None else loss + l_j.detach() / n
        loss, grads = mesh_reduce(loss, grads, cfg.mesh, merged_student=not cfg.student_overlay)
        if self.debug_nans:
            raise_if_nonfinite(loss, grads)
        g_norm = self.optimizer.global_norm(grads)
        self.optimizer.step(self.params, grads, opt_state, g_norm=g_norm)
        return {"loss": loss, "grad_norm": g_norm}


def make_cascade_esd_train_step(prior, sites: Sequence[LoRASite], lora_params: LoRAParams, scheduler, schedule,
                                optimizer: Optimizer, cfg: CascadeESDConfig, empty_text: torch.Tensor,
                                empty_pooled: torch.Tensor, clip_image_dim: int, merge_fn: Optional[Callable] = None,
                                warm_prior=None, debug_nans: bool = False) -> CascadeESDStep:
    """Build the step (:class:`CascadeESDStep`); the JAX step's refusals of
    invalid combinations raise ``ValueError`` (lms ``NotImplementedError``)."""
    return CascadeESDStep(prior, sites, lora_params, scheduler, schedule, optimizer, cfg, empty_text, empty_pooled,
                          clip_image_dim, merge_fn, warm_prior, debug_nans)
