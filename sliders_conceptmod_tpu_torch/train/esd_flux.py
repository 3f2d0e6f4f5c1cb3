"""The Flux ESD slider step (few-step flow matching, packed latents) —
counterpart of ``sliders_conceptmod_tpu/train/esd_flux.py`` (reference
``train_lora_flux.py:86-447`` with ``predict_noise_flux``).

* ``timesteps_to`` is always 0: no warm-up; each branch predicts from pure
  packed noise at the schedule's first timestep (``t / 1000``);
* the teacher is one 3-row call [positive, neutral, negative] (no CFG, no
  uncond row), each row stepped from the same tokens at step index 0; the
  target ``neu + sign·g·(pos − neg)`` in fp32, without gradients;
* the student runs the target rows on the overlay (``(1,)`` multiplier) or
  on the merged weights (autograd through the merge), its blocks under
  ``torch.utils.checkpoint`` (``cfg.remat``) with the overlay or the merged
  weights re-entered for each recompute; the loss is the MSE of the
  student's stepped tokens against the target;
* ``samples_per_step`` S > 1: the mean of S independent samples (each its
  own pair and noise; JAX vmaps them), one after the other, each sample's
  gradient accumulated as it goes;
* the optimizer is the trainer's (``train/optim.py::MultiSteps`` over the
  reference's AdamW): a call is one micro-step, and the metrics are that
  micro-step's loss and the global norm of its gradients.

On the card every attention runs K1 and the student's backward K2/K3: per
micro-step (one sample) 57 × 3 K1 launches at schnell's depth — the
teacher, the student and its recompute — and 57 each of K2 and K3.

Randomness: the step takes the draws (a list of :class:`Draw`, as the parity
tests derive them from the JAX key) or makes them from ``esd.TrainRNG``: the
pair from its CPU generator, the noise from its device generator.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite
from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler, FlowSchedule
from sliders_conceptmod_tpu_torch.models.flux import pack_latents, prepare_latent_image_ids
from sliders_conceptmod_tpu_torch.train.esd import (
    ROLE_NEGATIVE,
    ROLE_NEUTRAL,
    ROLE_POSITIVE,
    ROLE_TARGET,
    PromptBank,
    TrainRNG,
    mesh_reduce,
    raise_if_nonfinite,
)
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train.optim import flat_params


@dataclass(frozen=True)
class FluxESDConfig:
    num_inference_steps: int = 8  # reference train_lora_flux.py:240
    batch_size: int = 1
    height: int = 512
    width: int = 512
    latent_channels: int = 16
    vae_scale: int = 8
    remat: bool = True  # the student's blocks under torch.utils.checkpoint
    samples_per_step: int = 1
    student_overlay: bool = False
    mesh: Optional[object] = None  # the samples shard over its data axis (parallel/mesh.py); None: one process


@dataclass
class Draw:
    """One sample's draws."""

    pair: int
    latents: torch.Tensor  # [B, C, H/vae_scale, W/vae_scale] fp32


def draw_step(rng: TrainRNG, n_pairs: int, cfg: FluxESDConfig, device) -> List[Draw]:
    """One micro-step's draws, one per sample."""
    shape = (cfg.batch_size, cfg.latent_channels, cfg.height // cfg.vae_scale, cfg.width // cfg.vae_scale)
    return [Draw(int(torch.randint(0, n_pairs, (), generator=rng.host)),
                 torch.randn(shape, generator=rng.device, device=device)) for _ in range(cfg.samples_per_step)]


class FluxESDStep:
    """``step(opt_state, bank, rng=None, draws=None) -> {"loss",
    "grad_norm"}`` (device scalars; the pre-clip global norm of this
    micro-step's gradients). The factors and the optimizer state are updated
    in place (the optimizer decides whether this call updates the factors)."""

    def __init__(self, transformer, sites: Sequence[LoRASite], lora_params: LoRAParams, schedule: FlowSchedule,
                 optimizer, cfg: FluxESDConfig, merge_fn: Optional[Callable] = None, debug_nans: bool = False):
        merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
        if cfg.student_overlay and merge is not lora_lib.merge_lora_params:
            raise ValueError("student_overlay supports the LoRA overlay only (DoRA merges)")
        self.model, self.sites, self.lora_params = transformer, sites, lora_params
        self.schedule, self.optimizer, self.cfg = schedule, optimizer, cfg
        self.merge, self.debug_nans = merge, debug_nans
        self.overlay = LoRAOverlay(transformer, sites, lora_params)
        self.params = flat_params(sites, lora_params)
        self.device = self.params[0].device
        self.one = torch.ones((1,), device=self.device)
        gh, gw = cfg.height // cfg.vae_scale // 2, cfg.width // cfg.vae_scale // 2
        self.img_ids = torch.from_numpy(prepare_latent_image_ids(gh, gw)).to(self.device)
        self.t0 = schedule.timesteps[0].to(self.device) / 1000.0

    def _rows(self, bank: PromptBank, pair: int, roles):
        b = self.cfg.batch_size
        text = torch.cat([bank.text[pair, r][None].expand((b,) + tuple(bank.text.shape[2:])) for r in roles])
        pooled = torch.cat([bank.pooled[pair, r][None].expand(b, -1) for r in roles])
        return text, pooled

    def predict_step(self, call: Callable, tokens: torch.Tensor, text, pooled) -> torch.Tensor:
        """One un-guided forward and the flow step from index 0
        (``predict_noise_flux``)."""
        txt_ids = torch.zeros((text.shape[1], 3), device=tokens.device)
        v = call(tokens, self.t0.expand(tokens.shape[0]), text, pooled, txt_ids, self.img_ids)
        return FlowMatchScheduler.step(self.schedule, v, 0, tokens)

    @contextmanager
    def _merged(self, merged):
        with self.overlay(None), lora_lib.merged_weights(self.model, merged):
            yield

    def sample_loss(self, bank: PromptBank, draw: Draw) -> torch.Tensor:
        cfg = self.cfg
        tokens = pack_latents(draw.latents)
        with torch.no_grad(), self.overlay(None):
            text, pooled = self._rows(bank, draw.pair, (ROLE_POSITIVE, ROLE_NEUTRAL, ROLE_NEGATIVE))
            pos, neu, neg = self.predict_step(self.model, torch.cat([tokens] * 3), text, pooled).chunk(3)
            scale = bank.sign[draw.pair] * bank.guidance[draw.pair]
            target = (neu + scale * (pos - neg)).float()
        if cfg.student_overlay:
            ctx = lambda: self.overlay(self.one)  # noqa: E731 — re-entered by each block's recompute
        else:
            merged = self.merge(self.model, self.sites, self.lora_params, 1.0, grad=True)
            ctx = lambda: self._merged(merged)  # noqa: E731

        def student(*args):
            return self.model(*args, remat_blocks=cfg.remat, remat_context=ctx if cfg.remat else None)

        text, pooled = self._rows(bank, draw.pair, (ROLE_TARGET,))
        with ctx():
            tgt = self.predict_step(student, tokens, text, pooled)
        return torch.mean((tgt.float() - target) ** 2)

    def draw(self, bank: PromptBank, rng: TrainRNG) -> List[Draw]:
        return draw_step(rng, bank.text.shape[0], self.cfg, self.device)

    def __call__(self, opt_state: dict, bank: PromptBank, rng: Optional[TrainRNG] = None,
                 draws: Optional[List[Draw]] = None) -> dict:
        if draws is None:
            draws = self.draw(bank, rng)
        if len(draws) != self.cfg.samples_per_step:
            raise ValueError(f"{len(draws)} draws for samples_per_step={self.cfg.samples_per_step}")
        n = len(draws)
        lo, hi = mesh_lib.data_share(n, self.cfg.mesh)  # this rank's samples (all of them off-mesh)
        loss, grads = None, None
        with torch.enable_grad():
            for d in draws[lo:hi]:
                l_j = self.sample_loss(bank, d)
                g = torch.autograd.grad(l_j / n, self.params)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                loss = l_j.detach() / n if loss is None else loss + l_j.detach() / n
        loss, grads = mesh_reduce(loss, grads, self.cfg.mesh, merged_student=not self.cfg.student_overlay)
        if self.debug_nans:
            raise_if_nonfinite(loss, grads)
        g_norm = self.optimizer.global_norm(grads)
        self.optimizer.step(self.params, grads, opt_state, g_norm=g_norm)
        return {"loss": loss, "grad_norm": g_norm}


def make_flux_esd_train_step(transformer, sites: Sequence[LoRASite], lora_params: LoRAParams,
                             schedule: FlowSchedule, optimizer, cfg: FluxESDConfig,
                             merge_fn: Optional[Callable] = None, debug_nans: bool = False) -> FluxESDStep:
    """Build the step (:class:`FluxESDStep`)."""
    return FluxESDStep(transformer, sites, lora_params, schedule, optimizer, cfg, merge_fn, debug_nans)
