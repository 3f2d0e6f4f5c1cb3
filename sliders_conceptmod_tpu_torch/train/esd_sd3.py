"""The SD3 ESD slider step (MMDiT + flow matching) — counterpart of
``sliders_conceptmod_tpu/train/esd_sd3.py`` (reference
``train_lora_sd3.py:170-340`` with ``predict_noise_sd3``).

Where it differs from ``train/esd.py``:

* the ESD target is in **scheduler-stepped latents**, not velocity: each
  branch CFG-combines the velocity and takes the flow step from the same
  latents (``cfg_step``), and the loss compares the stepped latents;
* ``current_timestep`` is ``timesteps[timesteps_to]`` of the flow schedule
  itself, and the warm-up is deterministic (no scheduler noise);
* with CFG (``train.cfg`` ≠ 1) the teacher is one 4-row call [uncond,
  positive, neutral, negative], each row stepped from the same latents; the
  student runs the [uncond, target] rows with the ``(1,)`` overlay
  multiplier broadcast over both, so the slider is on in the uncond row too.

Routes (``core/config.py::resolve_student_overlay`` with
``default_overlay=(peft_type == "lora")``): the overlay student with the
merged warm-up for a bf16 LoRA, the merged student (autograd through the
merge) for DoRA, the overlay throughout over an int8 base, and
``warm_transformer`` (``tpu.w8a8_warmup``: the int8 base with W8A8 on, or
the dual tree's int8 copy) for the warm-up alone. The student runs each
block under ``torch.utils.checkpoint`` (``cfg.remat``; the model's
``remat_blocks``), re-entering the overlay or the merged weights for each
block's recompute.

``samples_per_step`` S > 1: the mean of S independent samples (each its own
pair, ``timesteps_to`` and initial latents; JAX vmaps them), one after the
other, each sample's gradient accumulated as it goes. ``share_warmup``:
one batch-1 warm-up chain to max(tₖ) with a snapshot at each tₖ; every
sample then uses sample 0's pair and initial latents (JAX's deviations).

On the card every joint attention runs kernel K1 and the student's
backward K2/K3; per step (one sample) 24·(tₖ + 3) K1 launches at
SD3-Medium's depth — the warm-up's tₖ calls, the teacher, the student and
its recompute — and 24 each of K2 and K3.

Randomness: the step takes the draws (a list of :class:`Draw`, as the parity
tests derive them from the JAX key) or makes them from ``esd.TrainRNG``:
pairs and ``timesteps_to`` from its CPU generator, the latents from its
device generator.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, ContextManager, List, Optional, Sequence

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite
from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler, FlowSchedule
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
class SD3ESDConfig:
    max_denoising_steps: int = 50
    train_cfg_scale: float = 1.0
    batch_size: int = 1
    height: int = 512
    width: int = 512
    latent_channels: int = 16
    remat: bool = True  # the student's blocks under torch.utils.checkpoint
    samples_per_step: int = 1
    share_warmup: bool = False
    student_overlay: bool = False
    overlay_warmup: Optional[bool] = None  # None follows student_overlay
    mesh: Optional[object] = None  # the samples shard over its data axis (parallel/mesh.py); None: one process


@dataclass
class Draw:
    """One sample's draws."""

    pair: int
    timesteps_to: int
    latents0: torch.Tensor  # [B, C, H/8, W/8] fp32


def draw_step(rng: TrainRNG, n_pairs: int, cfg: SD3ESDConfig, device) -> List[Draw]:
    """One iteration's draws, one per sample."""
    out = []
    shape = (cfg.batch_size, cfg.latent_channels, cfg.height // 8, cfg.width // 8)  # the VAE's 8× downsampling
    for _ in range(cfg.samples_per_step):
        pair = int(torch.randint(0, n_pairs, (), generator=rng.host))
        t_to = int(torch.randint(1, cfg.max_denoising_steps, (), generator=rng.host))
        out.append(Draw(pair, t_to, torch.randn(shape, generator=rng.device, device=device)))
    return out


class SD3ESDStep:
    """``step(opt_state, bank, rng=None, draws=None) -> {"loss", "grad_norm",
    "timesteps_to"}``: device scalars (the pre-clip global gradient norm) and
    the warm-up length (a list for several samples). The factors and the
    optimizer state are updated in place."""

    def __init__(self, transformer, sites: Sequence[LoRASite], lora_params: LoRAParams, schedule: FlowSchedule,
                 optimizer: Optimizer, cfg: SD3ESDConfig, merge_fn: Optional[Callable] = None,
                 debug_nans: bool = False, warm_transformer=None):
        merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
        overlay_warmup = cfg.student_overlay if cfg.overlay_warmup is None else cfg.overlay_warmup
        # the JAX step's refusals
        if warm_transformer is not None and not cfg.student_overlay:
            raise ValueError("warm_apply requires student_overlay=True (quantized base)")
        if overlay_warmup and not cfg.student_overlay:
            raise ValueError("overlay_warmup=True requires student_overlay=True")
        if not overlay_warmup and warm_transformer is not None:
            raise ValueError(
                "overlay_warmup=False needs the merged warm-up tree — impossible "
                "with a distinct warm_apply (quantized base)"
            )
        if cfg.student_overlay and merge is not lora_lib.merge_lora_params:
            raise ValueError("student_overlay supports the LoRA overlay only (DoRA merges)")
        if cfg.share_warmup and (cfg.samples_per_step == 1 or cfg.batch_size != 1):
            raise ValueError(
                "share_warmup needs the multi-sample path "
                "(samples_per_step > 1, batch_size == 1)"
            )
        self.model, self.sites, self.lora_params = transformer, sites, lora_params
        self.schedule, self.optimizer, self.cfg = schedule, optimizer, cfg
        self.merge, self.debug_nans, self.overlay_warmup = merge, debug_nans, overlay_warmup
        self.use_cfg = float(cfg.train_cfg_scale) != 1.0  # g == 1: u + 1·(c − u) ≡ c, cond rows only
        self.overlay = LoRAOverlay(transformer, sites, lora_params)
        self.warm_model = transformer if warm_transformer is None else warm_transformer
        self.warm_overlay = (self.overlay if warm_transformer is None
                             else LoRAOverlay(warm_transformer, sites, lora_params))
        self.params = flat_params(sites, lora_params)
        self.device = self.params[0].device
        self.one = torch.ones((1,), device=self.device)
        self.timesteps = schedule.timesteps.to(self.device)

    # --- rows ---------------------------------------------------------------

    def _tile(self, x):  # [S, D] -> [b, S, D]
        b = self.cfg.batch_size
        return x[None].expand((b,) + tuple(x.shape))

    def _cfg_rows(self, bank: PromptBank, pair: int, role: int):
        """(text rows, pooled rows) of one role: [uncond rows, role rows] under CFG."""
        roles = (ROLE_UNCOND, role) if self.use_cfg else (role,)
        text = torch.cat([self._tile(bank.text[pair, r]) for r in roles])
        pooled = torch.cat([self._tile(bank.pooled[pair, r]) for r in roles])
        return text, pooled

    def cfg_step(self, call: Callable, latents: torch.Tensor, rows, step_index: int) -> torch.Tensor:
        """CFG velocity, then the flow step from ``step_index``
        (``predict_noise_sd3``)."""
        text, pooled = rows
        if not self.use_cfg:
            v = call(latents, self.timesteps[step_index].expand(latents.shape[0]), text, pooled)
            return FlowMatchScheduler.step(self.schedule, v, step_index, latents)
        v_u, v_c = call(torch.cat([latents] * 2), self.timesteps[step_index].expand(2 * latents.shape[0]),
                        text, pooled).chunk(2)
        guided = v_u + self.cfg.train_cfg_scale * (v_c - v_u)
        return FlowMatchScheduler.step(self.schedule, guided, step_index, latents)

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
        if self.overlay_warmup:
            with torch.no_grad(), self.warm_overlay(self.one):
                yield self.warm_model
            return
        with torch.no_grad():
            merged = self.merge(self.model, self.sites, self.lora_params, 1.0)
            with self._merged(merged):
                yield self.model

    def warm_up(self, bank: PromptBank, pair: int, latents0: torch.Tensor, timesteps_to: Sequence[int]):
        """The warm-up chain from ``latents0`` with the target rows, a
        snapshot after each step count in ``timesteps_to`` (``[len, B, ...]``)."""
        rows = self._cfg_rows(bank, pair, ROLE_TARGET)
        want = sorted(set(timesteps_to))
        snaps = {}
        lat = latents0
        with self._warm() as model:
            for i in range(want[-1]):
                lat = self.cfg_step(model, lat, rows, i)
                if i + 1 in want:
                    snaps[i + 1] = lat
        return torch.stack([snaps[t] for t in timesteps_to])

    # --- teacher, student, loss --------------------------------------------

    def sample_loss(self, bank: PromptBank, pair: int, denoised: torch.Tensor, t_idx: int) -> torch.Tensor:
        """Teacher target and the student's loss at flow step ``t_idx`` from
        the gradient-free warm-up context ``denoised`` ``[B, C, h, w]``."""
        cfg = self.cfg
        roles = (ROLE_POSITIVE, ROLE_NEUTRAL, ROLE_NEGATIVE)
        if self.use_cfg:
            roles = (ROLE_UNCOND,) + roles
        k = len(roles)
        with torch.no_grad(), self.overlay(None):
            text = torch.cat([self._tile(bank.text[pair, r]) for r in roles])
            pooled = torch.cat([self._tile(bank.pooled[pair, r]) for r in roles])
            v = self.model(torch.cat([denoised] * k), self.timesteps[t_idx].expand(k * denoised.shape[0]),
                           text, pooled).chunk(k)
            if self.use_cfg:
                v_u, v = v[0], v[1:]
                v = [v_u + cfg.train_cfg_scale * (vc - v_u) for vc in v]
            pos, neu, neg = (FlowMatchScheduler.step(self.schedule, vc, t_idx, denoised) for vc in v)
            scale = bank.sign[pair] * bank.guidance[pair]
            target = (neu + scale * (pos - neg)).float()

        rows = self._cfg_rows(bank, pair, ROLE_TARGET)
        if cfg.student_overlay:
            ctx = lambda: self.overlay(self.one)  # noqa: E731 — re-entered by each block's recompute
        else:
            merged = self.merge(self.model, self.sites, self.lora_params, 1.0, grad=True)
            ctx = lambda: self._merged(merged)  # noqa: E731

        def student(x, t, text_rows, pooled_rows):
            return self.model(x, t, text_rows, pooled_rows, remat_blocks=cfg.remat,
                              remat_context=ctx if cfg.remat else None)

        with ctx():
            tgt = self.cfg_step(student, denoised, rows, t_idx)
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
        t_to = [d.timesteps_to for d in draws]
        lo, hi = mesh_lib.data_share(n, cfg.mesh)  # this rank's samples (all of them off-mesh)

        def tails():
            """(pair, warm-up context, t_k) of each of this rank's samples."""
            if cfg.share_warmup:  # one chain: sample 0's pair and latents, a snapshot at each t_k
                pair0 = draws[0].pair
                snaps = self.warm_up(bank, pair0, draws[0].latents0[:1], t_to[lo:hi])
                for j, t in enumerate(t_to[lo:hi]):
                    yield pair0, snaps[j], t
            else:
                for d in draws[lo:hi]:
                    yield d.pair, self.warm_up(bank, d.pair, d.latents0, [d.timesteps_to])[0], d.timesteps_to

        loss, grads = None, None
        with torch.enable_grad():
            for pair, denoised, t in tails():
                l_j = self.sample_loss(bank, pair, denoised, t)
                g = torch.autograd.grad(l_j / n, self.params)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                loss = l_j.detach() / n if loss is None else loss + l_j.detach() / n
        loss, grads = mesh_reduce(loss, grads, cfg.mesh, merged_student=not cfg.student_overlay)
        if self.debug_nans:
            raise_if_nonfinite(loss, grads)
        g_norm = self.optimizer.global_norm(grads)
        self.optimizer.step(self.params, grads, opt_state, g_norm=g_norm)
        return {"loss": loss, "grad_norm": g_norm, "timesteps_to": t_to[0] if n == 1 else t_to}


def make_sd3_esd_train_step(transformer, sites: Sequence[LoRASite], lora_params: LoRAParams,
                            schedule: FlowSchedule, optimizer: Optimizer, cfg: SD3ESDConfig,
                            merge_fn: Optional[Callable] = None, debug_nans: bool = False,
                            warm_transformer=None) -> SD3ESDStep:
    """Build the step (:class:`SD3ESDStep`); the JAX step's refusals of
    invalid combinations raise ``ValueError``."""
    return SD3ESDStep(transformer, sites, lora_params, schedule, optimizer, cfg, merge_fn, debug_nans,
                      warm_transformer)
