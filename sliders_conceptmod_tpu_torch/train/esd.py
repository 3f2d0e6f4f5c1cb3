"""The ESD slider training step — counterpart of
``sliders_conceptmod_tpu/train/esd.py``.

One iteration (reference ``conceptmod/textsliders/train_lora_xl.py:165-351``):

1. draw a prompt pair and ``timesteps_to ∈ [1, max_denoising_steps)``;
2. denoise from pure noise for ``timesteps_to`` steps with the slider ON,
   gradient-free (the warm-up);
3. teacher ε for rows [positive, neutral, negative] (plus the uncond row
   first when ``train.cfg ≠ 1``) with the slider OFF, in one UNet call;
4. student ε for the target prompt with the slider ON and gradients flowing;
5. loss = MSE(student, neutral + sign·g·(positive − negative)) in fp32, then
   the global gradient norm, the clip and the optimizer.

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

The JAX step's knobs (``ESDConfig``), with its refusals of invalid
combinations (``ValueError``):

* ``samples_per_step`` S > 1: with ``batch_size`` 1 the samples ride the
  row axis — one masked warm-up to max(tₖ)
  (``denoise_partial_per_row``), one teacher call, one student call, the
  warm-up noise one shared draw per iteration; otherwise the mean of S
  one-sample losses (JAX vmaps them);
* ``share_warmup`` (fused samples only): one batch-1 chain with a snapshot
  at each tₖ (``denoise_shared_snapshots``): one pair, one initial latent,
  correlated noise and sample 0's crop per step — JAX's deviations;
* ``fuse_teacher_student``: the teacher rows at slider scale 0 and the
  student rows at scale 1 in one overlay call (LoRA, ``train.cfg`` 1 and one
  sample only);
* ``pipeline_warmup``: step k trains on the warm-up drawn by step k−1 and
  draws step k+1's from the factors as they were before its update (the
  warm-up runs before the optimizer writes the factors in place); one
  sample only;
* ``dynamic_crops`` (XL): the crop conditioning redrawn every iteration
  (:func:`draw_time_ids`), the same crop for warm-up, teacher and student;
* ``mesh`` (data parallelism, ``parallel/mesh.py``): every rank draws all S
  samples from the one seed, as one process does, and takes its own
  ``S / mesh_data`` of them (:func:`shard_draws`); the loss and the gradient
  are summed over the data axis (each sample's share already divided by S)
  before the clip and the optimizer, so every rank takes the same step and
  the result does not depend on the mesh. Under tensor parallelism the
  merged student's factor gradients, each rank's through its rows of the
  merged weights, are summed over the model axis;
* ``remat_student``: the student call under ``torch.utils.checkpoint``
  (non-reentrant; the overlay's hooks and the merged weights are entered
  inside the checkpointed function, so the recompute sees them), by default
  above 512px as the JAX trainer sets ``remat_unet``. The recompute runs the
  student's forward kernels a second time.

The int8 base (``tpu.quantize_base``) needs no code of its own here: its
``QuantLinear``s (``adapters/quant.py``) sit where the Linears were, so the
overlay's hooks and the checkpointed student's recompute go through them.
``warm_unet`` (``tpu.w8a8_warmup``) is the warm-up's own UNet — the int8
base's tensors with W8A8 on, or an int8 copy of a full-precision base
(the dual tree) — under an overlay bound to it with the same factor tensors;
the teacher and the student stay weight-only on ``unet``, as JAX's do.

The teacher is the bare base. On the card every UNet attention runs kernel
K1 (K4a at head dims 129…512), and the student's backward runs K2 and K3
(K4b and K4c) (``ops/flash_attention.py``, ``ops/flash_attention_kgrid.py``).

Randomness: the step takes the draws (:class:`Draws`, :class:`FusedDraws`,
or a list of :class:`Draws` for the one-sample loop) — as the parity tests
derive them from the JAX key — or makes them from :class:`TrainRNG`: pairs,
``timesteps_to`` and crop uniforms from a CPU generator (reading them never
waits on the card), the latents and the warm-up noise from a generator on the
device. The LoRA factors and the optimizer state are updated in place.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import LoRAOverlay, LoRAParams, LoRASite
from sliders_conceptmod_tpu_torch.core.prompts import action_sign
from sliders_conceptmod_tpu_torch.diffusion.sampling import (
    current_train_timestep,
    denoise_partial,
    denoise_partial_per_row,
    denoise_shared_snapshots,
    get_initial_latents,
    predict_noise,
)
from sliders_conceptmod_tpu_torch.diffusion.schedulers import NoiseScheduler, Schedule
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train.optim import Optimizer, flat_params

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
    samples_per_step: int = 1  # S > 1: on the row axis at batch_size 1, else the one-sample loop
    fuse_teacher_student: bool = False
    dynamic_crops: bool = False  # XL only: the crop conditioning redrawn per iteration
    pipeline_warmup: bool = False
    share_warmup: bool = False
    remat_student: Optional[bool] = None  # None: max(height, width) > 512
    # the (data, model) mesh: the samples shard over its data axis (parallel/mesh.py); None: one process
    mesh: Optional[object] = None

    @property
    def fused_samples(self) -> bool:
        return self.samples_per_step > 1 and self.batch_size == 1

    @property
    def remat(self) -> bool:
        return max(self.height, self.width) > 512 if self.remat_student is None else self.remat_student


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
    """One sample's random draws."""

    pair: int
    timesteps_to: int
    latents0: torch.Tensor  # [B, 4, H/8, W/8] initial latents (noise · init_noise_sigma)
    warm_noise: torch.Tensor  # [timesteps_to, B, 4, H/8, W/8] per-step scheduler noise
    time_ids: Optional[torch.Tensor] = None  # [1, 6] the iteration's crop (dynamic_crops)


@dataclass
class FusedDraws:
    """The draws of S samples on the row axis (``samples_per_step`` with
    ``batch_size`` 1)."""

    pairs: List[int]
    timesteps_to: List[int]
    latents0: torch.Tensor  # [S, 4, H/8, W/8]
    warm_noise: torch.Tensor  # [max(timesteps_to), S, ...]; [..., 1, ...] under share_warmup
    time_ids: Optional[torch.Tensor] = None  # [S, 6] each sample's crop (dynamic_crops)
    # share_warmup on a data-axis rank: the step's sample 0's crop, which the one chain takes
    chain_time_ids: Optional[torch.Tensor] = None


StepDraws = Union[Draws, FusedDraws, List[Draws]]


class TrainRNG:
    """The trainer's generators: ``host`` (CPU) draws the pairs,
    ``timesteps_to`` and crop uniforms; ``device`` draws the latents and the
    warm-up noise."""

    def __init__(self, seed: int, device):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)

    def get_state(self) -> dict:
        return {"host": self.host.get_state(), "device": self.device.get_state()}

    def set_state(self, state: dict) -> None:
        self.host.set_state(state["host"])
        self.device.set_state(state["device"])


def draw_time_ids(u1: float, u2: float, u3: float, height: int, width: int) -> np.ndarray:
    """XL crop conditioning ``[1, 6]`` fp32 from three uniforms in [0, 1) —
    the JAX ``draw_time_ids`` (reference get_add_time_ids with
    dynamic_crops): original size = target × (2·u1 + 1), crop top-left
    uniform over the overhang, all in fp32 as JAX computes it."""
    f = np.float32
    scale = f(u1) * f(2.0) + f(1.0)
    oh, ow = np.floor(f(height) * scale), np.floor(f(width) * scale)
    top = np.floor(f(u2) * np.maximum(oh - f(height), f(1.0)))
    left = np.floor(f(u3) * np.maximum(ow - f(width), f(1.0)))
    return np.array([[oh, ow, top, left, height, width]], dtype=np.float32)


def _host_sample(rng: TrainRNG, n_pairs: int, cfg: ESDConfig, crops: bool):
    pair = int(torch.randint(0, n_pairs, (), generator=rng.host))
    timesteps_to = int(torch.randint(1, cfg.max_denoising_steps, (), generator=rng.host))
    tids = None
    if crops:
        u = torch.rand(3, generator=rng.host, dtype=torch.float32).tolist()
        tids = draw_time_ids(*u, cfg.height, cfg.width)
    return pair, timesteps_to, tids


def draw(rng: TrainRNG, n_pairs: int, schedule: Schedule, cfg: ESDConfig, device, crops: bool = False) -> Draws:
    """One sample's draws (``crops``: an XL step with ``dynamic_crops``)."""
    pair, timesteps_to, tids = _host_sample(rng, n_pairs, cfg, crops)
    latents0 = get_initial_latents(schedule, cfg.batch_size, cfg.height, cfg.width, generator=rng.device,
                                   device=device)
    warm_noise = torch.randn((timesteps_to,) + tuple(latents0.shape), generator=rng.device, device=device)
    return Draws(pair, timesteps_to, latents0, warm_noise,
                 None if tids is None else torch.from_numpy(tids).to(device))


def draw_fused(rng: TrainRNG, n_pairs: int, schedule: Schedule, cfg: ESDConfig, device,
               crops: bool = False) -> FusedDraws:
    """S samples' pairs, ``timesteps_to`` and crops, their initial latents,
    and one shared warm-up noise draw (one batch-1 chain's under
    ``share_warmup``)."""
    host = [_host_sample(rng, n_pairs, cfg, crops) for _ in range(cfg.samples_per_step)]
    latents0 = get_initial_latents(schedule, cfg.samples_per_step, cfg.height, cfg.width, generator=rng.device,
                                   device=device)
    chain = latents0[:1] if cfg.share_warmup else latents0
    t_to = [h[1] for h in host]
    warm_noise = torch.randn((max(t_to),) + tuple(chain.shape), generator=rng.device, device=device)
    tids = torch.from_numpy(np.concatenate([h[2] for h in host])).to(device) if crops else None
    return FusedDraws([h[0] for h in host], t_to, latents0, warm_noise, tids)


def draw_step(rng: TrainRNG, n_pairs: int, schedule: Schedule, cfg: ESDConfig, device,
              crops: bool = False) -> StepDraws:
    """One iteration's draws for the step's sample layout."""
    if cfg.samples_per_step == 1:
        return draw(rng, n_pairs, schedule, cfg, device, crops)
    if cfg.fused_samples:
        return draw_fused(rng, n_pairs, schedule, cfg, device, crops)
    return [draw(rng, n_pairs, schedule, cfg, device, crops) for _ in range(cfg.samples_per_step)]


def shard_draws(draws: StepDraws, cfg: ESDConfig) -> StepDraws:
    """This rank's share of one iteration's draws along the mesh's data
    axis (all of them off-mesh). Under ``share_warmup`` every rank keeps the
    step's one chain (sample 0's latent, pair, crop and noise) and its own
    snapshot depths."""
    mesh = cfg.mesh
    if mesh_lib.dp_size(mesh) <= 1 or isinstance(draws, Draws):
        return draws
    lo, hi = mesh_lib.data_share(cfg.samples_per_step, mesh)
    if isinstance(draws, list):
        return draws[lo:hi]
    tids = None if draws.time_ids is None else draws.time_ids[lo:hi]
    if cfg.share_warmup:
        return FusedDraws([draws.pairs[0]] * (hi - lo), draws.timesteps_to[lo:hi], draws.latents0[:1],
                          draws.warm_noise, tids, None if draws.time_ids is None else draws.time_ids[:1])
    return FusedDraws(draws.pairs[lo:hi], draws.timesteps_to[lo:hi], draws.latents0[lo:hi],
                      draws.warm_noise[:, lo:hi], tids)


def mesh_reduce(loss: torch.Tensor, grads: Sequence[torch.Tensor], mesh, merged_student: bool):
    """A rank's ``(loss, grads)`` over its share of the step's samples (each
    sample's loss already divided by the step's sample count) → the step's,
    the same on every rank: summed over the data axis, and, for a merged
    student over a tensor-sharded base (each model rank's gradient flows
    through its rows of the merged weights), over the model axis first."""
    if mesh is None:
        return loss, list(grads)
    if merged_student:
        grads = mesh_lib.sum_grads(grads, mesh.model_group)
    return mesh_lib.data_mean(loss, grads, mesh)


def raise_if_nonfinite(loss: torch.Tensor, grads: Sequence[torch.Tensor]) -> None:
    """``FloatingPointError`` unless the loss and every gradient are finite —
    ``tpu.debug_nans``, where the JAX trainers set ``jax_debug_nans`` and
    stop at the first NaN. One device-to-host read; a caller without the
    flag never calls it, so the default step adds no sync."""
    finite = torch.stack([torch.isfinite(loss).all()] + [torch.isfinite(g).all() for g in grads]).all()
    if not bool(finite):
        raise FloatingPointError("non-finite loss or gradient (tpu.debug_nans)")


@dataclass
class Carry:
    """A warm-up's result, consumed by the teacher and student (at once, or
    one step later under ``pipeline_warmup``). ``pairs``/``current_t`` are
    host ints for one sample and lists for fused samples."""

    pairs: Union[int, List[int]]
    denoised: torch.Tensor
    current_t: Union[int, List[int]]
    timesteps_to: Union[int, List[int]]
    time_ids: Optional[torch.Tensor] = None


class ESDStep:
    """``step(opt_state, bank, rng=None, draws=None) -> {"loss", "grad_norm",
    "timesteps_to"}``: device scalars (the pre-clip global gradient norm)
    and the warm-up length(s) as host ints. Under ``pipeline_warmup`` call
    :meth:`init_carry` first; ``draws`` are then the next step's, and the
    metrics add ``next_timesteps_to``, the warm-up the step drew for the
    next."""

    def __init__(self, unet, sites, lora_params, scheduler, schedule, optimizer, cfg: ESDConfig,
                 add_time_ids=None, merge_fn=None, debug_nans=False, warm_unet=None):
        merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
        is_lora = merge is lora_lib.merge_lora_params
        use_cfg = float(cfg.train_cfg_scale) != 1.0
        # the JAX step's refusals
        if cfg.fuse_teacher_student:
            if use_cfg:
                raise ValueError("fuse_teacher_student requires guidance == 1 (cond-only rows)")
            if not is_lora:
                raise ValueError("fuse_teacher_student supports the LoRA overlay only")
            if cfg.samples_per_step != 1:
                raise ValueError("fuse_teacher_student supports samples_per_step == 1 only")
        if cfg.share_warmup and not cfg.fused_samples:
            raise ValueError("share_warmup needs the fused multi-sample path "
                             "(samples_per_step > 1, fuse_samples, batch_size == 1)")
        if cfg.student_overlay and not is_lora:
            raise ValueError("student_overlay supports the LoRA overlay only (DoRA merges)")
        if warm_unet is not None and not cfg.student_overlay:
            raise ValueError("warm_apply requires student_overlay=True (quantized base)")
        if cfg.overlay_warmup is False and warm_unet is not None:
            raise ValueError(
                "overlay_warmup=False needs the merged warm-up tree — impossible "
                "with a distinct warm_apply (quantized base)"
            )
        if cfg.overlay_warmup and not cfg.student_overlay:
            raise ValueError("overlay_warmup=True requires student_overlay=True")
        if cfg.pipeline_warmup and cfg.samples_per_step != 1:
            raise ValueError("pipeline_warmup supports samples_per_step == 1 only")
        self.unet, self.sites, self.lora_params = unet, sites, lora_params
        self.scheduler, self.schedule, self.optimizer, self.cfg = scheduler, schedule, optimizer, cfg
        self.merge, self.debug_nans, self.use_cfg = merge, debug_nans, use_cfg
        self.overlay_warmup = cfg.overlay_warmup if cfg.overlay_warmup is not None else cfg.student_overlay
        self.is_xl = add_time_ids is not None
        self.add_time_ids = add_time_ids
        self.crops = cfg.dynamic_crops and self.is_xl
        self.overlay = LoRAOverlay(unet, sites, lora_params)
        self.warm_unet = unet if warm_unet is None else warm_unet
        self.warm_overlay = self.overlay if warm_unet is None else LoRAOverlay(warm_unet, sites, lora_params)
        self.params = flat_params(sites, lora_params)
        self.device = self.params[0].device
        self.one = torch.ones((1,), device=self.device)
        self.carry: Optional[Carry] = None

    # --- rows ---------------------------------------------------------------

    def _tile(self, x):  # [S, D] -> [b, S, D]
        b = self.cfg.batch_size
        return x[None].expand((b,) + tuple(x.shape)).contiguous()

    def _sample_rows(self, bank: PromptBank, pair: int, tids):
        """(role_text, role_pooled, tids_rows) of one sample: role r's rows
        ``[b, S, D]``, ``[b, P]``, ``[b, 6]``."""
        text = bank.text[pair]
        pooled = bank.pooled[pair] if bank.pooled is not None else None
        tids = self.add_time_ids if tids is None else tids
        b = self.cfg.batch_size
        return ((lambda r: self._tile(text[r])), (lambda r: self._tile(pooled[r])) if self.is_xl else None,
                tids.expand(b, 6) if self.is_xl else None)

    def _fused_rows(self, bank: PromptBank, pairs: List[int], tids):
        idx = torch.tensor(pairs, device=bank.text.device)
        text = bank.text[idx]  # [S, 5, seq, D]
        pooled = bank.pooled[idx] if bank.pooled is not None else None
        n = len(pairs)
        tids = (self.add_time_ids if tids is None else tids)
        return ((lambda r: text[:, r]), (lambda r: pooled[:, r]) if self.is_xl else None,
                tids.expand(n, 6) if self.is_xl else None)

    def _cfg_rows(self, role_text, role_pooled, tids_rows, role):
        """(text rows, XL kwargs) of one role for a UNet call on the
        latents — [uncond rows, role rows] under CFG."""
        roles = (ROLE_UNCOND, role) if self.use_cfg else (role,)
        t = torch.cat([role_text(r) for r in roles])
        kw = None
        if self.is_xl:
            kw = {"text_embeds": torch.cat([role_pooled(r) for r in roles]),
                  "time_ids": tids_rows.repeat(len(roles), 1)}
        return t, kw

    @staticmethod
    def _loss_scale(bank: PromptBank, pairs, device):
        """sign·g of the loss: a host float for one sample, ``[S, 1, 1, 1]``
        for fused samples."""
        if isinstance(pairs, int):
            return bank.sign[pairs] * bank.guidance[pairs]
        return torch.tensor([bank.sign[p] * bank.guidance[p] for p in pairs], device=device).reshape(-1, 1, 1, 1)

    # --- warm-up ------------------------------------------------------------

    @contextmanager
    def _warm_unet(self) -> Iterator[Callable]:
        """Slider ON, no gradients: the overlay (on ``warm_unet``), or one
        merge per step."""
        if self.overlay_warmup:
            with torch.no_grad(), self.warm_overlay(self.one):
                yield self.warm_unet
            return
        with torch.no_grad(), self.overlay(None):
            yield merged_call(self.unet, self.merge(self.unet, self.sites, self.lora_params, 1.0))

    def warm_draw(self, bank: PromptBank, draws: Union[Draws, FusedDraws]) -> Carry:
        """(2): the warm-up of one sample, or of fused samples."""
        cfg, sched, schedule = self.cfg, self.scheduler, self.schedule
        if isinstance(draws, Draws):
            role_text, role_pooled, tids_rows = self._sample_rows(bank, draws.pair, draws.time_ids)
            rows, kw = self._cfg_rows(role_text, role_pooled, tids_rows, ROLE_TARGET)
            with self._warm_unet() as warm:
                denoised = denoise_partial(warm, sched, schedule, draws.latents0, rows,
                                           total_steps=draws.timesteps_to, guidance_scale=cfg.train_cfg_scale,
                                           added_cond_kwargs=kw, noise=draws.warm_noise)
            return Carry(draws.pair, denoised,
                         current_train_timestep(draws.timesteps_to, cfg.max_denoising_steps, cfg.num_train_timesteps),
                         draws.timesteps_to, draws.time_ids)
        pairs = [draws.pairs[0]] * len(draws.pairs) if cfg.share_warmup else list(draws.pairs)
        role_text, role_pooled, tids_rows = self._fused_rows(bank, pairs, draws.time_ids)
        with self._warm_unet() as warm:
            if cfg.share_warmup:  # one batch-1 chain: sample 0's latent, context and crop
                chain_tids = None if tids_rows is None else (
                    tids_rows[:1] if draws.chain_time_ids is None else draws.chain_time_ids)
                rows, kw = self._cfg_rows(lambda r: role_text(r)[:1], role_pooled and (lambda r: role_pooled(r)[:1]),
                                          chain_tids, ROLE_TARGET)
                denoised = denoise_shared_snapshots(
                    warm, sched, schedule, draws.latents0[:1], rows, total_steps=draws.timesteps_to,
                    guidance_scale=cfg.train_cfg_scale, added_cond_kwargs=kw, noise=draws.warm_noise)
            else:
                rows, kw = self._cfg_rows(role_text, role_pooled, tids_rows, ROLE_TARGET)
                denoised = denoise_partial_per_row(
                    warm, sched, schedule, draws.latents0, rows, total_steps=draws.timesteps_to,
                    guidance_scale=cfg.train_cfg_scale, added_cond_kwargs=kw, noise=draws.warm_noise)
        current_t = [current_train_timestep(t, cfg.max_denoising_steps, cfg.num_train_timesteps)
                     for t in draws.timesteps_to]
        return Carry(pairs, denoised, current_t, list(draws.timesteps_to), draws.time_ids)

    # --- teacher, student, loss --------------------------------------------

    def _student(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` with gradients, under ``torch.utils.checkpoint`` when the
        student is rematerialised (``fn`` enters the overlay / merged weights
        itself, so the recompute in the backward sees them too)."""
        if self.cfg.remat:
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    def sample_loss(self, carry: Carry, bank: PromptBank) -> torch.Tensor:
        """(3)-(4): teacher, ESD target and the student's loss, with the graph
        to the factors."""
        cfg, sched, schedule = self.cfg, self.scheduler, self.schedule
        fused = not isinstance(carry.pairs, int)
        if fused:
            role_text, role_pooled, tids_rows = self._fused_rows(bank, carry.pairs, carry.time_ids)
            t = torch.tensor(carry.current_t, device=self.device)
        else:
            role_text, role_pooled, tids_rows = self._sample_rows(bank, carry.pairs, carry.time_ids)
            t = carry.current_t
        scale = self._loss_scale(bank, carry.pairs, self.device)
        denoised = carry.denoised
        n = denoised.shape[0]

        def call_rows(roles):
            """(scaled latents, timesteps, text rows, XL kwargs) of one call
            over ``roles``, the latents repeated per role."""
            k = len(roles)
            t_rows = t.repeat(k) if fused else t
            x = sched.scale_model_input_train_t(schedule, torch.cat([denoised] * k), t_rows)
            kw = None
            if self.is_xl:
                kw = {"text_embeds": torch.cat([role_pooled(r) for r in roles]), "time_ids": tids_rows.repeat(k, 1)}
            return x, t_rows, torch.cat([role_text(r) for r in roles]), kw

        if cfg.fuse_teacher_student:
            # one call: [positive, neutral, negative | target] at slider scales [0, 0, 0 | 1]
            x, t_rows, text_rows, kw = call_rows((ROLE_POSITIVE, ROLE_NEUTRAL, ROLE_NEGATIVE, ROLE_TARGET))
            row_scale = torch.cat([torch.zeros(3 * n, device=self.device), torch.ones(n, device=self.device)])

            def fused_call(x_in):
                with self.overlay(row_scale):
                    return self.unet(x_in, t_rows, text_rows, added_cond_kwargs=kw)

            with torch.enable_grad():
                e_pos, e_neu, e_neg, e_stu = self._student(fused_call, x).chunk(4)
                target = (e_neu.float() + scale * (e_pos - e_neg).float()).detach()
                return torch.mean((e_stu.float() - target) ** 2)

        roles = (ROLE_POSITIVE, ROLE_NEUTRAL, ROLE_NEGATIVE)
        if self.use_cfg:
            roles = (ROLE_UNCOND,) + roles
        with torch.no_grad(), self.overlay(None):
            x, t_rows, text_rows, kw = call_rows(roles)
            eps = self.unet(x, t_rows, text_rows, added_cond_kwargs=kw)
            if self.use_cfg:
                e_u, e_pos, e_neu, e_neg = eps.chunk(4)
                gs = cfg.train_cfg_scale
                e_pos, e_neu, e_neg = (e_u + gs * (e - e_u) for e in (e_pos, e_neu, e_neg))
            else:
                e_pos, e_neu, e_neg = eps.chunk(3)
            # ESD target neutral ∓ g·(positive − negative), fp32 as the JAX step promotes it
            target = e_neu.float() + scale * (e_pos - e_neg).float()

        target_rows, target_kw = self._cfg_rows(role_text, role_pooled, tids_rows, ROLE_TARGET)
        with torch.enable_grad():
            merged = (None if cfg.student_overlay
                      else self.merge(self.unet, self.sites, self.lora_params, 1.0, grad=True))

            def student_call(x_in):
                with self.overlay(self.one if cfg.student_overlay else None):
                    u = self.unet if merged is None else merged_call(self.unet, merged)
                    return predict_noise(u, sched, schedule, x_in, target_rows, train_t=t,
                                         guidance_scale=cfg.train_cfg_scale, added_cond_kwargs=target_kw)

            student = self._student(student_call, denoised)
            return torch.mean((student.float() - target) ** 2)

    def _loss_and_grads(self, losses_of: Callable[[], List[torch.Tensor]]):
        """Mean loss and its gradients; the one-sample loop backpropagates
        each sample's share as it goes."""
        cfg = self.cfg
        with torch.enable_grad():
            total, grads = None, None
            for loss in losses_of():
                # each sample's share of the whole step's mean (a fused rank's rows are 1/mesh_data of it)
                n = cfg.samples_per_step if not cfg.fused_samples else mesh_lib.dp_size(cfg.mesh)
                g = torch.autograd.grad(loss / n, self.params)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                total = loss.detach() / n if total is None else total + loss.detach() / n
        return mesh_reduce(total, grads, cfg.mesh, merged_student=not cfg.student_overlay)

    # --- the step -------------------------------------------------------------

    def draw(self, bank: PromptBank, rng: TrainRNG) -> StepDraws:
        return draw_step(rng, bank.text.shape[0], self.schedule, self.cfg, self.device, self.crops)

    def init_carry(self, bank: PromptBank, rng: Optional[TrainRNG] = None, draws: Optional[Draws] = None) -> Carry:
        """``pipeline_warmup``: the first step's warm-up."""
        self.carry = self.warm_draw(bank, draws if draws is not None else self.draw(bank, rng))
        return self.carry

    def __call__(self, opt_state: dict, bank: PromptBank, rng: Optional[TrainRNG] = None,
                 draws: Optional[StepDraws] = None) -> dict:
        cfg = self.cfg
        if cfg.pipeline_warmup:
            if self.carry is None:
                raise RuntimeError("pipeline_warmup: call init_carry before the first step")
            carry = self.carry
            loss, grads = self._loss_and_grads(lambda: [self.sample_loss(carry, bank)])
            t_to = carry.timesteps_to
        else:
            if draws is None:
                draws = self.draw(bank, rng)
            # the whole step's warm-up lengths, whichever share of the samples this rank runs
            t_to = [d.timesteps_to for d in draws] if isinstance(draws, list) else draws.timesteps_to
            if isinstance(t_to, list) and len(t_to) == 1:
                t_to = t_to[0]
            draws = shard_draws(draws, cfg)
            samples = draws if isinstance(draws, list) else [draws]
            carries: List[Carry] = []

            def losses():
                for d in samples:
                    carries.append(self.warm_draw(bank, d))
                    yield self.sample_loss(carries[-1], bank)

            loss, grads = self._loss_and_grads(losses)
        if self.debug_nans:
            raise_if_nonfinite(loss, grads)
        g_norm = self.optimizer.global_norm(grads)
        if cfg.pipeline_warmup:
            # the next step's warm-up reads the factors before this update writes them in place
            self.carry = self.warm_draw(bank, draws if draws is not None else self.draw(bank, rng))
        self.optimizer.step(self.params, grads, opt_state, g_norm=g_norm)
        metrics = {"loss": loss, "grad_norm": g_norm, "timesteps_to": t_to}
        if cfg.pipeline_warmup:
            metrics["next_timesteps_to"] = self.carry.timesteps_to
        return metrics


def make_esd_train_step(
    unet: torch.nn.Module,
    sites: Sequence[LoRASite],
    lora_params: LoRAParams,
    scheduler: NoiseScheduler,
    schedule: Schedule,
    optimizer: Optimizer,
    cfg: ESDConfig,
    add_time_ids: Optional[torch.Tensor] = None,  # [1, 6] for XL
    merge_fn: Optional[Callable] = None,  # adapter merge (LoRA default; DoRA passes its own)
    debug_nans: bool = False,
    warm_unet: Optional[torch.nn.Module] = None,
) -> ESDStep:
    """Build the step (:class:`ESDStep`). ``lora_params`` (fp32 leaves that
    require grad) and ``opt_state`` are updated in place; the overlay binds
    the factors once. The JAX step's refusals of invalid combinations raise
    ``ValueError``. ``debug_nans`` (``tpu.debug_nans``) checks the loss and
    the gradients before the update: :func:`raise_if_nonfinite`.
    ``warm_unet``: the warm-up's own UNet (JAX's ``warm_apply``; see the
    module docstring)."""
    return ESDStep(unet, sites, lora_params, scheduler, schedule, optimizer, cfg, add_time_ids, merge_fn, debug_nans,
                   warm_unet)
