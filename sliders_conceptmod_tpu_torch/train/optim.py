"""Optimizers and learning-rate schedules — counterpart of
``sliders_conceptmod_tpu/train/optim.py``.

Every optimizer here computes what the JAX package's ``get_optimizer``
chain computes, in place on a list of fp32 tensors:

* ``grad_clip_norm`` c (optax ``clip_by_global_norm``): ``g ← g`` when
  ``‖g‖ < c``, else ``g / ‖g‖ · c`` (not torch's ``c / (‖g‖ + 1e-6)``);
* then ``grad_clip_value`` v (optax ``clip``): ``g ← clamp(g, −v, v)``;
* then the update, scaled by the schedule at the step count (0 first):

  - :class:`AdamW` — optax ``adamw`` / ``adam`` (weight decay 0): moments
    ``μ ← (1 − b1)·g + b1·μ``, ``ν ← (1 − b2)·g² + b2·ν``, bias correction
    with the fp32 powers ``b1^t``, ``b2^t`` (t from 1), update
    ``μ̂ / (√ν̂ + eps) + wd·p``;
  - :class:`Lion` — optax ``lion``: ``u = sign((1 − b1)·g + b1·μ) + wd·p``,
    then ``μ ← (1 − b2)·g + b2·μ``;
  - :class:`SGD` — optax ``sgd``: ``trace ← g + momentum·trace``;
  - :class:`Prodigy`, :class:`DAdaptAdam`, :class:`DAdaptLion` — the JAX
    package's own bodies (``prodigy``, ``dadapt_adam``, ``dadapt_lion``):
    their scalar estimates (d, the running sums) are device scalars, so a
    step never reads the card.

The step count is a host integer and the schedules are host floats, so
nothing in an update waits on the device.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def parse_optimizer_args(optimizer_args: str) -> dict:
    """``'weight_decay=0.1 betas=(0.9,0.99)'`` → ``{'weight_decay': 0.1,
    'betas': (0.9, 0.99)}`` — the JAX package's parser."""
    out = {}
    if not optimizer_args:
        return out
    for k, v in re.findall(r"(\w+)\s*=\s*(\([^)]*\)|[^\s,]+)", optimizer_args):
        if v.startswith("("):
            out[k] = tuple(float(x) for x in v.strip("()").replace(",", " ").split())
        elif v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def get_lr_schedule(name: Optional[str], lr: float, max_iterations: int, lr_min: float = 0.0) -> Callable[[int], float]:
    """``count → lr`` as a host float (rounded to fp32, the JAX schedules'
    dtype), in the JAX package's closed forms of torch's schedulers:

    * ``constant``; ``cosine`` (CosineAnnealingLR, T_max = max_iterations);
    * ``cosine_with_restarts`` (CosineAnnealingWarmRestarts, T_0 = max//10,
      T_mult 2: segment k starts at T_0·(2^k − 1));
    * ``step`` (StepLR, step_size = max//100, gamma 0.999);
    * ``linear`` (LinearLR from 0.5 to 1 over max//100 steps);
    * ``constant_with_warmup`` (a 100-step linear warm-up, then constant: the
      notrigger trainer's)."""
    name = (name or "constant").lower()

    def f32(fn):
        return lambda step: float(np.float32(fn(step)))

    if name == "constant":
        return f32(lambda step: lr)
    if name == "cosine":
        t_max = max(max_iterations, 1)
        return f32(lambda step: lr_min + 0.5 * (lr - lr_min) * (1 + math.cos(math.pi * step / t_max)))
    if name == "cosine_with_restarts":
        t_0 = max(max_iterations // 10, 1)

        def restarts(step):
            k = math.floor(math.log2(step / t_0 + 1.0))
            t_cur, seg_len = step - t_0 * (2.0**k - 1.0), t_0 * 2.0**k
            return lr_min + 0.5 * (lr - lr_min) * (1 + math.cos(math.pi * t_cur / seg_len))

        return f32(restarts)
    if name == "step":
        step_size = max(max_iterations // 100, 1)
        gamma = float(np.float32(0.999))  # JAX raises the fp32 constant: its rounding compounds over the steps
        return f32(lambda step: lr * gamma ** math.floor(step / step_size))
    if name == "linear":
        total = max(max_iterations // 100, 1)
        return f32(lambda step: lr * (0.5 + 0.5 * min(max(step / total, 0.0), 1.0)))
    if name == "constant_with_warmup":
        return f32(lambda step: lr * min(max(step / 100, 0.0), 1.0))
    raise ValueError("Scheduler must be cosine, cosine_with_restarts, step, linear or constant")


def _sum_dots(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σᵢ ⟨aᵢ, bᵢ⟩ over the tensor lists (a device scalar)."""
    return torch.stack([torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b)]).sum()


def _l1(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ |x| over every tensor (a device scalar)."""
    return torch.stack(torch._foreach_norm(list(tensors), 1)).sum()


class Optimizer:
    """Clip, then the subclass's update, over a list of fp32 parameters
    updated in place (the port keeps one copy of the factors). The state is
    a dict of tensors, lists of tensors and host numbers; ``count`` is the
    host step count."""

    def __init__(self, lr_schedule: Callable[[int], float], grad_clip_norm: Optional[float] = None,
                 grad_clip_value: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.grad_clip_value = grad_clip_value

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": 0, **self._init(list(params))}

    def _init(self, params: List[torch.Tensor]) -> Dict:
        raise NotImplementedError

    def _update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict, lr: float) -> None:
        raise NotImplementedError

    @staticmethod
    def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt(Σ g²) over every gradient (a device scalar)."""
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    def clip(self, grads: List[torch.Tensor], g_norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        if self.grad_clip_norm is not None:
            c = self.grad_clip_norm
            g_norm = self.global_norm(grads) if g_norm is None else g_norm
            # optax: g when ‖g‖ < c, else g / ‖g‖ · c
            factor = torch.where(g_norm < c, torch.ones_like(g_norm), c / g_norm)
            grads = torch._foreach_mul(grads, factor)
        if self.grad_clip_value is not None:
            grads = torch._foreach_clamp_min(grads, -self.grad_clip_value)
            torch._foreach_clamp_max_(grads, self.grad_clip_value)
        return grads

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
             g_norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` and ``state`` in place, with multi-tensor
        (``torch._foreach_*``) ops: a LoRA over SDXL has ~1100 factor
        tensors. ``g_norm`` is the gradients' global norm if the caller has
        it already."""
        params = list(params)
        grads = self.clip(list(grads), g_norm)
        self._update(params, grads, state, self.lr_schedule(state["count"]))
        state["count"] += 1


class AdamW(Optimizer):
    """optax ``adamw`` (``adam``: weight decay 0)."""

    def __init__(self, lr_schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, grad_clip_norm=None, grad_clip_value=None):
        super().__init__(lr_schedule, grad_clip_norm, grad_clip_value)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def _init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params], "nu": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, lr):
        mu, nu = state["mu"], state["nu"]
        t = state["count"] + 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1 = float(np.float32(1) - b1 ** np.int32(t))
        bc2 = float(np.float32(1) - b2 ** np.int32(t))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)


class Lion(Optimizer):
    """optax ``lion`` (default b2 0.99, weight decay 0)."""

    def __init__(self, lr_schedule, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0,
                 grad_clip_norm=None, grad_clip_value=None):
        super().__init__(lr_schedule, grad_clip_norm, grad_clip_value)
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def _init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, lr):
        mu = state["mu"]
        u = torch._foreach_mul(grads, 1.0 - self.b1)
        torch._foreach_add_(u, mu, alpha=self.b1)
        torch._foreach_sign_(u)
        if self.weight_decay:
            torch._foreach_add_(u, params, alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b2)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b2)
        torch._foreach_add_(params, u, alpha=-lr)


class SGD(Optimizer):
    """optax ``sgd`` with ``momentum`` (a trace; 0 is plain SGD)."""

    def __init__(self, lr_schedule, momentum: float = 0.0, grad_clip_norm=None, grad_clip_value=None):
        super().__init__(lr_schedule, grad_clip_norm, grad_clip_value)
        self.momentum = momentum

    def _init(self, params):
        return {"trace": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, lr):
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-lr)


def _bias(use: bool, b1: float, b2: float, k: int) -> float:
    """√(1 − b2^(k+1)) / (1 − b1^(k+1)) when ``use``, else 1."""
    return math.sqrt(1.0 - b2 ** (k + 1)) / (1.0 - b1 ** (k + 1)) if use else 1.0


class Prodigy(Optimizer):
    """The JAX package's ``prodigy`` (Mishchenko & Defazio 2023, Adam
    variant). Per step k with pre-update estimate d and dlr = d·lr(k)·bias:
    ``r ← β3·r + (d/d0)·dlr·⟨g, x₀ − x⟩``, ``s ← β3·s + (d/d0)·dlr·g`` (weight
    d under ``safeguard_warmup``), ``d̂ = d_coef·r/‖s‖₁``, next
    ``d = min(max(d_max, d̂), d·growth_rate)``; ``m ← β1·m + d(1−β1)·g``,
    ``v ← β2·v + d²(1−β2)·g²``, ``Δx = −dlr·m/(√v + d·eps) − wd·dlr·x``."""

    def __init__(self, lr_schedule, betas=(0.9, 0.999), beta3: Optional[float] = None, eps: float = 1e-8,
                 weight_decay: float = 0.0, d0: float = 1e-6, d_coef: float = 1.0,
                 growth_rate: float = float("inf"), safeguard_warmup: bool = False,
                 use_bias_correction: bool = False, grad_clip_norm=None, grad_clip_value=None):
        super().__init__(lr_schedule, grad_clip_norm, grad_clip_value)
        self.b1, self.b2 = betas
        self.b3 = beta3 if beta3 is not None else self.b2**0.5
        self.eps, self.weight_decay, self.d0, self.d_coef = eps, weight_decay, d0, d_coef
        self.growth_rate, self.safeguard_warmup = growth_rate, safeguard_warmup
        self.use_bias_correction = use_bias_correction

    def _init(self, params):
        dev = params[0].device
        scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        return {"d": scalar(self.d0), "d_max": scalar(self.d0), "d_numerator": scalar(0.0),
                "exp_avg": [torch.zeros_like(p) for p in params],
                "exp_avg_sq": [torch.zeros_like(p) for p in params],
                "s": [torch.zeros_like(p) for p in params], "p0": [p.detach().clone() for p in params]}

    def _update(self, params, grads, state, lr):
        d, d0 = state["d"], self.d0
        dlr = d * (lr * _bias(self.use_bias_correction, self.b1, self.b2, state["count"]))
        dot = _sum_dots(grads, torch._foreach_sub(state["p0"], params))
        numerator = self.b3 * state["d_numerator"] + (d / d0) * dlr * dot
        s = state["s"]
        torch._foreach_mul_(s, self.b3)
        torch._foreach_add_(s, torch._foreach_mul(grads, (d / d0) * (d if self.safeguard_warmup else dlr)))
        denom_sum = _l1(s)
        d_hat = torch.where(denom_sum > 0, self.d_coef * numerator / denom_sum, d)
        d_max = torch.maximum(state["d_max"], d_hat)
        d_next = torch.where(denom_sum > 0, torch.minimum(d_max, d * self.growth_rate), d)
        m, v = state["exp_avg"], state["exp_avg_sq"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, d * (1 - self.b1)))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), d * d * (1 - self.b2)))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, d * self.eps)
        update = torch._foreach_mul(m, -dlr)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(params, -self.weight_decay * dlr))
        torch._foreach_add_(params, update)
        state.update(d=d_next, d_max=d_max, d_numerator=numerator)


class DAdaptAdam(Optimizer):
    """The JAX package's ``dadapt_adam`` (Defazio & Mishchenko 2023). Per
    step k with pre-update d and dlr = d·lr(k)·bias (coupled weight decay
    adds wd·x to g first): ``r ← √β2·r + (1−√β2)·dlr·⟨g, s/(√v + d·eps)⟩``
    (old v, s), ``m ← β1·m + (1−β1)·dlr·g``, ``v ← β2·v + (1−β2)·g²``,
    ``s ← √β2·s + (1−√β2)·dlr·g``, ``d' = max(d, min(r/((1−√β2)‖s‖₁),
    d·growth_rate))``, ``Δx = −m/(√v + d'·eps) − [decouple] wd·dlr·x``."""

    def __init__(self, lr_schedule, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 d0: float = 1e-6, growth_rate: float = float("inf"), use_bias_correction: bool = False,
                 decouple: bool = False, grad_clip_norm=None, grad_clip_value=None):
        super().__init__(lr_schedule, grad_clip_norm, grad_clip_value)
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.d0, self.growth_rate = eps, weight_decay, d0, growth_rate
        self.use_bias_correction, self.decouple = use_bias_correction, decouple

    def _init(self, params):
        dev = params[0].device
        return {"d": torch.tensor(self.d0, dtype=torch.float32, device=dev),
                "numerator_weighted": torch.tensor(0.0, dtype=torch.float32, device=dev),
                "exp_avg": [torch.zeros_like(p) for p in params],
                "exp_avg_sq": [torch.zeros_like(p) for p in params], "s": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, lr):
        sqrt_b2 = self.b2**0.5
        d = state["d"]
        dlr = d * (lr * _bias(self.use_bias_correction, self.b1, self.b2, state["count"]))
        if self.weight_decay and not self.decouple:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        m, v, s = state["exp_avg"], state["exp_avg_sq"], state["s"]
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, d * self.eps)
        numerator = sqrt_b2 * state["numerator_weighted"] + (1 - sqrt_b2) * dlr * _sum_dots(
            grads, torch._foreach_div(s, denom))
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, (1 - self.b1) * dlr))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - self.b2)
        torch._foreach_mul_(s, sqrt_b2)
        torch._foreach_add_(s, torch._foreach_mul(grads, (1 - sqrt_b2) * dlr))
        sk_l1 = _l1(s)
        d_hat = torch.where(sk_l1 > 0, numerator / ((1 - sqrt_b2) * sk_l1), d)
        d_next = torch.where(sk_l1 > 0, torch.maximum(d, torch.minimum(d_hat, d * self.growth_rate)), d)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, d_next * self.eps)
        update = torch._foreach_div(m, denom)
        if self.weight_decay and self.decouple:
            torch._foreach_add_(update, torch._foreach_mul(params, self.weight_decay * dlr))
        torch._foreach_sub_(params, update)
        state.update(d=d_next, numerator_weighted=numerator)


class DAdaptLion(Optimizer):
    """The JAX package's ``dadapt_lion``: ``u = sign(β1·m + (1−β1)·g)``,
    ``Δx = −dlr·u − wd·dlr·x``, ``m ← β2·m + (1−β2)·dlr·g``,
    ``r ← β2·r + (1−β2)·dlr·⟨u, s⟩`` (old s), ``s ← β2·s + (1−β2)·dlr·u``,
    ``d' = max(d, min(r/((1−β2)‖s‖₁), d·growth_rate))``."""

    def __init__(self, lr_schedule, betas=(0.9, 0.99), weight_decay: float = 0.0, d0: float = 1e-6,
                 growth_rate: float = float("inf"), grad_clip_norm=None, grad_clip_value=None):
        super().__init__(lr_schedule, grad_clip_norm, grad_clip_value)
        self.b1, self.b2 = betas
        self.weight_decay, self.d0, self.growth_rate = weight_decay, d0, growth_rate

    def _init(self, params):
        dev = params[0].device
        return {"d": torch.tensor(self.d0, dtype=torch.float32, device=dev),
                "numerator_weighted": torch.tensor(0.0, dtype=torch.float32, device=dev),
                "exp_avg": [torch.zeros_like(p) for p in params], "s": [torch.zeros_like(p) for p in params]}

    def _update(self, params, grads, state, lr):
        b1, b2 = self.b1, self.b2
        d = state["d"]
        dlr = d * lr
        m, s = state["exp_avg"], state["s"]
        u = torch._foreach_mul(m, b1)
        torch._foreach_add_(u, grads, alpha=1 - b1)
        torch._foreach_sign_(u)
        numerator = b2 * state["numerator_weighted"] + (1 - b2) * dlr * _sum_dots(u, s)
        torch._foreach_mul_(m, b2)
        torch._foreach_add_(m, torch._foreach_mul(grads, (1 - b2) * dlr))
        torch._foreach_mul_(s, b2)
        torch._foreach_add_(s, torch._foreach_mul(u, (1 - b2) * dlr))
        sk_l1 = _l1(s)
        d_hat = torch.where(sk_l1 > 0, numerator / ((1 - b2) * sk_l1), d)
        d_next = torch.where(sk_l1 > 0, torch.maximum(d, torch.minimum(d_hat, d * self.growth_rate)), d)
        update = torch._foreach_mul(u, -dlr)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(params, -self.weight_decay * dlr))
        torch._foreach_add_(params, update)
        state.update(d=d_next, numerator_weighted=numerator)


def get_optimizer(
    name: str,
    lr_schedule: Callable[[int], float],
    optimizer_args: str = "",
    *,
    weight_decay: Optional[float] = None,
    grad_clip_norm: Optional[float] = None,
    grad_clip_value: Optional[float] = None,
) -> Optimizer:
    """The JAX package's ``get_optimizer``: the same names (``adamw8bit``,
    ``adam8bit`` and ``lion8bit`` are their full-precision versions), the
    same ``optimizer_args`` and defaults, the same refusals."""
    name = name.lower()
    kwargs = parse_optimizer_args(optimizer_args)
    if weight_decay is not None:
        kwargs.setdefault("weight_decay", weight_decay)
    betas = kwargs.get("betas")
    if not isinstance(betas, (tuple, list)):
        betas = None
    b1 = float(kwargs.get("beta1", betas[0] if betas else 0.9))
    b2 = float(kwargs.get("beta2", betas[1] if betas and len(betas) > 1 else 0.999))
    b2_lion = float(kwargs.get("beta2", betas[1] if betas and len(betas) > 1 else 0.99))
    clip = dict(grad_clip_norm=grad_clip_norm, grad_clip_value=grad_clip_value)
    eps = float(kwargs.get("eps", 1e-8))
    wd = float(kwargs.get("weight_decay", 0.0))
    d_args = dict(d0=float(kwargs.get("d0", 1e-6)), growth_rate=float(kwargs.get("growth_rate", float("inf"))))
    if name in ("adamw", "adamw8bit"):
        return AdamW(lr_schedule, b1=b1, b2=b2, eps=eps, weight_decay=float(kwargs.get("weight_decay", 1e-2)), **clip)
    if name in ("adam", "adam8bit"):
        return AdamW(lr_schedule, b1=b1, b2=b2, eps=eps, weight_decay=0.0, **clip)
    if name in ("lion", "lion8bit"):
        return Lion(lr_schedule, b1=b1, b2=b2_lion, weight_decay=wd, **clip)
    if name == "sgd":
        return SGD(lr_schedule, momentum=float(kwargs.get("momentum", 0.0)), **clip)
    if name == "prodigy":
        return Prodigy(lr_schedule, betas=(b1, b2), beta3=float(kwargs["beta3"]) if "beta3" in kwargs else None,
                       eps=eps, weight_decay=wd, d_coef=float(kwargs.get("d_coef", 1.0)),
                       safeguard_warmup=bool(kwargs.get("safeguard_warmup", False)),
                       use_bias_correction=bool(kwargs.get("use_bias_correction", False)), **d_args, **clip)
    if name == "dadaptadam":
        return DAdaptAdam(lr_schedule, betas=(b1, b2), eps=eps, weight_decay=wd,
                          use_bias_correction=bool(kwargs.get("use_bias_correction", False)),
                          decouple=bool(kwargs.get("decouple", False)), **d_args, **clip)
    if name == "dadaptlion":
        return DAdaptLion(lr_schedule, betas=(b1, b2_lion), weight_decay=wd, **d_args, **clip)
    if name.startswith("dadapt"):
        raise ValueError("DAdapt optimizer must be dadaptadam or dadaptlion")
    raise ValueError("Optimizer must be adam, adamw, lion, sgd, prodigy or dadapt*")


class MultiSteps:
    """optax ``MultiSteps(inner, every_k_schedule=k)`` (the mean of the
    gradients, optax's default): each call adds a micro-step's gradients to
    a running mean, ``acc ← acc + (g − acc)/(n + 1)`` in fp32 as optax
    accumulates them; on every k-th call the inner optimizer — its clips,
    its update and its schedule, counted in optimizer steps — runs on that
    mean, and the mean restarts at zero. The state holds the mini-step, the
    optimizer-step count, the inner state and the running mean, so a resume
    mid-accumulation continues bit for bit. ``step`` returns whether the
    inner optimizer ran."""

    def __init__(self, inner: Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k = inner, every_k

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc_grads": [torch.zeros_like(p) for p in params]}

    global_norm = staticmethod(Optimizer.global_norm)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
             g_norm: Optional[torch.Tensor] = None) -> bool:
        acc, n = state["acc_grads"], state["mini_step"]
        torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(list(grads), acc), float(n + 1)))
        if n < self.every_k - 1:
            state["mini_step"] = n + 1
            return False
        self.inner.step(params, acc, state["inner"])
        for a in acc:
            a.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return True


def flat_params(sites, lora_params) -> List[torch.Tensor]:
    """Every trained leaf in a fixed order: (down, up) of each site in site
    order, then its ``dora_scale`` where it has one (DoRA: the JAX trainer
    trains every leaf of the adapter, so the magnitude is in the clip's
    global norm and in the optimizer)."""
    return [leaf[k] for s in sites for leaf in (lora_params[s.lora_name],)
            for k in ("down", "up", "dora_scale") if k in leaf]
