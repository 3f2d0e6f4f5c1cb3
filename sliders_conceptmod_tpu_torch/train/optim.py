"""Optimizer and learning-rate schedules — counterpart of
``sliders_conceptmod_tpu/train/optim.py`` for AdamW.

:class:`AdamW` computes what ``optax.chain(clip_by_global_norm(c),
adamw(lr, b1, b2, eps, weight_decay))`` computes, in place on a list of fp32
tensors:

* clip: ``g ← g`` when ``‖g‖ < c``, else ``g / ‖g‖ · c`` (optax's rule,
  i.e. ``c / max(‖g‖, c)``; not torch's ``c / (‖g‖ + 1e-6)``);
* moments ``μ ← (1 − b1)·g + b1·μ``, ``ν ← (1 − b2)·g² + b2·ν``;
* bias correction with the fp32 powers ``b1^t``, ``b2^t`` (t counted from 1);
* update ``μ̂ / (√ν̂ + eps) + wd·p`` (eps after the root, decoupled weight
  decay, default 1e-2), scaled by ``−lr(count)`` with the schedule's count
  starting at 0.

The step count is a host integer, so nothing in an update reads the device.
Other optimizers (Lion, SGD, Prodigy, DAdapt) are not ported yet.
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
    """``count → lr`` (a host float) for the ``constant`` and ``cosine``
    schedules; the others are not ported yet."""
    name = (name or "constant").lower()
    if name == "constant":
        return lambda step: float(np.float32(lr))
    if name == "cosine":
        t_max = max(max_iterations, 1)

        def sched(step: int) -> float:
            return float(np.float32(lr_min + 0.5 * (lr - lr_min) * (1 + math.cos(math.pi * step / t_max))))

        return sched
    if name in ("cosine_with_restarts", "step", "linear", "constant_with_warmup"):
        raise NotImplementedError(f"lr_scheduler {name!r} is not ported yet (ROADMAP queue 1, train/optim.py)")
    raise ValueError("Scheduler must be cosine, cosine_with_restarts, step, linear or constant")


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over a list of fp32
    parameters, updated in place (the port keeps one copy of the factors)."""

    def __init__(
        self,
        lr_schedule: Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-2,
        grad_clip_norm: Optional[float] = None,
    ):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        }

    @staticmethod
    def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt(Σ g²) over every gradient (a device scalar)."""
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
             g_norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` and ``state`` in place, with multi-tensor
        (``torch._foreach_*``) ops: a LoRA over SDXL has ~1100 factor
        tensors. ``g_norm`` is the gradients' global norm if the caller has
        it already."""
        params, grads, mu, nu = list(params), list(grads), state["mu"], state["nu"]
        if self.grad_clip_norm is not None:
            c = self.grad_clip_norm
            g_norm = self.global_norm(grads) if g_norm is None else g_norm
            # optax: g when ‖g‖ < c, else g / ‖g‖ · c
            factor = torch.where(g_norm < c, torch.ones_like(g_norm), c / g_norm)
            grads = torch._foreach_mul(grads, factor)
        t = state["count"] + 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1 = float(np.float32(1) - b1 ** np.int32(t))
        bc2 = float(np.float32(1) - b2 ** np.int32(t))
        lr = self.lr_schedule(state["count"])
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
        state["count"] = t


def get_optimizer(
    name: str,
    lr_schedule: Callable[[int], float],
    optimizer_args: str = "",
    *,
    weight_decay: Optional[float] = None,
    grad_clip_norm: Optional[float] = None,
) -> AdamW:
    """The JAX package's ``get_optimizer`` for ``adamw`` / ``adam``; the other
    optimizers raise ``NotImplementedError``."""
    name = name.lower()
    kwargs = parse_optimizer_args(optimizer_args)
    if weight_decay is not None:
        kwargs.setdefault("weight_decay", weight_decay)
    betas = kwargs.get("betas")
    if not isinstance(betas, (tuple, list)):
        betas = None
    b1 = float(kwargs.get("beta1", betas[0] if betas else 0.9))
    b2 = float(kwargs.get("beta2", betas[1] if betas and len(betas) > 1 else 0.999))
    eps = float(kwargs.get("eps", 1e-8))
    if name in ("adamw", "adamw8bit"):
        wd = float(kwargs.get("weight_decay", 1e-2))
    elif name in ("adam", "adam8bit"):
        wd = 0.0
    elif name in ("lion", "lion8bit", "sgd", "prodigy", "dadaptadam", "dadaptlion"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP queue 1, train/optim.py)")
    else:
        raise ValueError("Optimizer must be adam, adamw, lion, sgd, prodigy or dadapt*")
    return AdamW(lr_schedule, b1=b1, b2=b2, eps=eps, weight_decay=wd, grad_clip_norm=grad_clip_norm)


def flat_params(sites, lora_params) -> List[torch.Tensor]:
    """Every trained leaf in a fixed order: (down, up) of each site in site
    order, then its ``dora_scale`` where it has one (DoRA: the JAX trainer
    trains every leaf of the adapter, so the magnitude is in the clip's
    global norm and in AdamW)."""
    return [leaf[k] for s in sites for leaf in (lora_params[s.lora_name],)
            for k in ("down", "up", "dora_scale") if k in leaf]
