"""notrigger: text-encoder sliders trained in embedding space — counterpart
of ``sliders_conceptmod_tpu/train/notrigger.py`` (reference
``conceptmod/notrigger/train_notrigger.py``).

A LoRA/DoRA inside one CLIP tower makes the empty prompt drift toward a
positive concept at multiplier +1 and a negative concept at −1:

* the targets are ``hidden_states[-1]`` of the frozen tower for the
  positive, negative and neutral ("") prompts;
* +1 branch: encode "" through the tower with the adapter merged at +1
  (``merge_lora_params(..., grad=True)`` in place of the site weights,
  ``adapters/lora.py::merged_weights``); MSE toward the positive target when
  there is no negative, else :func:`fixed_distance_loss` with the step-0
  distance / ``SPLIT``, plus the cosine-map regularisers against the
  negative direction; the −1 branch mirrors it;
* with both signs the backward loss is the normalised-distance curriculum
  ``w_p·pperc + w_n·nperc + (1 − w_r)·similarity``;
* the attribute-stabilisation term, dormant as in the reference (the
  trainer passes no attributes).

The gradient flows through the merge to the fp32 factors (and DoRA's
``dora_scale``); the optimizer (SGD with ``constant_with_warmup`` and a
value clip, ``cli/train_notrigger.py``) updates them in place. No kernel
runs here: the tower's attention is plain PyTorch (``models/clip.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.train.optim import Optimizer, flat_params

CLIP_TARGET_REPLACE = ["CLIPAttention", "CLIPSdpaAttention"]
SPLIT = 20  # reference train_notrigger.py:278 ``split = 20``


def fixed_distance_loss(trainable: torch.Tensor, target: torch.Tensor, fixed_distance: torch.Tensor) -> torch.Tensor:
    """Move toward ``target`` by the clamped ``fixed_distance`` along the
    difference. The moved target is not detached (JAX's and the reference's
    gradients run through the direction and the clamp)."""
    diff = target - trainable
    current = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    direction = diff / (current + 1e-8)
    clamped = torch.minimum(torch.maximum(fixed_distance[..., None], -current), current)
    moved_target = trainable + direction * clamped
    return torch.mean((trainable - moved_target) ** 2)


def _cos_map(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's elementwise pseudo-cosine (``F.cosine_similarity``
    over a singleton dim): ``a·b / max(|a|·|b|, 1e-8)``."""
    return (a * b) / torch.clamp(torch.abs(a) * torch.abs(b), min=1e-8)


def _cos_terms(v1, v2, v1r) -> torch.Tensor:
    diff_term = torch.abs(torch.mean(_cos_map(v1, v2) - _cos_map(v1r, v2)))
    mean_term = torch.mean(_cos_map(v1, v2))
    return diff_term + mean_term


@dataclass(frozen=True)
class NoTriggerConfig:
    lambda_similarity: float = 0.1  # λp = λn (reference :279-280)
    has_positive: bool = True
    has_negative: bool = True
    # attribute stabilisation λs (reference :281-285; the reference hard-resets
    # its attributes, so the trainer leaves this at 0)
    lambda_stabilize: float = 0.0


def hidden_of(encoder: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """``ids → hidden_states[-1]`` of a CLIP tower (the final pre-LN state);
    a T5 tower's output itself (its final norm's, as JAX's ``t5attn``
    method encodes)."""
    from sliders_conceptmod_tpu_torch.models.t5 import T5EncoderModel

    if isinstance(encoder, T5EncoderModel):
        return encoder
    return lambda ids: encoder(ids).hidden_states[-1]


def _merged_encode(encoder, sites, lora_params, merge, multiplier: float, ids, grad: bool) -> torch.Tensor:
    """``hidden_states[-1]`` of ``ids`` through the tower with the adapter
    merged at ``multiplier`` (under the tower's lock)."""
    with lora_lib.model_lock(encoder):
        merged = merge(encoder, sites, lora_params, multiplier, grad=grad)
        with lora_lib.merged_weights(encoder, merged):
            return hidden_of(encoder)(ids)


def make_notrigger_step(
    encoder: nn.Module,
    sites,
    lora_params,
    optimizer: Optimizer,
    cfg: NoTriggerConfig,
    neutral_ids: torch.Tensor,  # tokenized ""
    pos_target: Optional[torch.Tensor],  # the frozen tower's hidden_states[-1]
    neg_target: Optional[torch.Tensor],
    neutral_target: torch.Tensor,
    distance1: Optional[torch.Tensor],
    distance2: Optional[torch.Tensor],
    merge_fn=None,
    attribute_ids: Optional[torch.Tensor] = None,  # [A, S] tokenized attributes
    attribute_targets: Optional[torch.Tensor] = None,  # [A, S, D] frozen embeddings
) -> Callable[[dict], dict]:
    """``step(opt_state) -> metrics`` (device scalars: ``loss``,
    ``similarity``, ``pdist``/``ndist``, with both signs ``w_p``/``w_n``/
    ``w_r``); ``lora_params`` and ``opt_state`` are updated in place."""
    merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
    lam = cfg.lambda_similarity
    both = cfg.has_positive and cfg.has_negative
    params = flat_params(sites, lora_params)

    def branch_embs(multiplier: float) -> torch.Tensor:
        return _merged_encode(encoder, sites, lora_params, merge, multiplier, neutral_ids, grad=True)

    def loss_fn():
        metrics = {}
        zero = torch.zeros((), device=neutral_target.device)
        ploss = nloss = similarity = pperc = nperc = zero
        if cfg.has_positive:
            tp = branch_embs(1.0)
            if not cfg.has_negative:
                ploss = torch.mean((pos_target - tp) ** 2)
            else:
                ploss = fixed_distance_loss(tp, pos_target, distance1)
                preg = _cos_terms(tp - neutral_target, neg_target - neutral_target, pos_target - neutral_target)
                preg = preg + 1.0 / (torch.mean((tp - neg_target) ** 2) + 1e-8)
                similarity = similarity + lam * preg
                pperc = torch.linalg.vector_norm(pos_target - tp) / (distance1 * SPLIT)
            metrics["pdist"] = torch.linalg.vector_norm(pos_target - tp)
        if cfg.has_negative:
            tn = branch_embs(-1.0)
            if not cfg.has_positive:
                nloss = torch.mean((neg_target - tn) ** 2)
            else:
                nloss = fixed_distance_loss(tn, neg_target, distance2)
                nreg = _cos_terms(tn - neutral_target, pos_target - neutral_target, neg_target - neutral_target)
                nreg = nreg + 1.0 / (torch.mean((tn - pos_target) ** 2) + 1e-8)
                similarity = similarity + lam * nreg
                nperc = torch.linalg.vector_norm(neg_target - tn) / (distance2 * SPLIT)
            metrics["ndist"] = torch.linalg.vector_norm(neg_target - tn)
        if attribute_ids is not None and cfg.lambda_stabilize > 0:
            # Σ‖enc_trainable(attr) − static‖₂ at multiplier +1 (reference :327-331)
            attr = _merged_encode(encoder, sites, lora_params, merge, 1.0, attribute_ids, grad=True)
            stab = torch.sqrt(torch.sum((attr - attribute_targets) ** 2))
            metrics["stabilize"] = stab
            similarity = similarity + cfg.lambda_stabilize * stab
        if both:
            # the normalised-distance curriculum (reference :420-439; its scale_factor cancels)
            denom = pperc + nperc + 1e-12
            w_p, w_n = pperc / denom, nperc / denom
            w_r = torch.clamp((pperc + nperc) / 2, max=0.95)
            loss = w_p * pperc + w_n * nperc
            total = loss + (1.0 - w_r) * similarity
            metrics.update(w_p=w_p, w_n=w_n, w_r=w_r)
        else:
            loss = total = ploss if cfg.has_positive else nloss
        metrics.update(loss=loss, similarity=similarity)
        return total, metrics

    def step(opt_state: dict) -> dict:
        with torch.enable_grad():
            total, metrics = loss_fn()
            grads = torch.autograd.grad(total, params)
        optimizer.step(params, grads, opt_state)
        return {k: v.detach() for k, v in metrics.items()}

    return step


@torch.no_grad()
def initial_distances(encoder: nn.Module, sites, lora_params, neutral_ids, pos_target, neg_target, merge_fn=None):
    """The step-0 anchor distances ``‖target − trainable‖ / SPLIT`` at +1 and
    −1 (reference :303-305, 343-345); None where the target is."""
    merge = merge_fn if merge_fn is not None else lora_lib.merge_lora_params
    d1 = d2 = None
    if pos_target is not None:
        tp = _merged_encode(encoder, sites, lora_params, merge, 1.0, neutral_ids, grad=False)
        d1 = torch.linalg.vector_norm(pos_target - tp) / SPLIT
    if neg_target is not None:
        tn = _merged_encode(encoder, sites, lora_params, merge, -1.0, neutral_ids, grad=False)
        d2 = torch.linalg.vector_norm(neg_target - tn) / SPLIT
    return d1, d2
