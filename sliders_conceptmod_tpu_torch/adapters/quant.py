"""Int8 frozen base — counterpart of ``sliders_conceptmod_tpu/adapters/quant.py``.

The frozen UNet's large Linear weights are stored as symmetric per-output
channel int8 and dequantized at the point of use; LoRA factors, optimizer
state and activations stay in the training dtype. The rules are the JAX
package's:

* a Linear is quantized when its weight has at least :data:`QUANT_MIN_ELEMS`
  elements; convolutions, norms and small Linears stay full precision;
* ``w ≈ q · scale`` with ``scale[o] = max(max_i |w[o, i]| / 127, 1e-12)`` and
  ``q = clip(round(w / scale), ±127)``, computed in fp32 (``torch.round`` is
  half-to-even, as ``jnp.round`` is), so the codes of one weight are the JAX
  package's bit for bit;
* weight-only (the default): ``(x @ q) · scale + bias`` in the compute dtype,
  rescaled and biased in fp32 — JAX's ``quant_overlay`` interceptor op for op;
* W8A8 (``act_quant``): the activation is also quantized per token (its own
  amax over the last axis), the product runs int8 × int8 → int32
  (``torch._int_mm``) and is rescaled by both scales. Rounding has no
  gradient: W8A8 is for the gradient-free paths (serving, the sweep, the
  trainers' warm-up).

:class:`QuantLinear` takes the place of an ``nn.Linear`` at the same module
path, so LoRA sites (``adapters/lora.py::create_sites``) and the overlay's
hooks find it as they find the Linear; a merge into it raises. Its backward
reaches the input only (the base is frozen), and it keeps the int8 codes,
not a dequantized copy, for that backward.

On CUDA ``torch._int_mm`` needs more than 16 rows and an inner and outer
size that are multiples of 8: :func:`int8_matmul` pads the rows with zero
rows (which it drops again) and lets a shape it cannot run raise.
"""

from __future__ import annotations

import copy
import itertools
from typing import Collection, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# weights below this element count stay full precision (the JAX rule)
QUANT_MIN_ELEMS = 65536
# torch._int_mm on CUDA demands more rows than 16
INT_MM_MIN_ROWS = 17

ScaleDict = Dict[Tuple[str, ...], torch.Tensor]


def _over_127(a: torch.Tensor) -> torch.Tensor:
    """``a / 127`` correctly rounded on every device: CUDA computes a division
    by a Python scalar as a product with its reciprocal, which is off by one
    ulp at some values (and then moves codes)."""
    return a / torch.full((), 127.0, device=a.device)


def quantize_leaf(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q [out, in] int8, scale [out] fp32)`` of a torch-layout ``[out, in]``
    weight: the amax over ``in`` in fp32."""
    w32 = w.float()
    scale = torch.clamp(_over_127(w32.abs().amax(dim=1)), min=1e-12)
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q · scale`` in ``dtype`` (an ``[out, in]`` weight)."""
    return (q.float() * scale[:, None]).to(dtype)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 over the last axis: ``(xq int8, sx [..., 1] fp32)`` with
    ``x ≈ xq · sx``."""
    x32 = x.float()
    sx = torch.clamp(_over_127(x32.abs().amax(dim=-1, keepdim=True)), min=1e-12)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [..., in] int8 × wq [out, in] int8 → [..., out] int32``, exact.
    The weight is read in place as the column-major ``[in, out]`` operand
    ``torch._int_mm`` takes; on CUDA fewer than 17 rows are padded with
    zero rows for the call."""
    a = xq.reshape(-1, xq.shape[-1])
    m = a.shape[0]
    if a.is_cuda and m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
    out = torch._int_mm(a.contiguous(), wq.t())
    return out[:m].reshape(*xq.shape[:-1], wq.shape[0])


class _DequantMatmul(torch.autograd.Function):
    """``x @ q.to(x.dtype).T`` whose backward rebuilds the dequantized weight
    from the int8 codes instead of keeping a full-precision copy alive."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.save_for_backward(q)
        return F.linear(x, q.to(x.dtype))

    @staticmethod
    def backward(ctx, grad):
        (q,) = ctx.saved_tensors
        return grad.matmul(q.to(grad.dtype)), None


class QuantLinear(nn.Module):
    """An int8 frozen Linear: ``weight_q [out, in]`` int8 and ``scale [out]``
    fp32 buffers, the Linear's bias, and the compute dtype the output is
    returned in. ``act_quant`` switches W8A8 on."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32, act_quant: bool = False, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.act_quant = act_quant
        self.register_buffer("weight_q", torch.zeros((out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=compute_dtype, device=device), requires_grad=False)
                     if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear, act_quant: bool = False) -> "QuantLinear":
        """The Linear's weight quantized, computing in its dtype; its bias is
        the very Parameter (shared)."""
        mod = cls(lin.in_features, lin.out_features, bias=False, compute_dtype=lin.weight.dtype,
                  act_quant=act_quant, device="meta")
        mod.weight_q, mod.scale = quantize_leaf(lin.weight.detach())
        mod.bias = lin.bias
        return mod

    @torch.no_grad()
    def set_weight(self, w: torch.Tensor) -> None:
        """Quantize a full-precision ``[out, in]`` weight into the buffers
        (from fp32: the source precision)."""
        q, scale = quantize_leaf(w.to(self.weight_q.device))
        self.weight_q.copy_(q)
        self.scale.copy_(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if self.act_quant:
            xq, sx = quantize_activations(x)
            y = int8_matmul(xq, self.weight_q).float() * sx * self.scale
        else:
            y = _DequantMatmul.apply(x.to(cd), self.weight_q).float() * self.scale
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(cd)


def quantize_module(module: nn.Module, min_elems: Optional[int] = None,
                    paths: Optional[Collection[Tuple[str, ...]]] = None) -> ScaleDict:
    """Replace every ``nn.Linear`` whose weight has at least ``min_elems``
    elements (default :data:`QUANT_MIN_ELEMS`, read at call time) — or
    exactly the Linears at ``paths`` (JAX module paths, an artifact's set) —
    by a :class:`QuantLinear` in place (computing in the weight's dtype), and
    mark the module quantized. Returns ``{JAX module path: scale}``. On the
    ``meta`` device it builds the structure only."""
    from sliders_conceptmod_tpu_torch.adapters.lora import jax_path_fn

    min_elems = QUANT_MIN_ELEMS if min_elems is None else min_elems
    wanted = None if paths is None else set(paths)
    scales: ScaleDict = {}
    path_of = jax_path_fn(module)
    for name, mod in list(module.named_modules()):
        if not isinstance(mod, nn.Linear):
            continue
        path = path_of(name)
        if (path not in wanted) if wanted is not None else mod.weight.numel() < min_elems:
            continue
        q = QuantLinear.from_linear(mod)
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent), child, q)
        scales[path] = q.scale
    if wanted is not None and set(scales) != wanted:
        missing = sorted("/".join(p) for p in wanted - set(scales))
        raise KeyError(f"no Linear to quantize at {missing[:3]} ({len(missing)} paths)")
    module.quantized_base = True
    return scales


def is_quantized(module: nn.Module) -> bool:
    """Whether :func:`quantize_module` ran on ``module`` (the JAX bundle's
    ``quant_scales is not None``; a tiny model may hold no QuantLinear)."""
    return bool(getattr(module, "quantized_base", False))


def quant_scales(module: nn.Module) -> ScaleDict:
    """``{JAX module path: scale}`` of the module's QuantLinears."""
    from sliders_conceptmod_tpu_torch.adapters.lora import jax_path_fn

    path_of = jax_path_fn(module)
    return {path_of(n): m.scale for n, m in module.named_modules() if isinstance(m, QuantLinear)}


def set_act_quant(module: nn.Module, on: bool) -> nn.Module:
    """W8A8 on or off for every QuantLinear of ``module`` (the JAX bundle's
    ``act_quant``); on an unquantized module switching it on raises, as
    JAX's ``apply_fn`` does."""
    if on and not is_quantized(module):
        raise ValueError(
            "apply_fn(act_quant=True) requires a quantized base "
            "(quant_scales is None — load with quantize_base=True)"
        )
    for m in module.modules():
        if isinstance(m, QuantLinear):
            m.act_quant = bool(on)
    return module


def shared_copy(module: nn.Module) -> nn.Module:
    """A second module object over the very same parameters and buffers (no
    tensor is copied); its submodules, flags and hooks are its own."""
    memo = {id(t): t for t in itertools.chain(module.parameters(), module.buffers())}
    return copy.deepcopy(module, memo)


def quantized_copy(module: nn.Module, act_quant: bool = False, min_elems: Optional[int] = None) -> nn.Module:
    """The warm-up's own UNet for ``tpu.w8a8_warmup``: over an int8 base, the
    base's tensors with ``act_quant`` set; over a full-precision base, an
    int8 copy quantized from the weights as they are (already cast, as JAX's
    ``quantize_params(unet.params)``) that shares every other tensor — the
    convolutions, norms and biases — with the base."""
    out = shared_copy(module)
    if not is_quantized(out):
        quantize_module(out, min_elems=min_elems)
    return set_act_quant(out, act_quant)
