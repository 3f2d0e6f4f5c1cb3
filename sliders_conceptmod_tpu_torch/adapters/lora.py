"""LoRA slider adapters — counterpart of ``sliders_conceptmod_tpu/adapters/lora.py``.

Site selection reproduces the reference ``create_modules`` rules over the
port's module tree (class matching by parent/child names, train-method
filters, ``add_`` skip, conv rank clamp). Module paths are kept in the JAX
package's form — each index joined onto the name before it
(``down_blocks.0.attentions.1`` → ``down_blocks_0/attentions_1``) — so the
key schema ``lora_unet_<path>.lora_down.weight / .lora_up.weight / .alpha``
comes out byte-identical to the JAX package's and the reference's.

LoRA factors are held in the torch (= checkpoint) layout: ``down`` is
``[r, in]`` (Linear) or ``[r, in, kh, kw]`` (Conv), ``up`` is ``[out, r]`` or
``[out, r, 1, 1]``.

The per-row overlay (:class:`LoRAOverlay`) wraps each adapted ``nn.Linear``
(or the int8 ``QuantLinear`` of ``adapters/quant.py`` in its place) /
``nn.Conv2d`` with a forward hook for the duration of one model call: the
output becomes ``org(x) + row_scale·(α/r)·up(down(x))``, the rank-r path in
fp32 and added in the output dtype, with ``row_scale`` a ``[B]`` vector — so
one batched call carries rows at different slider scales against a single
weight stream. The hooks live on the shared model, so an overlay holds a lock
of that model for the whole block: overlays on one model from different
threads run one after the other and never see each other's hooks.

Cross-slider batches: :func:`stack_adapters` stacks compatible sliders into
``[S, ...]`` factors (ranks zero-padded, α/r folded into the up factors), and
an overlay over them is entered with a ``[B]`` ``adapter_idx`` as well: each
row gathers its own adapter's factors, a dense site is one batched product
over the rows and a conv site one grouped convolution.

Training runs through the same overlay: fp32 factors that require grad are
hooked in as they are, the hook's ops stay on autograd's graph, and a
backward after the block reaches the factors (the hooks are gone by then;
the graph holds what it needs). Serving calls it under ``inference_mode``.

The merged route (:func:`merge_lora_params`) returns the site weights with
the slider added, which :func:`merged_weights` puts in place of the model's
for the calls of a block: the sweeps and the trainers' merged warm-up take
them without a graph, the merged student with autograd through the merge.
"""

from __future__ import annotations

import re
import threading
import weakref
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

UNET_TARGET_REPLACE_MODULE_TRANSFORMER = ["Attention"]
UNET_TARGET_REPLACE_MODULE_CONV = [
    "ResnetBlock2D",
    "Downsample2D",
    "Upsample2D",
    "DownBlock2D",
    "UpBlock2D",
]
LORA_PREFIX_UNET = "lora_unet"
DEFAULT_TARGET_REPLACE = UNET_TARGET_REPLACE_MODULE_TRANSFORMER

_ATTENTION_CHILDREN = ("to_q", "to_k", "to_v", "to_out_0")
_RESNET_CHILDREN = ("conv1", "conv2", "time_emb_proj", "conv_shortcut")
_CLIP_ATTN_CHILDREN = ("q_proj", "k_proj", "v_proj", "out_proj")

_TRAILING_INT = re.compile(r"^(.*)_(\d+)$")

LoRAParams = Dict[str, Dict[str, torch.Tensor]]


def module_path(name: str) -> Tuple[str, ...]:
    """torch dotted module name → the JAX tree's path segments: every purely
    numeric segment joins the one before it with ``_``."""
    segs: List[str] = []
    for seg in name.split(".") if name else ():
        if seg.isdigit() and segs:
            segs[-1] = f"{segs[-1]}_{seg}"
        else:
            segs.append(seg)
    return tuple(segs)


def jax_path_fn(model: nn.Module) -> Callable[[str], Tuple[str, ...]]:
    """The model's rule from a module name (relative to ``model``) to its
    JAX-tree path: the model's own ``jax_path`` where its JAX tree names
    modules otherwise (Flux flattens some, T5 has no ``encoder`` level),
    else :func:`module_path`."""
    return getattr(model, "jax_path", module_path)


def _dotted(segments: Sequence[str]) -> str:
    """path segments → diffusers dotted name (``to_out_0`` → ``to_out.0``)."""
    out = []
    for seg in segments:
        m = _TRAILING_INT.match(seg)
        if m:
            seg = m.group(1) + "." + m.group(2)
        out.append(seg)
    return ".".join(out)


@dataclass(frozen=True)
class LoRASite:
    """One adapted Linear/Conv."""

    module_path: Tuple[str, ...]  # JAX-tree path of the adapted module
    lora_name: str  # reference key, e.g. lora_unet_down_blocks_0_..._to_q
    kind: str  # "dense" | "conv"
    rank: int
    alpha: float
    in_dim: int
    out_dim: int
    kernel_size: Tuple[int, int] = (1, 1)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _classify_module(path: Tuple[str, ...]) -> Optional[Tuple[str, str, str]]:
    """(target_class, parent_dotted_name, child_name) for a Linear/Conv child
    of a targetable diffusers class, else None."""
    if len(path) < 2:
        return None
    child, parent_seg = path[-1], path[-2]
    if parent_seg in ("attn1", "attn2", "attn", "attention") and child in _ATTENTION_CHILDREN:
        return "Attention", _dotted(path[:-1]), _dotted((child,))
    if parent_seg.startswith("resnets_") and child in _RESNET_CHILDREN:
        return "ResnetBlock2D", _dotted(path[:-1]), _dotted((child,))
    if parent_seg.startswith("downsamplers_") and child == "conv":
        return "Downsample2D", _dotted(path[:-1]), child
    if parent_seg.startswith("upsamplers_") and child == "conv":
        return "Upsample2D", _dotted(path[:-1]), child
    if parent_seg == "self_attn" and child in _CLIP_ATTN_CHILDREN:
        return "CLIPAttention", _dotted(path[:-1]), child
    if parent_seg == "SelfAttention" and child in ("q", "k", "v", "o"):
        return "T5Attention", _dotted(path[:-1]), child
    return None


def _passes_train_method(train_method: str, parent_name: str, child_name: str) -> bool:
    """Reference create_modules filters."""
    if train_method in ("noxattn", "noxattn-hspace", "noxattn-hspace-last"):
        if "attn2" in parent_name or "time_embed" in parent_name:
            return False
    elif train_method == "innoxattn":
        if "attn2" in parent_name:
            return False
    elif train_method == "selfattn":
        if "attn1" not in parent_name:
            return False
    elif train_method in ("xattn", "xattn-strict"):
        if "attn2" not in parent_name:
            return False
    elif train_method == "t5attn":
        if "SelfAttention" not in parent_name:
            return False
    elif train_method == "full":
        pass
    else:
        raise NotImplementedError(f"train_method: {train_method} is not implemented.")
    if "add_" in child_name:
        return False
    if train_method == "xattn-strict" and "out" in child_name:
        return False
    if train_method == "noxattn-hspace" and "mid_block" not in parent_name:
        return False
    if train_method == "noxattn-hspace-last":
        if "mid_block" not in parent_name or ".1" not in parent_name or "conv2" not in child_name:
            return False
    return True


def create_sites(
    model: nn.Module,
    rank: int = 4,
    alpha: float = 1.0,
    target_replace: Sequence[str] = DEFAULT_TARGET_REPLACE,
    prefix: str = LORA_PREFIX_UNET,
    train_method: str = "full",
    name_path_prefix: Sequence[str] = (),
    delimiter: str = "_",
) -> List[LoRASite]:
    """Walk the model's Linear/Conv2d modules — an int8 ``QuantLinear``
    (``adapters/quant.py``) counts as the Linear it replaced — in the JAX
    package's sorted path order, and emit LoRA sites."""
    from sliders_conceptmod_tpu_torch.adapters.quant import QuantLinear

    targets = set(target_replace)
    if "DownBlock2D" in targets or "UpBlock2D" in targets:
        targets.update(("ResnetBlock2D", "Downsample2D", "Upsample2D"))
    path_of = jax_path_fn(model)
    layers = sorted(
        (path_of(name), mod)
        for name, mod in model.named_modules()
        if isinstance(mod, (nn.Linear, QuantLinear, nn.Conv2d))
    )
    sites: List[LoRASite] = []
    seen = set()
    for path, mod in layers:
        info = _classify_module(path)
        if info is None:
            continue
        target_class, parent_name, child_name = info
        if target_class not in targets or not _passes_train_method(train_method, parent_name, child_name):
            continue
        lora_name = (prefix + "." + _dotted(tuple(name_path_prefix) + path)).replace(".", delimiter)
        if lora_name in seen:
            continue
        seen.add(lora_name)
        if not isinstance(mod, nn.Conv2d):
            sites.append(LoRASite(path, lora_name, "dense", rank, alpha, mod.in_features, mod.out_features))
        else:
            r = min(rank, mod.in_channels, mod.out_channels)  # reference conv rank clamp
            sites.append(
                LoRASite(path, lora_name, "conv", r, alpha, mod.in_channels, mod.out_channels, tuple(mod.kernel_size))
            )
    return sites


def _factor_shapes(site: LoRASite):
    if site.kind == "dense":
        return (site.rank, site.in_dim), (site.out_dim, site.rank)
    kh, kw = site.kernel_size
    return (site.rank, site.in_dim, kh, kw), (site.out_dim, site.rank, 1, 1)


def init_lora_params(
    sites: Sequence[LoRASite], generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32
) -> LoRAParams:
    """kaiming_uniform(a=1) down (bound sqrt(3/fan_in)), zeros up."""
    params = {}
    for site in sites:
        down_shape, up_shape = _factor_shapes(site)
        fan_in = int(np.prod(down_shape[1:]))
        bound = (3.0 / fan_in) ** 0.5
        down = torch.rand(down_shape, generator=generator, device=device, dtype=torch.float32) * (2 * bound) - bound
        params[site.lora_name] = {"down": down.to(dtype), "up": torch.zeros(up_shape, device=device, dtype=dtype)}
    return params


# ---------------------------------------------------------------------------
# per-row overlay
# ---------------------------------------------------------------------------


_MODEL_LOCKS: "weakref.WeakKeyDictionary[nn.Module, threading.RLock]" = weakref.WeakKeyDictionary()
_MODEL_LOCKS_GUARD = threading.Lock()


def model_lock(model: nn.Module) -> threading.RLock:
    """The one re-entrant lock of ``model``: held by an overlay block and by a
    merged-weight call, so the two never interleave on a shared model."""
    with _MODEL_LOCKS_GUARD:
        lock = _MODEL_LOCKS.get(model)
        if lock is None:
            lock = _MODEL_LOCKS[model] = threading.RLock()
        return lock


class LoRAOverlay:
    """Binds sites + factors to a model once; ``with overlay(row_scale):``
    adapts every site for the calls made inside the block, holding the
    model's lock (another thread's overlay on the same model waits).
    ``overlay(None)`` holds the lock and adapts nothing: the plain model,
    safe from other threads' hooks — the block the merged route's calls run
    in (it raises if a site module still carries a hook). Over stacked
    factors (:func:`stack_adapters`) the block is entered as
    ``overlay(row_scale, adapter_idx)``: row b runs adapter
    ``adapter_idx[b]``, with no α/r gain (it is in the stacked up factors)."""

    def __init__(self, model: nn.Module, sites: Sequence[LoRASite], lora_params: LoRAParams):
        self._lock = model_lock(model)
        path_of = jax_path_fn(model)
        by_path = {path_of(n): m for n, m in model.named_modules()}
        self._targets = []
        for site in sites:
            mod = by_path.get(site.module_path)
            if mod is None:
                raise KeyError(f"no module at {'/'.join(site.module_path)} for {site.lora_name}")
            leaf = lora_params[site.lora_name]
            self._targets.append((mod, site, _fp32_factor(leaf["down"]), _fp32_factor(leaf["up"])))

    @contextmanager
    def __call__(self, row_scale: Optional[torch.Tensor],
                 adapter_idx: Optional[torch.Tensor] = None) -> Iterator[None]:
        targets = self._targets if row_scale is not None else []
        handles = []
        with self._lock:
            if row_scale is None and any(mod._forward_hooks for mod, *_ in self._targets):
                # a merged-weights call under another overlay's hooks would add the slider twice
                raise RuntimeError("overlay(None) entered while a site module carries a forward hook")
            try:
                for mod, site, down, up in targets:
                    if adapter_idx is None:
                        hook = _make_hook(site, down, up, row_scale.float())
                    else:
                        hook = _make_indexed_hook(site, down, up, row_scale.float(), adapter_idx)
                    handles.append(mod.register_forward_hook(hook))
                yield
            finally:
                for h in handles:
                    h.remove()


def _fp32_factor(t: torch.Tensor) -> torch.Tensor:
    """The rank-r path runs in fp32. An fp32 factor is used as it is — the
    very tensor, so a trainable leaf receives its gradient; a lower-precision
    factor (serving) is upcast once. A trainable factor must be fp32: the
    upcast copy would cut its gradient."""
    if t.dtype == torch.float32:
        return t
    if t.requires_grad:
        raise ValueError(f"trainable LoRA factors must be float32, got {t.dtype}")
    return t.float()


def _make_hook(site: LoRASite, down: torch.Tensor, up: torch.Tensor, row_scale: torch.Tensor):
    gain = site.scale

    def hook(mod, args, out):
        x = args[0].float()
        if site.kind == "dense":
            lora_out = F.linear(F.linear(x, down), up)
        else:
            h = F.conv2d(x, down, stride=mod.stride, padding=mod.padding, dilation=mod.dilation)
            lora_out = F.conv2d(h, up)
        scale = row_scale.reshape((-1,) + (1,) * (out.ndim - 1))
        return out + (scale * gain * lora_out).to(out.dtype)

    return hook


def _make_indexed_hook(site: LoRASite, down: torch.Tensor, up: torch.Tensor, row_scale: torch.Tensor,
                       adapter_idx: torch.Tensor):
    """Row b through adapter ``adapter_idx[b]`` of the stacked ``[S, ...]``
    factors; the gain is already in the up factors."""
    dg, ug = down[adapter_idx], up[adapter_idx]  # [B, r, in(, kh, kw)], [B, out, r(, 1, 1)]
    rows = dg.shape[0]

    def hook(mod, args, out):
        x = args[0].float()
        if site.kind == "dense":
            lora_out = torch.einsum("b...r,bor->b...o", torch.einsum("b...i,bri->b...r", x, dg), ug)
        else:  # one grouped conv over the rows: group b is row b's down (then up) conv
            h = F.conv2d(x.reshape(1, -1, *x.shape[2:]), dg.flatten(0, 1), stride=mod.stride,
                         padding=mod.padding, dilation=mod.dilation, groups=rows)
            lora_out = F.conv2d(h, ug.flatten(0, 1), groups=rows).reshape(rows, -1, *h.shape[2:])
        scale = row_scale.reshape((-1,) + (1,) * (out.ndim - 1))
        return out + (scale * lora_out).to(out.dtype)

    return hook


# ---------------------------------------------------------------------------
# cross-slider stacks
# ---------------------------------------------------------------------------


def sites_stack_compatible(a: Sequence[LoRASite], b: Sequence[LoRASite]) -> bool:
    """Whether two adapters target the same modules with the same kind and
    dims, the condition for one stack (ranks and alphas may differ)."""
    return len(a) == len(b) and all(
        sa.module_path == sb.module_path and sa.kind == sb.kind and sa.in_dim == sb.in_dim
        and sa.out_dim == sb.out_dim and sa.kernel_size == sb.kernel_size
        for sa, sb in zip(a, b)
    )


def stack_adapters(entries: Sequence[Tuple[Sequence[LoRASite], LoRAParams]],
                   pad_to: int = 0) -> Tuple[List[LoRASite], LoRAParams]:
    """``(ref_sites, stacked)`` of compatible ``(sites, factors)`` entries:
    per site an fp32 ``down`` ``[S, r_max, in(, kh, kw)]`` and ``up``
    ``[S, out, r_max(, 1, 1)]``, each rank axis zero-padded to the largest
    rank (zero rank columns add nothing), each adapter's α/r multiplied into
    its up factor, and all-zero adapters appended up to ``pad_to``. The
    reference sites route modules only; their rank and alpha are not
    applied. Incompatible site sets raise."""
    if not entries:
        raise ValueError("stack_adapters needs at least one adapter")
    ref_sites = list(entries[0][0])
    for sites_i, _ in entries[1:]:
        if not sites_stack_compatible(ref_sites, sites_i):
            raise ValueError("adapters target different module sets/dims — serve them in separate groups "
                             "(sites_stack_compatible is the precondition)")
    n = max(len(entries), pad_to)
    stacked: LoRAParams = {}
    for j, ref in enumerate(ref_sites):
        r_max = max(int(e[0][j].rank) for e in entries)
        downs, ups = [], []
        for sites_i, params_i in entries:
            site = sites_i[j]
            leaf = params_i[site.lora_name]
            pad = r_max - int(site.rank)
            down = leaf["down"].detach().float()
            up = leaf["up"].detach().float() * site.scale  # fold α/r
            downs.append(F.pad(down, (0, 0) * (down.ndim - 1) + (0, pad)))  # rank: down's first axis
            ups.append(F.pad(up, (0, 0) * (up.ndim - 2) + (0, pad)))  # rank: up's second axis
        downs += [torch.zeros_like(downs[0])] * (n - len(downs))
        ups += [torch.zeros_like(ups[0])] * (n - len(ups))
        stacked[ref.lora_name] = {"down": torch.stack(downs), "up": torch.stack(ups)}
    return ref_sites, stacked


# ---------------------------------------------------------------------------
# merged weights
# ---------------------------------------------------------------------------


def compose_factors(site: LoRASite, leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    """up∘down in the base weight's layout: ``[out, in]`` for a Linear; for
    a conv the k×k down conv followed by the 1×1 up conv, composed into one
    ``[out, in, kh, kw]`` kernel."""
    down, up = leaf["down"], leaf["up"]
    if site.kind == "dense":
        return up @ down
    return torch.einsum("or,rihw->oihw", up[:, :, 0, 0], down)


def _delta_weight(site: LoRASite, leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(α/r)·(up∘down) in the base weight's layout."""
    return compose_factors(site, leaf) * site.scale


def _refuse_quantized(mod: nn.Module, path: Sequence[str]) -> None:
    """An int8 base cannot hold a merged delta: JAX's words."""
    from sliders_conceptmod_tpu_torch.adapters.quant import QuantLinear

    if isinstance(mod, QuantLinear):
        raise ValueError(
            f"cannot merge LoRA into integer (quantized) kernel at "
            f"{'/'.join(path)} — use the apply-time overlay "
            "(student_overlay / lora_overlay) over a quantized base"
        )


def site_weights(model: nn.Module, sites: Sequence[LoRASite]) -> Iterator[Tuple[LoRASite, str, torch.Tensor]]:
    """(site, parameter name, weight) of each site's module, in site order; a
    quantized site raises."""
    path_of = jax_path_fn(model)
    by_path = {path_of(n): n for n, _ in model.named_modules()}
    for site in sites:
        name = by_path.get(site.module_path)
        if name is None:
            raise KeyError(f"no module at {'/'.join(site.module_path)} for {site.lora_name}")
        _refuse_quantized(model.get_submodule(name), site.module_path)
        key = f"{name}.weight" if name else "weight"
        yield site, key, model.get_parameter(key)


def merge_site_weights(model: nn.Module, sites: Sequence[LoRASite], params: LoRAParams, multiplier: float,
                       delta_fn: Callable[[LoRASite, Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
                       grad: bool = False) -> Dict[str, torch.Tensor]:
    """``{parameter name: W + (m·delta_fn(site, leaf, W)).to(W.dtype)}`` for
    the site modules only — the merge every adapter shares (LoRA here, DoRA
    in ``adapters/dora.py``). ``grad`` keeps autograd's graph through the
    factors and the cast, whose gradient reaches the fp32 factors in fp32 (the
    merged student); without it no graph is built (sweeps, the warm-up). An
    integer (quantized) weight cannot hold a delta and raises."""
    from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib

    merged = {}
    with nullcontext() if grad else torch.no_grad():
        for site, key, weight in site_weights(model, sites):
            if not weight.dtype.is_floating_point:
                raise ValueError(f"cannot merge an adapter into integer (quantized) weight {key}: use the overlay")
            leaf = {k: t.to(weight.device) for k, t in params[site.lora_name].items()}
            # a tensor-sharded module (parallel/mesh.py::tp_shard_tree) merges its whole weight and keeps its rows
            mod = model.get_submodule(key.rpartition(".")[0])
            full = mesh_lib.tp_full_weight(mod, weight)
            out = full + (multiplier * delta_fn(site, leaf, full)).to(full.dtype)
            rows = mesh_lib.tp_rows(mod)
            merged[key] = out if rows is None else out[rows]
    return merged


def merge_lora_params(model: nn.Module, sites: Sequence[LoRASite], lora_params: LoRAParams,
                      multiplier: float, grad: bool = False) -> Dict[str, torch.Tensor]:
    """``{parameter name: W + (m·(α/r)·up∘down).to(W.dtype)}`` for the site
    modules only, the delta added in W's dtype as the JAX merge adds it. Run
    the model on it inside :func:`merged_weights` under the model's lock:
    the other parameters stay the model's own, and no weight of the model is
    written. ``grad``: see :func:`merge_site_weights`."""
    return merge_site_weights(model, sites, lora_params, multiplier,
                              lambda site, leaf, weight: _delta_weight(site, leaf), grad)


@contextmanager
def merged_weights(model: nn.Module, merged: Dict[str, torch.Tensor]) -> Iterator[None]:
    """``merged`` (parameter name → tensor) in place of those parameters for
    the calls inside the block: each module's ``_parameters`` entry is
    swapped, and the very Parameter it held is put back after. A tensor with
    a graph stays on it, so a backward reaches what it was made from. Hold
    the model's lock around the block (``model_lock``, or an overlay's
    ``overlay(None)``). It costs a dict write per tensor, where
    ``torch.func.functional_call`` re-parametrises the module on every call
    (``chip_smoke.py``'s merged_call_cost times both; PERF.md §6)."""
    slots = []
    for name, tensor in merged.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        _refuse_quantized(mod, jax_path_fn(model)(mod_name))
        slots.append((mod, leaf, tensor))
    originals = [mod._parameters[leaf] for mod, leaf, _ in slots]
    try:
        for mod, leaf, tensor in slots:
            mod._parameters[leaf] = tensor
        yield
    finally:
        for (mod, leaf, _), orig in zip(slots, originals):
            mod._parameters[leaf] = orig


# ---------------------------------------------------------------------------
# checkpoint I/O — exact reference key schema
# ---------------------------------------------------------------------------


def state_dict_numpy(sites: Sequence[LoRASite], lora_params: LoRAParams, dtype=np.float32) -> Dict[str, np.ndarray]:
    """Reference key/layout schema: ``<name>.lora_down.weight``,
    ``<name>.lora_up.weight``, ``<name>.alpha``, as numpy arrays."""
    return {k: v.numpy().astype(dtype) for k, v in state_dict_tensors(sites, lora_params).items()}


def state_dict_tensors(
    sites: Sequence[LoRASite], lora_params: LoRAParams, dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """The reference schema as CPU tensors in ``dtype`` (bfloat16 included,
    which numpy lacks)."""
    out = {}
    for site in sites:
        leaf = lora_params[site.lora_name]
        out[f"{site.lora_name}.lora_down.weight"] = leaf["down"].detach().to("cpu", dtype)
        out[f"{site.lora_name}.lora_up.weight"] = leaf["up"].detach().to("cpu", dtype)
        out[f"{site.lora_name}.alpha"] = torch.tensor(site.alpha, dtype=dtype)
    return out


def save_weights(path: str, sites: Sequence[LoRASite], lora_params: LoRAParams, dtype=torch.float32, metadata=None):
    """.safetensors (the port's own writer) or torch-pickle .pt, in ``dtype``."""
    write_state_dict(path, state_dict_tensors(sites, lora_params, dtype=dtype), metadata)


def write_state_dict(path: str, sd: Dict[str, torch.Tensor], metadata=None) -> None:
    if str(path).endswith(".safetensors"):
        from sliders_conceptmod_tpu_torch.io.safetensors import save_file

        save_file(sd, str(path), metadata)
    else:
        torch.save(sd, str(path))


def load_weights_from_tensors(sd, sites: Sequence[LoRASite], dtype=torch.float32, device=None) -> LoRAParams:
    """Reference-schema tensors (numpy or torch) → the overlay's factors."""
    def tensor(key):
        v = sd[key]
        return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))

    params = {}
    for site in sites:
        down = tensor(f"{site.lora_name}.lora_down.weight")
        up = tensor(f"{site.lora_name}.lora_up.weight")
        down_shape, up_shape = _factor_shapes(site)
        if tuple(down.shape) != down_shape or tuple(up.shape) != up_shape:
            raise ValueError(
                f"{site.lora_name}: factor shapes {tuple(down.shape)}/{tuple(up.shape)} "
                f"!= expected {down_shape}/{up_shape}"
            )
        params[site.lora_name] = {
            "down": down.to(device=device, dtype=dtype),
            "up": up.to(device=device, dtype=dtype),
        }
    return params


def load_weights(path: str, sites: Sequence[LoRASite], dtype=torch.float32, device=None) -> LoRAParams:
    from sliders_conceptmod_tpu_torch.adapters.slider_file import read_tensors

    return load_weights_from_tensors(read_tensors(path), sites, dtype=dtype, device=device)


def filter_sites_to_keys(keys, sites: Sequence[LoRASite]) -> List[LoRASite]:
    keys = set(keys)
    return [s for s in sites if f"{s.lora_name}.lora_down.weight" in keys]
