"""Weight bridge: a JAX (flax) parameter tree → a port module's state.

The tree is given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``); nothing here imports JAX. Each of the module's parameterised
layers is looked up at its JAX path (``module_path``: every index joined onto
the name before it), and its leaves convert by the layer type:

* Dense ``kernel [in, out]``          → ``Linear.weight [out, in]``
* Conv ``kernel [kh, kw, in, out]``   → ``Conv2d.weight [out, in, kh, kw]``
  (a depthwise conv's ``[kh, kw, 1, C]`` → ``[C, 1, kh, kw]``)
* ConvTranspose ``kernel [kh, kw, in, out]``, spatially flipped against
  torch's → ``ConvTranspose2d.weight [in, out, kh, kw]`` (the flip undone)
* ``gamma`` / ``beta`` (Stable Cascade's GlobalResponseNorm, ``(1, 1, 1, C)``
  on both sides) → copied through
* ``scale``                           → norm ``weight``
* ``embedding``                       → ``Embedding.weight``
* ``bias``                            → ``bias``

An int8 ``QuantLinear`` (``adapters/quant.py``) takes JAX's quantized leaves:
an int8 ``kernel [in, out]`` → ``weight_q [out, in]`` and ``kernel_scale`` →
``scale``; given a full-precision kernel it quantizes it (from fp32).
The same rules carry every model of the port, the SD3 MMDiT included (its
Dense layers, the patch conv, ``to_out_0``/``net_0``/``net_2`` as the
ModuleLists' ``to_out.0``/``net.0``/``net.2``, and its quantized leaves):
its module names are diffusers'. An RMS norm (``models/norms.py::RMSNorm``)
takes ``scale`` as a norm does. Where a JAX tree names modules otherwise,
the model says so through its ``jax_path`` (``adapters/lora.py::
jax_path_fn``): Flux's flat ``ff_net_0_proj`` / ``attn_to_q`` /
``norm_linear`` (``models/flux.py``), T5's tree without the ``encoder``
level (``models/t5.py``).
:func:`to_jax_tree` is the way back: a module's state in the JAX layout.
Leaves may be numpy arrays or torch tensors (bfloat16 included).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Set, Tuple

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.lora import jax_path_fn
from sliders_conceptmod_tpu_torch.adapters.quant import QuantLinear
from sliders_conceptmod_tpu_torch.models.norms import RMSNorm


def _leaf_paths(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterable[Tuple[str, ...]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _tensor(x, device) -> torch.Tensor:
    """A leaf as a tensor on ``device``: int8 and torch tensors as they are,
    any other array through fp32 (numpy has no bfloat16 of its own). It
    moves as it is stored, so a layout change after runs on the device."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    a = np.asarray(x)
    return torch.from_numpy(np.array(a, dtype=np.int8 if a.dtype == np.int8 else np.float32)).to(device)


def _convert(mod: nn.Module, pname: str, node: Mapping, device) -> Tuple[str, torch.Tensor]:
    """(JAX leaf name, tensor in the torch layout on ``device``) for one
    torch parameter."""
    if pname in ("bias", "gamma", "beta"):
        return pname, _tensor(node[pname], device)
    if isinstance(mod, nn.Linear):
        return "kernel", _tensor(node["kernel"], device).T
    if isinstance(mod, nn.Conv2d):
        return "kernel", _tensor(node["kernel"], device).permute(3, 2, 0, 1)
    if isinstance(mod, nn.ConvTranspose2d):
        return "kernel", _tensor(node["kernel"], device).flip(0, 1).permute(2, 3, 0, 1)
    if isinstance(mod, nn.Embedding):
        return "embedding", _tensor(node["embedding"], device)
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
        return "scale", _tensor(node["scale"], device)
    raise TypeError(f"no JAX layout rule for {type(mod).__name__}.{pname}")


def _state(mod: nn.Module):
    """(name, tensor) of a module's own state: its parameters, and a
    QuantLinear's int8 codes and scales."""
    own = list(mod.named_parameters(recurse=False))
    if isinstance(mod, QuantLinear):
        own = [("weight_q", mod.weight_q), ("scale", mod.scale)] + own
    return own


def _load_quant(mod: QuantLinear, node: Mapping, path: Tuple[str, ...]) -> List[Tuple[str, ...]]:
    """A QuantLinear from its JAX node; the leaf paths it took."""
    kernel = _tensor(node["kernel"], mod.weight_q.device).T
    if tuple(kernel.shape) != tuple(mod.weight_q.shape):
        raise ValueError(f"{'/'.join(path)}: JAX kernel gives {tuple(kernel.shape)}, "
                         f"module has {tuple(mod.weight_q.shape)}")
    if kernel.dtype != torch.int8:
        mod.set_weight(kernel)
        return [path + ("kernel",)]
    mod.weight_q.copy_(kernel)
    mod.scale.copy_(_tensor(node["kernel_scale"], mod.scale.device))
    return [path + ("kernel",), path + ("kernel_scale",)]


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping) -> List[Tuple[str, ...]]:
    """Copy the tree's leaves into ``module`` (cast to each parameter's dtype
    and device). Every parameter must find its leaf; returns the JAX leaf
    paths that no parameter took (e.g. the VAE encoder for a decoder-only
    module), sorted."""
    used: Set[Tuple[str, ...]] = set()
    path_of = jax_path_fn(module)
    for name, mod in module.named_modules():
        own = _state(mod)
        if not own:
            continue
        path = path_of(name)
        node = tree
        for seg in path:
            if seg not in node:
                raise KeyError(f"JAX tree has no {'/'.join(path)} (torch module {name!r})")
            node = node[seg]
        if isinstance(mod, QuantLinear):
            used.update(_load_quant(mod, node, path))
            own = [(n, p) for n, p in own if n == "bias"]
        for pname, p in own:
            leaf, t = _convert(mod, pname, node, p.device)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{pname}: JAX {leaf} gives {tuple(t.shape)}, module has {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
            used.add(path + (leaf,))
    return sorted(set(_leaf_paths(tree)) - used)


def _jax_leaves(mod: nn.Module):
    """(JAX leaf name, tensor in the JAX layout) of a module's own state."""
    for pname, t in _state(mod):
        if pname in ("bias", "gamma", "beta"):
            yield pname, t
        elif pname == "weight_q":
            yield "kernel", t.T
        elif pname == "scale" and isinstance(mod, QuantLinear):
            yield "kernel_scale", t
        elif isinstance(mod, nn.Linear):
            yield "kernel", t.T
        elif isinstance(mod, nn.Conv2d):
            yield "kernel", t.permute(2, 3, 1, 0)
        elif isinstance(mod, nn.ConvTranspose2d):
            yield "kernel", t.permute(2, 3, 0, 1).flip(0, 1)
        elif isinstance(mod, nn.Embedding):
            yield "embedding", t
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
            yield "scale", t
        else:
            raise TypeError(f"no JAX layout rule for {type(mod).__name__}.{pname}")


def jax_layout_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``{"a/b/kernel": shape}`` of the JAX tree this module's state maps to —
    works on a ``meta``-device module, so full-width structures cost no
    memory."""
    path_of = jax_path_fn(module)
    return {"/".join(path_of(name) + (leaf,)): tuple(t.shape)
            for name, mod in module.named_modules() for leaf, t in _jax_leaves(mod)}


def to_jax_tree(module: nn.Module) -> Dict:
    """The module's state as a nested dict in the JAX layout and names
    (contiguous CPU tensors at their dtype; a QuantLinear gives its int8
    ``kernel`` and fp32 ``kernel_scale``) — :func:`load_jax_params`'s inverse."""
    tree: Dict = {}
    path_of = jax_path_fn(module)
    for name, mod in module.named_modules():
        for leaf, t in _jax_leaves(mod):
            node = tree
            for seg in path_of(name):
                node = node.setdefault(seg, {})
            node[leaf] = t.detach().contiguous().to("cpu")  # the layout change on the module's device
    return tree


def to_numpy_tree(tree) -> Dict:
    """Nested mapping of array-likes → nested dict of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
