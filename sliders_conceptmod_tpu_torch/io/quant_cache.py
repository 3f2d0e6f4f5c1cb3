"""On-disk int8 frozen bases — counterpart of ``sliders_conceptmod_tpu/io/quant_cache.py``.

``cli/quantize_checkpoint.py`` quantizes a checkpoint's UNet once and writes
it here; the loaders (``models/factory.py``) take the file as ``--base``. The
layout and the format tag are the JAX package's, so a file written by either
package loads in the other:

  ``<flax/module/path>/kernel``        int8  quantized Dense kernels ``[in, out]``
  ``<flax/module/path>/kernel_scale``  fp32  their per-column scales
  ``<flax/module/path>/...``           every other leaf at its dtype, in the JAX
                                       layout (``io/jax_params.py``)
  ``__scale__/<flax/module/path>``     fp32  the same scales, by module path

and the safetensors metadata holds ``sliders_conceptmod_tpu.quant_format =
int8-percol-v1`` (a file-format constant).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.quant import ScaleDict, quant_scales
from sliders_conceptmod_tpu_torch.io.jax_params import to_jax_tree
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, read_metadata, save_file

FORMAT_KEY = "sliders_conceptmod_tpu.quant_format"
FORMAT_V1 = "int8-percol-v1"
SCALE_PREFIX = "__scale__/"


def _flatten(tree: Mapping, prefix: str = ""):
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], Mapping):
            yield from _flatten(tree[k], key)
        else:
            yield key, tree[k]


def save_quantized(path: str, unet: nn.Module, metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write a quantized UNet (``adapters/quant.py::quantize_module``) as one
    safetensors file; returns the number of int8 kernels."""
    flat = dict(_flatten(to_jax_tree(unet)))
    scales = quant_scales(unet)
    for mod_path, s in scales.items():
        flat[SCALE_PREFIX + "/".join(mod_path)] = s.detach().to("cpu", torch.float32)
    save_file(flat, str(path), {FORMAT_KEY: FORMAT_V1, **(metadata or {})})
    return len(scales)


def load_quantized(path: str, dtype: torch.dtype = torch.bfloat16) -> Tuple[Dict, ScaleDict]:
    """``(tree, scales)``: the nested JAX-layout tree with int8 kernels kept
    int8, ``kernel_scale`` fp32 and every other leaf cast to ``dtype``, and
    the scales by module path. A file without the v1 tag raises."""
    meta = read_metadata(str(path))
    if meta.get(FORMAT_KEY) != FORMAT_V1:
        raise ValueError(
            f"{path} is not a {FORMAT_V1} artifact "
            f"(metadata {FORMAT_KEY!r} = {meta.get(FORMAT_KEY)!r}); "
            "produce one with cli/quantize_checkpoint"
        )
    tree: Dict = {}
    scales: ScaleDict = {}
    for key, t in load_file(str(path)).items():
        if key.startswith(SCALE_PREFIX):
            scales[tuple(key[len(SCALE_PREFIX):].split("/"))] = t.float()
            continue
        if t.dtype != torch.int8:
            t = t.float() if key.split("/")[-1] == "kernel_scale" else t.to(dtype)
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree, scales


def is_quantized_artifact(path: str) -> bool:
    """Header sniff: whether ``path`` carries the v1 format tag."""
    try:
        return read_metadata(str(path)).get(FORMAT_KEY) == FORMAT_V1
    except (OSError, ValueError):
        return False
