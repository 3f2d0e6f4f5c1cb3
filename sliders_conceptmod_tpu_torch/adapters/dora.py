"""DoRA (weight-decomposed LoRA) slider adapters — counterpart of
``sliders_conceptmod_tpu/adapters/dora.py`` (reference
``conceptmod/textsliders/dora.py:97-162``).

The fork's DoRA variant:

* ``dora_scale`` is a learnable magnitude per INPUT column, initialised to
  the base weight's column norm ‖W[:, j]‖₂ (over ``out`` and, for a conv,
  ``kh, kw``) — the fork norms per input column, not per output row;
* the merged weight is ``W + m·(α/r)·(W′·dora_scale/‖W′‖_col − W)`` with
  ``W′ = W + up∘down`` (no α/r inside) and the norm gradient-stopped.

In the port's ``[out, in]`` / ``[out, in, kh, kw]`` layout the column norm is
``[1, in]`` / ``[1, in, 1, 1]``, which is also the saved ``.dora_scale``
layout, so I/O needs no transpose. Dtypes follow the JAX module: a Linear's
norm comes out in the weight's dtype (bf16 at init over a bf16 base: the
sum of squares in fp32 rounded to bf16, then the root in bf16, which is what
XLA makes of ``jnp.linalg.norm`` on a bf16 kernel), a conv's is computed in
fp32 and cast; ``W′`` promotes to fp32 with the fp32 factors, and the delta
is cast to ``W``'s dtype only where it is added
(``adapters/lora.py::merge_site_weights``). Sites, the overlay's lock and the
LoRA keys are ``adapters/lora.py``'s; DoRA has no overlay route.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.lora import (  # noqa: F401 (re-exported for callers)
    DEFAULT_TARGET_REPLACE,
    UNET_TARGET_REPLACE_MODULE_CONV,
    UNET_TARGET_REPLACE_MODULE_TRANSFORMER,
    LoRAParams,
    LoRASite,
    create_sites,
)


def _col_norm(weight: torch.Tensor) -> torch.Tensor:
    """Per-input-column L2 norm: ``[out, in]`` → ``[1, in]`` in the weight's
    dtype; ``[out, in, kh, kw]`` → ``[1, in, 1, 1]``, computed in fp32 and
    cast."""
    if weight.ndim == 2:  # the sum of squares in fp32, rounded to the weight's dtype, then the root
        return weight.float().pow(2).sum(dim=0, keepdim=True).to(weight.dtype).sqrt()
    return weight.float().pow(2).sum(dim=(0, 2, 3), keepdim=True).sqrt().to(weight.dtype)


def _scale_shape(site: LoRASite):
    return (1, site.in_dim) if site.kind == "dense" else (1, site.in_dim, 1, 1)


def init_lora_params(sites: Sequence[LoRASite], model: nn.Module, generator: Optional[torch.Generator] = None,
                     device=None, dtype=torch.float32) -> LoRAParams:
    """The LoRA factors as ``adapters/lora.py`` draws them, plus
    ``dora_scale`` = the column norm of each site's base weight."""
    params = lora_lib.init_lora_params(sites, generator=generator, device=device, dtype=dtype)
    with torch.no_grad():
        for site, _, weight in lora_lib.site_weights(model, sites):
            leaf = params[site.lora_name]
            leaf["dora_scale"] = _col_norm(weight).to(leaf["down"].device, dtype)
    return params


def _dora_delta(site: LoRASite, leaf: Dict[str, torch.Tensor], weight: torch.Tensor) -> torch.Tensor:
    """(α/r)·(decompose(W + up∘down) − W), the norm gradient-stopped (the
    reference detaches it)."""
    w_prime = weight + lora_lib.compose_factors(site, leaf)
    norm = _col_norm(w_prime).detach()
    return (w_prime * (leaf["dora_scale"] / norm) - weight) * site.scale


def merge_lora_params(model: nn.Module, sites: Sequence[LoRASite], dora_params: LoRAParams, multiplier: float,
                      grad: bool = False) -> Dict[str, torch.Tensor]:
    """``{parameter name: W + (m·(α/r)·(decompose(W + BA) − W)).to(W.dtype)}``
    for the site modules (``adapters/lora.py::merge_site_weights``; ``grad``
    keeps the graph through the factors and ``dora_scale``)."""
    return lora_lib.merge_site_weights(model, sites, dora_params, multiplier, _dora_delta, grad)


# --- checkpoint I/O: the LoRA schema + .dora_scale ---------------------------


def state_dict_tensors(sites: Sequence[LoRASite], dora_params: LoRAParams,
                       dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    out = lora_lib.state_dict_tensors(sites, dora_params, dtype=dtype)
    for site in sites:
        out[f"{site.lora_name}.dora_scale"] = dora_params[site.lora_name]["dora_scale"].detach().to("cpu", dtype)
    return out


def state_dict_numpy(sites: Sequence[LoRASite], dora_params: LoRAParams, dtype=np.float32) -> Dict[str, np.ndarray]:
    return {k: v.numpy().astype(dtype) for k, v in state_dict_tensors(sites, dora_params).items()}


def save_weights(path: str, sites: Sequence[LoRASite], dora_params: LoRAParams, dtype=torch.float32,
                 metadata=None) -> None:
    lora_lib.write_state_dict(path, state_dict_tensors(sites, dora_params, dtype=dtype), metadata)


def load_weights_from_tensors(sd, sites: Sequence[LoRASite], dtype=torch.float32, device=None) -> LoRAParams:
    params = lora_lib.load_weights_from_tensors(sd, sites, dtype=dtype, device=device)
    for site in sites:
        ds = sd[f"{site.lora_name}.dora_scale"]
        ds = ds if isinstance(ds, torch.Tensor) else torch.from_numpy(np.array(ds))
        if tuple(ds.shape) != _scale_shape(site):
            raise ValueError(f"{site.lora_name}: dora_scale shape {tuple(ds.shape)} != {_scale_shape(site)}")
        params[site.lora_name]["dora_scale"] = ds.to(device=device, dtype=dtype)
    return params


def load_weights(path: str, sites: Sequence[LoRASite], dtype=torch.float32, device=None) -> LoRAParams:
    from sliders_conceptmod_tpu_torch.adapters.slider_file import read_tensors

    return load_weights_from_tensors(read_tensors(path), sites, dtype=dtype, device=device)
