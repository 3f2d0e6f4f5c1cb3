"""Read and split slider files, and bind their text-encoder parts —
counterpart of ``sliders_conceptmod_tpu/adapters/slider_file.py``.

Key formats recognised (they may coexist in one file): raw UNet sliders
``lora_unet<d><path>.lora_down.weight`` (delimiter ``_`` or ``-``), raw
text-encoder sliders ``lora_te1_…`` / ``lora_te2_…``, and combined-file parts
(``transformer.<dotted>.lora_A/lora_B``, ``lora_te3_…`` for the second
tower), all mapped back to the canonical keys.

A text-encoder part binds to one tower (:func:`load_te_part`): its sites
are the notrigger trainer's — a CLIP tower's ``CLIPAttention`` projections
(``train_method`` "full", names under ``text_model.encoder``), or Flux's T5
(``te2_is_t5``: ``T5Attention`` q/k/v/o, ``t5attn``, names under
``encoder``) — kept to the keys the part carries; a DoRA part (``.dora_scale``) binds through ``adapters/dora.py``.
It has no ``start_noise`` gate: the prompt embeddings are made once per
trajectory, so the slider multiplier applies to the encode — the uncond
prompt's too — through the tower's weights merged at that multiplier
(:meth:`SliderParts.merged_text_encoders`).
"""

from __future__ import annotations

import dataclasses
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib

# torch-module-path segments above the port's CLIP layers in the reference's
# key names: lora_teN_text_model_encoder_layers_…
CLIP_NAME_PATH_PREFIX = ("text_model", "encoder")
# … and above T5's blocks (Flux's te2): lora_te2_encoder_block_…
T5_NAME_PATH_PREFIX = ("encoder",)

_SUFFIXES = (".lora_down.weight", ".lora_up.weight", ".alpha", ".dora_scale")
_PEFT_TO_CANON = {
    ".lora_A.weight": ".lora_down.weight",
    ".lora_B.weight": ".lora_up.weight",
    ".alpha": ".alpha",
    ".dora_scale": ".dora_scale",
}


def read_tensors(path: str) -> Dict[str, torch.Tensor]:
    """.safetensors (the port's own reader) or torch-pickle checkpoint →
    CPU tensors."""
    p = str(path)
    if p.endswith(".safetensors"):
        from sliders_conceptmod_tpu_torch.io.safetensors import load_file

        return load_file(p)
    data = torch.load(p, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu() for k, v in data.items()}


def _split_suffix(key: str) -> Optional[Tuple[str, str]]:
    for suf, canon in _PEFT_TO_CANON.items():
        if key.endswith(suf):
            return key[: -len(suf)], canon
    return None


def split_parts(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"unet": {...}, "te1": {...}, "te2": {...}}`` in canonical keys; empty
    parts omitted; unrecognised keys raise."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {}

    def put(part: str, key: str, v):
        parts.setdefault(part, {})[key] = v

    for k, v in sd.items():
        if k.startswith("transformer."):
            split = _split_suffix(k[len("transformer."):])
            if split is None:
                raise ValueError(f"unrecognized slider key: {k!r}")
            module, canon = split
            put("unet", "lora_unet-" + module.replace(".", "-") + canon, v)
        elif k.startswith("lora_unet"):
            if not any(k.endswith(s) for s in _SUFFIXES):
                raise ValueError(f"unrecognized slider key: {k!r}")
            put("unet", k, v)
        elif k.startswith("lora_te1_"):
            put("te1", k, v)
        elif k.startswith("lora_te2_"):
            put("te2", k, v)
        elif k.startswith("lora_te3_"):
            put("te2", "lora_te2_" + k[len("lora_te3_"):], v)
        else:
            raise ValueError(f"unrecognized slider key: {k!r}")
    return parts


def infer_rank_alpha(part: Dict[str, torch.Tensor]) -> Tuple[int, float]:
    """Rank from the first down factor (``[r, in]``), alpha from the first
    ``.alpha`` (default: the rank, a gain of 1)."""
    rank = alpha = None
    for k, v in part.items():
        if rank is None and k.endswith(".lora_down.weight"):
            rank = int(v.shape[0])
        if alpha is None and k.endswith(".alpha"):
            alpha = float(v.reshape(()))
    if rank is None:
        raise ValueError("slider part has no .lora_down.weight entries")
    return rank, float(rank if alpha is None else alpha)


def part_is_dora(part: Dict[str, torch.Tensor]) -> bool:
    return any(k.endswith(".dora_scale") for k in part)


@dataclass
class TEPart:
    """A text-encoder part bound to one tower (``index`` 0 = te1, 1 = te2)."""

    index: int
    encoder: nn.Module
    sites: List[lora_lib.LoRASite]
    lora_params: lora_lib.LoRAParams
    peft: object  # adapters.lora or adapters.dora

    def merged_params(self, multiplier: float) -> Dict[str, torch.Tensor]:
        """The tower's site weights with the part merged at ``multiplier``
        (``W + m·(α/r)·up∘down``, or DoRA's merge), for ``lora.merged_weights``."""
        return self.peft.merge_lora_params(self.encoder, self.sites, self.lora_params, multiplier)


def load_te_part(encoder: nn.Module, part: Dict[str, torch.Tensor], index: int, is_t5: bool = False,
                 dtype: torch.dtype = torch.float32) -> TEPart:
    """Bind a ``lora_te{1,2}`` part to a CLIP tower (``is_t5``: a T5 tower).
    A part whose keys match no site, or any key that lands on no site,
    raises: a partial text-encoder slider would make wrong images with no
    signal. Each site keeps its own ``.alpha``."""
    rank, alpha = infer_rank_alpha(part)
    prefix = f"lora_te{index + 1}"
    peft_mod = dora_lib if part_is_dora(part) else lora_lib
    if is_t5:
        target, method, path_prefix = ["T5Attention"], "t5attn", T5_NAME_PATH_PREFIX
    else:
        target, method, path_prefix = ["CLIPAttention", "CLIPSdpaAttention"], "full", CLIP_NAME_PATH_PREFIX
    sites = peft_mod.create_sites(encoder, rank=rank, alpha=alpha, target_replace=target, prefix=prefix,
                                  train_method=method, name_path_prefix=path_prefix)
    sites = lora_lib.filter_sites_to_keys(part.keys(), sites)
    if not sites:
        raise ValueError(f"no matching {prefix} keys between the text encoder and the slider part "
                         f"(part keys e.g. {sorted(part)[:2]})")
    matched = {s.lora_name for s in sites}
    unmatched = sorted(k for k in part if k.rsplit(".", 2)[0] not in matched)
    if unmatched:
        raise ValueError(f"{len(unmatched)} {prefix} slider keys match no full site over this text encoder "
                         f"(e.g. {unmatched[:3]}) — refusing to apply a partial text-encoder slider")
    alphas = {k[: -len(".alpha")]: float(v.reshape(())) for k, v in part.items() if k.endswith(".alpha")}
    sites = [dataclasses.replace(s, alpha=alphas.get(s.lora_name, s.alpha)) for s in sites]
    device = next(encoder.parameters()).device
    lora_params = peft_mod.load_weights_from_tensors(part, sites, dtype=dtype, device=device)
    return TEPart(index=index, encoder=encoder, sites=sites, lora_params=lora_params, peft=peft_mod)


@dataclass
class SliderParts:
    """All parts of one slider file: the UNet part's canonical-key tensors
    (or None) and the bound text-encoder parts."""

    unet: Optional[Dict[str, torch.Tensor]]
    te_parts: List[TEPart] = field(default_factory=list)

    @property
    def has_te(self) -> bool:
        return bool(self.te_parts)

    def merged_text_encoder_params(self, multiplier: float) -> Dict[int, Dict[str, torch.Tensor]]:
        """``{tower index: merged site weights}`` of every bound part."""
        return {p.index: p.merged_params(multiplier) for p in self.te_parts}

    @contextmanager
    def merged_text_encoders(self, multiplier: float) -> Iterator[None]:
        """Every bound tower runs with its part merged at ``multiplier`` for
        the encodes inside the block. Each tower's ``lora.model_lock`` is held
        for the whole block, so an encode on another thread (which takes the
        same lock) never sees the swapped weights."""
        with ExitStack() as stack:
            for p in self.te_parts:  # the merge reads the towers' weights: under their locks too
                stack.enter_context(lora_lib.model_lock(p.encoder))
            merged = self.merged_text_encoder_params(multiplier)
            for p in self.te_parts:
                stack.enter_context(lora_lib.merged_weights(p.encoder, merged[p.index]))
            yield


def load_slider_file(path: str, text_encoders: Optional[Sequence[nn.Module]] = None,
                     te2_is_t5: bool = False) -> SliderParts:
    """Read + split a slider file and bind its text-encoder parts to
    ``text_encoders`` (the tower modules, te1[, te2]; ``te2_is_t5``: te2 is
    Flux's T5). A file with a
    text-encoder part and no matching tower raises, rather than serving the
    slider without its text-encoder half."""
    parts = split_parts(read_tensors(path))
    te_parts: List[TEPart] = []
    for slot, index in (("te1", 0), ("te2", 1)):
        if slot not in parts:
            continue
        if text_encoders is None or index >= len(text_encoders):
            raise ValueError(f"slider file {path} carries a {slot} text-encoder part but the caller provided no "
                             "matching text encoder")
        te_parts.append(load_te_part(text_encoders[index], parts[slot], index, is_t5=te2_is_t5 and index == 1))
    return SliderParts(unet=parts.get("unet"), te_parts=te_parts)
