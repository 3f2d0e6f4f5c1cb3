"""Read and split slider files — counterpart of
``sliders_conceptmod_tpu/adapters/slider_file.py`` for the UNet part.

Key formats recognised (they may coexist in one file): raw UNet sliders
``lora_unet<d><path>.lora_down.weight`` (delimiter ``_`` or ``-``), raw
text-encoder sliders ``lora_te1_…`` / ``lora_te2_…``, and combined-file parts
(``transformer.<dotted>.lora_A/lora_B``, ``lora_te3_…``), all mapped back to
the canonical keys. Text-encoder parts are recognised but not applied yet:
:func:`load_slider_file` raises ``NotImplementedError`` for a file that
carries one, rather than serving the slider without its text-encoder half.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

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


@dataclass
class SliderParts:
    unet: Optional[Dict[str, torch.Tensor]]  # canonical-key tensors (or None)


def load_slider_file(path: str) -> SliderParts:
    """Read + split a slider file (UNet part)."""
    parts = split_parts(read_tensors(path))
    te = sorted(slot for slot in ("te1", "te2") if slot in parts)
    if te:
        raise NotImplementedError(
            f"slider file {path} carries text-encoder parts ({', '.join(te)}); the PyTorch port "
            "applies UNet slider parts only so far (ROADMAP.md queue 1, item 7)"
        )
    return SliderParts(unet=parts.get("unet"))
