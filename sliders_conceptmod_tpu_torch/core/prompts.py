"""Prompt schema — counterpart of ``sliders_conceptmod_tpu/core/prompts.py``.

* ``PromptSettings`` defaulting rules: positive ← target, unconditional ← "",
  neutral ← unconditional, and the fork's 5th prompt negative ←
  unconditional (which makes the 5-prompt loss collapse to the upstream
  4-prompt one);
* ``attributes`` fan-out: each attribute is prefixed (``f"{att} {p}"``) onto
  all five prompts of every pair, multiplying the settings list;
* ``action_sign``: −1 erase, +1 enhance, the sign of ``g·(positive −
  negative)`` in the ESD target ``neutral ± g·(positive − negative)``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Literal, Optional

from sliders_conceptmod_tpu_torch.core import yaml_subset
from sliders_conceptmod_tpu_torch.core.config import dump, from_dict

ACTION_TYPES = Literal["erase", "enhance"]


@dataclass
class PromptSettings:
    """One slider concept."""

    target: str
    positive: Optional[str] = None  # None: the target
    negative: Optional[str] = None  # 5th prompt; None: unconditional
    unconditional: Optional[str] = ""
    neutral: Optional[str] = None  # None: unconditional
    action: ACTION_TYPES = "erase"
    guidance_scale: float = 1.0
    resolution: int = 512
    dynamic_resolution: bool = False
    batch_size: int = 1
    dynamic_crops: bool = False  # only used for XL

    def __post_init__(self):
        if self.positive is None:
            self.positive = self.target
        if self.unconditional is None:
            self.unconditional = ""
        if self.neutral is None:
            self.neutral = self.unconditional
        if self.negative is None:
            self.negative = self.unconditional

    @classmethod
    def from_dict(cls, data: dict) -> "PromptSettings":
        if "target" not in data:
            raise ValueError("target must be specified")
        return from_dict(cls, data)

    def model_dump(self) -> dict:
        return dump(self)


def load_prompts_from_yaml(path, attributes: Optional[List[str]] = None) -> List[PromptSettings]:
    """The prompt pairs of a YAML list, fanned out over ``attributes``."""
    attributes = attributes or []
    prompts = yaml_subset.load_file(path)
    if not prompts:
        raise ValueError("prompts file is empty")
    if attributes:
        out = []
        for prompt in prompts:
            # validate first so the defaulted fields exist before prefixing
            base = PromptSettings.from_dict(prompt).model_dump()
            for att in attributes:
                p = copy.deepcopy(base)
                for k in ("target", "positive", "neutral", "negative", "unconditional"):
                    p[k] = att + " " + p[k]
                out.append(PromptSettings.from_dict(p))
        return out
    return [PromptSettings.from_dict(copy.deepcopy(p)) for p in prompts]


def action_sign(action: str) -> float:
    if action == "erase":
        return -1.0
    if action == "enhance":
        return 1.0
    raise ValueError("action must be erase or enhance")

