"""Config schema — counterpart of ``sliders_conceptmod_tpu/core/config.py``.

The same YAML schema, fields and defaults (so every ``data/*.yaml`` loads
unchanged, ``tpu:`` block included), as dataclasses with pydantic-v2-like
lax coercion (``3`` → ``3.0`` for a float field, ``"1e-4"`` → ``0.0001``,
``"true"`` → ``True``; unknown keys are ignored, except in ``tpu:``, which
keeps them as attributes, as the JAX ``TPUConfig`` allows extras). YAML is
read with the port's own :mod:`~sliders_conceptmod_tpu_torch.core.yaml_subset`.

On one GPU the ``tpu:`` knobs that mean one device (``mesh_data`` -1 or 1,
``mesh_model`` 1, no multi-process world) are accepted; the trainer refuses
the knobs this port does not carry yet with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass
from typing import Any, Literal, Optional

import torch

from sliders_conceptmod_tpu_torch.core import yaml_subset

PRECISION_TYPES = Literal["fp32", "fp16", "bf16", "float32", "float16", "bfloat16"]
NETWORK_TYPES = Literal["lierla", "c3lier"]
SCHEDULER_TYPES = Literal["ddim", "ddpm", "lms", "euler_a", "builtin", "wuerstchen"]

_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


def _coerce(value: Any, tp: Any, where: str) -> Any:
    """Lax validation of one field value against its annotation."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0], where)
    if origin is Literal:
        choices = typing.get_args(tp)
        if value not in choices:
            raise ValueError(f"{where}: {value!r} is not one of {choices}")
        return value
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise ValueError(f"{where}: {value!r} is not a bool")
    if tp is int:
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                pass
        raise ValueError(f"{where}: {value!r} is not an int")
    if tp is float:
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                pass
        raise ValueError(f"{where}: {value!r} is not a float")
    if tp is str:
        if not isinstance(value, str):
            raise ValueError(f"{where}: {value!r} is not a string")
        return value
    if dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ValueError(f"{where}: expected a mapping, got {value!r}")
        return from_dict(tp, value, where)
    raise TypeError(f"{where}: no rule for {tp}")


def from_dict(cls, data: dict, where: str = ""):
    """Build dataclass ``cls`` from a mapping, validating each field."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: _coerce(v, hints[k], f"{where}{k}") for k, v in data.items() if k in names}
    missing = [f.name for f in dataclasses.fields(cls)
               if f.name not in kwargs and f.default is dataclasses.MISSING
               and f.default_factory is dataclasses.MISSING]
    if missing:
        raise ValueError(f"{where or cls.__name__}: missing required field(s) {missing}")
    obj = cls(**kwargs)
    if getattr(cls, "allow_extra", False):
        for k, v in data.items():
            if k not in names:
                setattr(obj, k, v)
    return obj


def dump(obj) -> Any:
    """Nested plain values (the JAX package's ``model_dump()``)."""
    if dataclasses.is_dataclass(obj):
        out = {f.name: dump(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if getattr(obj, "allow_extra", False):
            out.update({k: dump(v) for k, v in vars(obj).items() if k not in out})
        return out
    return obj


@dataclass
class PretrainedModelConfig:
    name_or_path: str
    v2: bool = False
    v_pred: bool = False
    clip_skip: Optional[int] = None


@dataclass
class NetworkConfig:
    type: NETWORK_TYPES = "lierla"
    rank: int = 4
    alpha: float = 1.0
    training_method: str = "full"


@dataclass
class TrainConfig:
    precision: PRECISION_TYPES = "bfloat16"
    noise_scheduler: SCHEDULER_TYPES = "ddim"
    iterations: int = 500
    lr: float = 1e-3
    eta_min: float = 1e-4
    lambda_similarity: float = 0.1
    optimizer: str = "adamw"
    optimizer_args: str = ""
    lr_scheduler: str = "constant"
    cfg: float = 1.0
    max_denoising_steps: int = 50


@dataclass
class SaveConfig:
    name: str = "untitled"
    path: str = "./output"
    per_steps: int = 200
    precision: PRECISION_TYPES = "float32"


@dataclass
class LoggingConfig:
    use_wandb: bool = False
    verbose: bool = False


@dataclass
class OtherConfig:
    use_xformers: bool = False


@dataclass
class TPUConfig:
    """The JAX package's device-layer extensions, kept under their names so
    the YAML files load unchanged (extra keys allowed). What each knob means
    is documented in the JAX ``TPUConfig``; on one GPU the single-device
    values are accepted."""

    allow_extra = True

    mesh_data: int = -1
    mesh_model: int = 1
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    samples_per_step: int = 1
    use_flash_attention: bool = True
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    compilation_cache_dir: Optional[str] = None
    persistent_cache_min_compile_seconds: float = 1.0
    seed: int = 0
    honor_network_config: bool = True
    sequence_parallel: bool = False
    sp_min_seq: int = 4096
    pipeline_warmup: bool = False
    fuse_teacher_student: bool = False
    quantize_base: bool = False
    w8a8_warmup: bool = False
    student_overlay: Optional[bool] = None
    overlay_warmup: Optional[bool] = None
    share_warmup: bool = False


@dataclass
class RootConfig:
    prompts_file: str
    pretrained_model: PretrainedModelConfig
    network: NetworkConfig
    train: Optional[TrainConfig] = None
    save: Optional[SaveConfig] = None
    logging: Optional[LoggingConfig] = None
    other: Optional[OtherConfig] = None
    tpu: Optional[TPUConfig] = None

    def model_dump(self) -> dict:
        return dump(self)

    def model_dump_json(self) -> str:
        return json.dumps(self.model_dump())


def parse_precision(precision: str) -> torch.dtype:
    """Compute dtype. fp16 maps to bfloat16, as in the JAX package: the
    flash-attention kernels take float32 and bfloat16."""
    if precision in ("fp32", "float32"):
        return torch.float32
    if precision in ("fp16", "float16", "bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Invalid precision type: {precision}")


def parse_save_precision(precision: Optional[str]) -> torch.dtype:
    """The export dtype, as configured (downstream loaders read it verbatim)."""
    if precision in ("fp32", "float32", None, ""):
        return torch.float32
    if precision in ("fp16", "float16"):
        return torch.float16
    if precision in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Invalid precision type: {precision}")


def resolve_student_overlay(tpu_cfg, quantize_base: bool, peft_type: str, default_overlay=None):
    """``tpu.student_overlay`` / ``tpu.overlay_warmup`` → ``(student_overlay,
    overlay_warmup)``: the JAX ``resolve_student_overlay``, rule for rule.

    ``student_overlay``: ``None`` follows ``default_overlay`` when the caller
    gives one (the ESD trainers pass ``peft_type == "lora"``, the image-pair
    CLI ``True``), else ``quantize_base``. An explicit ``true`` with DoRA
    raises (its norm decomposition needs the merged weights); DoRA under a
    default resolves to the merged student. An explicit ``false`` over an
    int8 base raises.

    ``overlay_warmup``: only with the overlay student (``true`` without it
    raises); ``None`` → ``quantize_base``, so a bf16 LoRA warms up through
    the merged weights and only the student runs the overlay. An explicit
    ``false`` over an int8 base raises. Without the overlay student the
    warm-up is merged and the second value is ``None``."""
    student_overlay = getattr(tpu_cfg, "student_overlay", None)
    if student_overlay is None:
        if default_overlay is not None:
            student_overlay = bool(default_overlay) or quantize_base
        else:
            student_overlay = quantize_base
    else:
        student_overlay = bool(student_overlay)
        if student_overlay and peft_type == "dora":
            raise NotImplementedError(
                "tpu.student_overlay supports LoRA only (DoRA's norm decomposition merges)"
            )
    if quantize_base and not student_overlay:
        raise ValueError(
            "tpu.student_overlay: false is incompatible with quantize_base: "
            "true — an int8 base cannot host the merged student"
        )
    if peft_type == "dora":
        student_overlay = False

    overlay_warmup = getattr(tpu_cfg, "overlay_warmup", None)
    if not student_overlay:
        if overlay_warmup:
            raise ValueError("tpu.overlay_warmup: true requires tpu.student_overlay: true")
        return False, None
    if overlay_warmup is None:
        overlay_warmup = bool(quantize_base)
    else:
        overlay_warmup = bool(overlay_warmup)
    if quantize_base and not overlay_warmup:
        raise ValueError(
            "tpu.overlay_warmup: false needs the merged warm-up tree — "
            "impossible over a quantized (int8) base"
        )
    return student_overlay, overlay_warmup


def load_config_from_yaml(config_path: str) -> RootConfig:
    """Load a config YAML; missing blocks get their defaults."""
    data = yaml_subset.load_file(config_path)
    if not isinstance(data, dict):
        raise ValueError(f"{config_path}: the top level must be a mapping")
    root = from_dict(RootConfig, data)
    root.train = root.train or TrainConfig()
    root.save = root.save or SaveConfig()
    root.logging = root.logging or LoggingConfig()
    root.other = root.other or OtherConfig()
    root.tpu = root.tpu or TPUConfig()
    return root
