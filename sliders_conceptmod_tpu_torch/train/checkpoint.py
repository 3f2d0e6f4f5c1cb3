"""Resume checkpoints — counterpart of ``sliders_conceptmod_tpu/train/checkpoint.py``
(which uses orbax), written with ``torch.save``.

A resume checkpoint bundles the LoRA factors, the optimizer state, the next
step and the trainer's generator states, so a stopped run continues
bit-identically. The portable artifact stays the reference-schema
``.safetensors`` (``adapters/lora.py::save_weights``); this file is internal
state only.
"""

from __future__ import annotations

import os

import torch

from sliders_conceptmod_tpu_torch.adapters.lora import LoRAParams


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save(path: str, lora_params: LoRAParams, opt_state: dict, step: int, rng) -> None:
    payload = {"lora_params": _cpu(lora_params), "opt_state": _cpu(opt_state), "step": int(step),
               "rng": None if rng is None else rng.get_state()}
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_resume(save_dir, name: str, lora_params: LoRAParams, opt_state: dict, next_step: int, rng) -> None:
    """Write ``{name}_resume.pt`` next to the weight saves."""
    save(os.path.join(str(save_dir), f"{name}_resume.pt"), lora_params, opt_state, next_step, rng)


def _copy_into(live, saved, where: str):
    """``saved`` (from :func:`_cpu`) into ``live``: tensors copied in place on
    their devices, lists and dicts entry by entry, host numbers returned."""
    if isinstance(live, torch.Tensor):
        live.copy_(saved)
        return live
    if isinstance(live, (list, tuple)):
        if len(live) != len(saved):
            raise ValueError(f"resume checkpoint: {where} holds {len(saved)} entries, this run {len(live)}")
        return type(live)(_copy_into(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(live, saved)))
    if isinstance(live, dict):
        if set(live) != set(saved):
            raise ValueError(f"resume checkpoint: {where} keys {sorted(saved)} != this run's {sorted(live)} "
                             "(another optimizer?)")
        for k in live:
            live[k] = _copy_into(live[k], saved[k], f"{where}.{k}")
        return live
    return saved


@torch.no_grad()
def restore(path: str, lora_params: LoRAParams, opt_state: dict, rng) -> int:
    """Load a resume checkpoint into the given factors, optimizer state (any
    optimizer of ``train/optim.py``: its tensors, lists of tensors and host
    scalars) and generators (in place, on their devices); returns the step
    to start at."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    for name, leaf in lora_params.items():
        for k, t in leaf.items():
            t.copy_(payload["lora_params"][name][k])
    _copy_into(opt_state, payload["opt_state"], "opt_state")
    if rng is not None:
        rng.set_state(payload["rng"])
    return int(payload["step"])


def maybe_restore(resume_from, lora_params: LoRAParams, opt_state: dict, rng) -> int:
    """The step to start at: 0 when ``resume_from`` is falsy, else the
    checkpoint's (a directory holding one ``*_resume.pt``, or the file)."""
    if not resume_from:
        return 0
    path = str(resume_from)
    if os.path.isdir(path):
        found = sorted(f for f in os.listdir(path) if f.endswith("_resume.pt"))
        if len(found) != 1:
            raise FileNotFoundError(f"{path}: expected one *_resume.pt, found {found}")
        path = os.path.join(path, found[0])
    return restore(path, lora_params, opt_state, rng)
