"""The entry points' ``--device`` flag as a torch device name."""

from __future__ import annotations


def torch_device(spec: str) -> str:
    """``--device``: a CUDA ordinal ("0") or a torch device name ("cpu")."""
    return f"cuda:{spec}" if str(spec).isdigit() else str(spec)
