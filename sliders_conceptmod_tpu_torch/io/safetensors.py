""".safetensors reading and writing without the ``safetensors`` package.

The format: an unsigned little-endian 64-bit header length N, N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, then the raw little-endian tensor buffers, each at its offsets
relative to the end of the header. Tensors come back as CPU ``torch.Tensor``s
(bfloat16 included, which numpy lacks).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 << 20  # the format's own limit on the JSON header


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(value))


def read_metadata(path: str) -> Dict[str, str]:
    """The header's ``__metadata__`` (empty when it has none), read without
    the tensors."""
    with open(path, "rb") as f:
        header, _ = _read_header(f, path)
    return dict(header.get("__metadata__") or {})


def read_keys(path: str) -> list:
    """The tensor names of the header, read without the tensors."""
    with open(path, "rb") as f:
        header, _ = _read_header(f, path)
    return [k for k in header if k != "__metadata__"]


def load_meta(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor's name, shape and dtype, as tensors on the meta device,
    read from the header alone."""
    with open(path, "rb") as f:
        header, _ = _read_header(f, path)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} for {name}")
        out[name] = torch.empty(tuple(int(s) for s in info["shape"]), dtype=dtype, device="meta")
    return out


def _read_header(f, path: str) -> dict:
    head = f.read(8)
    if len(head) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", head)
    if n > _MAX_HEADER:
        raise ValueError(f"{path}: header length {n} is not a safetensors header's")
    return json.loads(f.read(n).decode("utf-8")), 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor, each read from the file into its own buffer (one copy
    of the data in memory, whatever the file's size)."""
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as f:
        header, start = _read_header(f, path)
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: unsupported dtype {info['dtype']} for {name}")
            begin, end = info["data_offsets"]
            shape = tuple(int(s) for s in info["shape"])
            itemsize = torch.empty((), dtype=dtype).element_size()
            if (not 0 <= begin <= end <= size - start
                    or end - begin != int(np.prod(shape, dtype=np.int64)) * itemsize):
                raise ValueError(f"{path}: bad data_offsets {info['data_offsets']} for {name}")
            raw = bytearray(end - begin)
            f.seek(start + begin)
            if f.readinto(raw) != len(raw):
                raise ValueError(f"{path}: {name} runs past the end of the file")
            t = torch.frombuffer(raw, dtype=torch.uint8) if raw else torch.empty(0, dtype=torch.uint8)
            out[name] = t.view(dtype).reshape(shape)
    return out


def save_file(
    tensors: Mapping[str, object], path: str, metadata: Optional[Mapping[str, str]] = None
) -> None:
    """Write tensors (torch tensors on any device, or numpy arrays) in name
    order, one at a time: the header from their shapes first, then each
    buffer, so no second copy of the whole set is held."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        dtype = t.dtype if isinstance(t, torch.Tensor) else torch.from_numpy(np.zeros(0, dtype=t.dtype)).dtype
        if dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {dtype} for {name}")
        nbytes = int(np.prod(tuple(t.shape), dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": _NAMES[dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)  # buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in sorted(tensors):
            t = _as_tensor(tensors[name]).contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
