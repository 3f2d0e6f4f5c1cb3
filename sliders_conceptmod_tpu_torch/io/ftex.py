"""FTEX (the texture format of Independence War 2) decoding, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``FtexImagePlugin`` (the GPU machine has no PIL): the first mipmap of the
file's one format, uncompressed RGB or DXT1 (through ``io/bcn.py``)."""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error
from sliders_conceptmod_tpu_torch.io.bcn import decode_bcn


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"FTEX"


def decode_ftex(data: bytes) -> np.ndarray:
    """FTEX bytes → uint8 ``[H, W, 3]`` of the first mipmap."""
    try:
        width, height, _, format_count, kind, where = struct.unpack_from("<6i", data, 8)
        (size,) = struct.unpack_from("<i", data, where)
    except struct.error:
        raise NotThisFormat("FTEX: the header is truncated") from None
    if not accept(data):
        raise NotThisFormat("not an FTEX file")
    if format_count != 1:
        raise error("FTEX", f"{format_count} formats (Pillow refuses it too)")
    if width < 0 or height < 0 or size < 0:
        raise error("FTEX", "a negative size (Pillow refuses it too)")
    mip = data[where + 4 : where + 4 + size]
    if kind == 0:
        return decode_bcn(mip, width, height, 1, fmt="FTEX")[:, :, :3].copy()
    if kind == 1:
        if len(mip) < width * height * 3:
            raise error("FTEX", "the image data is truncated (Pillow refuses it too)")
        return np.frombuffer(mip, np.uint8, width * height * 3).reshape(height, width, 3).copy()
    raise error("FTEX", f"texture format {kind} (Pillow refuses it too)")
