"""QOI ("Quite OK Image") decoding in plain Python, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``QoiImagePlugin`` (the GPU machine has no PIL): the six operations of the
specification over a 64-entry hash of seen pixels, starting from opaque
black. Pillow's readings are kept: a run does not enter the hash, an index
to a slot not yet written is transparent black, a run may write past the
image's end (the rest is dropped), and the colour-space byte is ignored.
Alpha is dropped by ``convert("RGB")``."""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"qoif"


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes → uint8 ``[H, W, 3]``."""
    if len(data) < 14 or not accept(data):
        raise NotThisFormat("not a QOI file")
    width, height = struct.unpack_from(">II", data, 4)
    if width <= 0 or height <= 0:
        raise NotThisFormat("QOI: an empty image")
    total = width * height
    out = bytearray()
    seen = {}
    prev = (0, 0, 0, 255)
    pos = 14
    try:
        while len(out) < 3 * total:
            b = data[pos]
            pos += 1
            if b == 0xFE:  # QOI_OP_RGB
                v = (data[pos], data[pos + 1], data[pos + 2], prev[3])
                pos += 3
            elif b == 0xFF:  # QOI_OP_RGBA
                v = tuple(data[pos : pos + 4])
                if len(v) < 4:
                    raise IndexError
                pos += 4
            elif b < 0x40:  # QOI_OP_INDEX
                v = seen.get(b, (0, 0, 0, 0))
            elif b < 0x80:  # QOI_OP_DIFF
                v = ((prev[0] + ((b >> 4) & 3) - 2) % 256, (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
            elif b < 0xC0:  # QOI_OP_LUMA
                b2 = data[pos]
                pos += 1
                dg = (b & 63) - 32
                v = ((prev[0] + dg + (b2 >> 4) - 8) % 256, (prev[1] + dg) % 256,
                     (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
            else:  # QOI_OP_RUN
                out += bytes(prev[:3]) * ((b & 63) + 1)
                continue
            prev = v
            seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64] = v
            out += bytes(v[:3])
    except IndexError:
        raise ValueError("QOI: the image data is truncated") from None
    return np.frombuffer(bytes(out[: 3 * total]), np.uint8).reshape(height, width, 3).copy()
