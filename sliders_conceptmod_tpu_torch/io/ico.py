"""Windows icon (ICO) and cursor (CUR) decoding, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``IcoImagePlugin`` and ``CurImagePlugin`` (the GPU machine has no PIL).

* ICO: the entry Pillow shows first: the directory sorted by colour depth
  (its bit count, else from its colour count, else 256), then, stably, by
  area, largest first. A PNG entry is decoded by ``io/png.py``; a DIB entry
  by ``io/bmp.py`` at half its stored height, its AND mask (or a 32-bit
  entry's alpha bytes) read and checked as Pillow reads them and then
  dropped with the alpha by ``convert("RGB")``.
* CUR: the first entry, replaced by any later one larger in both stored
  dimension bytes; a DIB at half its stored height. A cursor file without
  entries is not a cursor for Pillow, and identification moves on: an
  uncompressed true-colour TGA begins with CUR's signature.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io.bmp import decode_bitmap
from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error
from sliders_conceptmod_tpu_torch.io.png import png_rgb


def accept_ico(prefix: bytes) -> bool:
    return prefix[:4] == b"\0\0\1\0"


def accept_cur(prefix: bytes) -> bool:
    return prefix[:4] == b"\0\0\2\0"


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes → uint8 ``[H, W, 3]`` of the entry Pillow opens."""
    try:
        (count,) = struct.unpack_from("<H", data, 4)
        entries = []
        for i in range(count):
            e = data[6 + 16 * i : 22 + 16 * i]
            w, h, colours = e[0] or 256, e[1] or 256, e[2]
            bpp, size, offset = struct.unpack_from("<HII", e, 6)
            depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
            entries.append((w * h, depth, bpp, size, offset))
    except (IndexError, struct.error):
        raise NotThisFormat("ICO: the directory is truncated") from None
    if not entries:
        raise NotThisFormat("ICO: no entries")
    entries.sort(key=lambda x: x[1])
    entries.sort(key=lambda x: x[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    if data[offset : offset + 8] == b"\x89PNG\r\n\x1a\n":
        return png_rgb(data[offset:])
    img = decode_bitmap(data, offset, 0, halve=True)
    height, width = img.shape[:2]
    if bpp == 32:
        need = width * height * 4
        if len(data) < _pixel_offset(data, offset) + need:
            raise error("ICO", "the alpha bytes are truncated (Pillow refuses it too)")
    else:
        stride = -(-width // 32) * 4
        mask_at = offset + size - stride * height
        if mask_at < 0 or len(data[mask_at : mask_at + stride * height]) < stride * height:
            raise error("ICO", "the AND mask is truncated (Pillow refuses it too)")
    return img


def _pixel_offset(data: bytes, at: int) -> int:
    """Where a DIB's pixels start: after its header, masks and palette."""
    header_size, = struct.unpack_from("<I", data, at)
    pos = at + header_size
    if header_size == 12:
        bits, colours, entry = struct.unpack_from("<H", data, at + 10)[0], 0, 3
    else:
        bits, compression = struct.unpack_from("<HI", data, at + 14)
        colours, entry = struct.unpack_from("<I", data, at + 32)[0], 4
        if compression == 3 and header_size == 40:
            pos += 12
    return pos + (entry * (colours or (1 << bits)) if bits <= 8 else 0)


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes → uint8 ``[H, W, 3]`` of the entry Pillow opens."""
    try:
        (count,) = struct.unpack_from("<H", data, 4)
        best = b""
        for i in range(count):
            e = data[6 + 16 * i : 22 + 16 * i]
            if not best or (e[0] > best[0] and e[1] > best[1]):
                best = e
        if not best:
            raise NotThisFormat("CUR: no cursors")
        at = struct.unpack_from("<I", best, 12)[0] or 6 + 16 * count
    except (IndexError, struct.error):
        raise NotThisFormat("CUR: the directory is truncated") from None
    return decode_bitmap(data, at, 0, halve=True)
