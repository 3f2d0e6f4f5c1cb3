"""PCX and DCX decoding, as ``PIL.Image.open(p).convert("RGB")`` gives it with
Pillow 12's ``PcxImagePlugin``, ``DcxImagePlugin`` and its C run-length
decoder ``PcxDecode.c`` (the GPU machine has no PIL).

* Modes, as the plugin picks them: 1 bit in one plane (mode ``1``); 1 bit in
  2 or 4 planes (indices of the header's 16-colour palette, the planes'
  bits summed); 8 bits in one plane of a version 5 file, grey, or indices
  of the 256-colour palette stored in the last 769 bytes of the file when
  it starts with 12 and is not the grey ramp; 8 bits in 3 planes (RGB).
  Any other layout is refused as Pillow refuses it.
* Rows of ``planes × stride`` bytes, where the stride is the width's bytes,
  made even when the header's own stride differs from it; a byte with its
  two high bits set repeats the next byte its low six bits' times, any
  other byte is itself. A run past its row is refused as Pillow refuses
  it. Bit planes are read at the stride; 8-bit planes, where the row's
  bytes are no multiple of the width and exceed it, are first moved
  together as the decoder moves them, and otherwise read a width apart, so
  a padded RGB row is read as Pillow reads it.
* DCX: the first image of the directory of offsets, read as a PCX whose
  trailing palette is still the last 769 bytes of the whole file.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error


def accept_pcx(prefix: bytes) -> bool:
    """PCX's ``_accept`` and the size check its ``_open`` makes first."""
    if len(prefix) < 12 or prefix[0] != 10 or prefix[1] not in (0, 2, 3, 5):
        return False
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", prefix, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def accept_dcx(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from("<I", prefix)[0] == 0x3ADE68B1


def _rle_rows(data: bytes, pos: int, row_bytes: int, height: int) -> np.ndarray:
    out = bytearray(row_bytes * height)
    total = len(out)
    x = 0
    n = len(data)
    while x < total:
        if pos >= n:
            raise error("PCX", "the image data is truncated (Pillow refuses it too)")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise error("PCX", "the image data is truncated (Pillow refuses it too)")
            count = b & 0x3F
            if x % row_bytes + count > row_bytes:
                raise error("PCX", "a run past the end of its row (Pillow refuses it too)")
            out[x : x + count] = bytes([data[pos + 1]]) * count
            x += count
            pos += 2
        else:
            out[x] = b
            x += 1
            pos += 1
    return np.frombuffer(bytes(out), np.uint8).reshape(height, row_bytes)


def _planes_bits(rows: np.ndarray, planes: int, stride: int, width: int) -> np.ndarray:
    """``P;2L`` / ``P;4L``: bit planes of ``stride`` bytes each, bit k of a
    pixel's index from plane k."""
    idx = np.zeros((rows.shape[0], width), np.int64)
    for k in range(planes):
        plane = np.unpackbits(rows[:, k * stride : (k + 1) * stride], axis=1)[:, :width]
        idx |= plane.astype(np.int64) << k
    return idx


def decode_pcx(data: bytes, at: int = 0) -> np.ndarray:
    """PCX bytes (the header at ``at``) → uint8 ``[H, W, 3]``."""
    s = data[at : at + 68]
    if len(s) < 68 or not accept_pcx(s):
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    version, bits, planes = s[1], s[3], s[65]
    (provided_stride,) = struct.unpack_from("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P;L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            table = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (table == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", table
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB;L"
    else:
        raise error("PCX", f"{bits} bits in {planes} planes, version {version} (Pillow refuses it too)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    stride = (width * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2
    row_bytes = planes * stride
    rows = _rle_rows(data, at + 128, row_bytes, height)
    if mode == "P;L":  # bit planes are read at their stride
        return palette[_planes_bits(rows, planes, stride, width)]
    if row_bytes % width and row_bytes > width:  # PcxDecode.c moves 8-bit planes together
        bands = row_bytes // width
        step = row_bytes // bands
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * width : (i + 1) * width] = rows[:, i * step : i * step + width].copy()
    if mode == "1":
        g = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
        return np.repeat(g[:, :, None], 3, axis=2)
    if mode == "L":
        return np.repeat(rows[:, :width, None], 3, axis=2)
    if mode == "P":
        return palette[rows[:, :width]]
    return np.stack([rows[:, k * width : (k + 1) * width] for k in range(3)], -1)


def decode_dcx(data: bytes) -> np.ndarray:
    """DCX bytes → uint8 ``[H, W, 3]`` of its first image."""
    if not accept_dcx(data):
        raise NotThisFormat("not a DCX file")
    if len(data) < 8:
        raise NotThisFormat("DCX: the directory is truncated")
    (first,) = struct.unpack_from("<I", data, 4)
    if not first:
        raise error("DCX", "no images (Pillow refuses it too)")
    return decode_pcx(data, first)
