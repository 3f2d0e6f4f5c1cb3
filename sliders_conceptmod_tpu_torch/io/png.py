"""PNG encoding and decoding of uint8 images with ``zlib`` and ``struct`` only
(the GPU machine has no PIL). The encoder writes 8-bit RGB or grey with
filter 0; the decoder reads what other tools save too: every row filter and
the alpha colour types."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """``uint8 [H, W, 3]`` (or ``[H, W]`` grey) → PNG bytes, filter 0 rows."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes uint8 [H,W,3] or [H,W], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, level))
        + _chunk(b"IEND", b"")
    )


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → samples per pixel (grey, RGB, grey+alpha, RGBA)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9: 0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth) of ``rows`` ``[h, 1 + stride]`` uint8; ``bpp`` bytes per pixel.
    None, Sub and Up are vectorised; Average and Paeth depend on the
    reconstructed byte to their left and run byte by byte."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)  # sums wrap mod 256
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            raw, up, rec = line.tolist(), prior.tolist(), bytearray(stride)
            for i in range(stride):
                left = rec[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                rec[i] = (raw[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(rec), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not one of 0-4")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 ``[H, W]`` (grey) or ``[H, W, C]`` (C = 3 RGB, 2 grey
    with alpha, 4 RGBA): 8-bit samples, non-interlaced, any of the five row
    filters. Palette, 16-bit and interlaced images raise ``ValueError``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG stream")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0] != zlib.crc32(kind + payload):
            raise ValueError(f"bad CRC in {kind!r} chunk")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if color == 3:
        raise ValueError("palette PNGs are not supported: save the image as 8-bit RGB or grey")
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color} (8-bit grey/RGB[A] only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNGs are not supported: save the image without interlacing")
    ch = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    img = _unfilter(rows, ch).reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img
