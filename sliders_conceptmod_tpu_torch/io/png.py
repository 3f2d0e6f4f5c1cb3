"""PNG encoding and decoding of uint8 images with ``zlib`` and ``struct`` only
(the GPU machine has no PIL). The encoder writes 8-bit RGB or grey with
filter 0; the decoder reads what other tools save too: every row filter and
every colour type and bit depth, interlaced or not, converted to 8 bits as
Pillow converts them (:func:`decode_png`)."""

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


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples per pixel (grey, RGB, palette, grey+alpha, RGBA)


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


# (colour type → bit depths the PNG spec allows)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: np.ndarray, pos: int, w: int, h: int, ch: int, depth: int) -> tuple:
    """Unfilter the ``h`` rows of a ``w``-pixel image (or interlace pass) that
    start at ``raw[pos]``; → (samples ``[h, w, ch]`` int64, next position)."""
    stride = (w * ch * depth + 7) // 8
    rows = raw[pos : pos + h * (1 + stride)]
    if rows.size != h * (1 + stride):
        raise ValueError("PNG image data is truncated")
    data = _unfilter(rows.reshape(h, 1 + stride), max(1, ch * depth // 8))
    if depth == 16:
        vals = data.reshape(h, -1, 2).astype(np.int64)
        vals = (vals[..., 0] << 8) | vals[..., 1]
    elif depth == 8:
        vals = data.astype(np.int64)
    else:  # 1, 2 or 4 bits, the first sample in the high bits; each row padded to a byte
        per = 8 // depth
        shifts = depth * np.arange(per - 1, -1, -1)
        vals = ((data[:, :, None].astype(np.int64) >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
    return vals[:, : w * ch].reshape(h, w, ch), pos + h * (1 + stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 ``[H, W]`` (grey) or ``[H, W, C]`` (C = 3 RGB, 2 grey
    with alpha, 4 RGBA): every colour type, bit depth and row filter of the
    spec, interlaced (Adam7) or not. Samples come out as Pillow 12's
    ``convert("RGB")`` takes them (each rule checked against Pillow 12.1.0,
    ``tests/test_torch_image_decode.py``):

    * palette (type 3, 1/2/4/8 bits) → RGB from ``PLTE``; an index past the
      palette's end gives black; ``tRNS`` is dropped;
    * grey at 1/2/4 bits → scaled to 0…255 (× 255, 85, 17);
    * 16-bit grey → **clipped** to 255, not scaled (Pillow holds it as
      ``I;16``, whose RGB conversion clips): 256 and 65535 both give 255;
    * 16-bit grey + alpha, RGB and RGBA → the high byte of each sample;
    * ``tRNS`` of grey or RGB images and every ancillary chunk → ignored.
    """
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG stream")
    pos, idat, hdr, plte = 8, [], None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0] != zlib.crc32(kind + payload):
            raise ValueError(f"bad CRC in {kind!r} chunk")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth not in _DEPTHS.get(color, ()):
        raise ValueError(f"invalid PNG: bit depth {depth} with colour type {color}")
    if color == 3 and not plte:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        vals, at = np.zeros((h, w, ch), np.int64), 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:  # an empty pass has no rows, not even filter bytes
                vals[y0::dy, x0::dx], at = _samples(raw, at, pw, ph, ch, depth)
    else:
        vals, _ = _samples(raw, 0, w, h, ch, depth)
    if color == 3:
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte[: len(plte) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        palette[: len(entries)] = entries
        return palette[vals[:, :, 0]]
    if depth == 16:
        vals = np.minimum(vals, 255) if color == 0 else vals >> 8
    elif depth < 8:
        vals = vals * (255 // ((1 << depth) - 1))
    img = vals.astype(np.uint8)
    return img[:, :, 0] if ch == 1 else img
