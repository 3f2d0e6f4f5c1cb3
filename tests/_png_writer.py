"""A PNG writer for the decoder tests: every colour type and bit depth of the
PNG spec, optional Adam7 interlacing, PLTE and tRNS chunks, and per-row
filters applied by the spec's forward rules. Pillow writes only some of these
kinds (no 2/4-bit grey, no 16-bit colour, no interlacing), so the tests write
the files here and take Pillow's decode of them as the reference."""

import struct
import zlib

import numpy as np

# Adam7: (x0, y0, dx, dy) of each of the seven passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """``[h, w·ch]`` samples → ``[h, stride]`` bytes: MSB first below 8 bits,
    big-endian at 16, each row padded to a whole byte."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    groups = padded.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (groups << shifts).sum(-1).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, kinds) -> bytes:
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0 * cur, 1: left, 2: prev, 3: (left + prev) // 2, 4: _paeth(left, prev, upleft)}[kind]
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def write_png(samples: np.ndarray, depth: int, color: int, palette=None, trns: bytes = None,
              interlace: bool = False, kinds=(0, 1, 2, 3, 4)) -> bytes:
    """``samples`` ``[H, W]`` or ``[H, W, C]`` integers (palette indices for
    colour type 3) → PNG bytes."""
    arr = np.asarray(samples)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    assert ch == CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = arr[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter(_pack_rows(sub.reshape(sub.shape[0], -1), depth), bpp, kinds)
    else:
        raw = _filter(_pack_rows(arr.reshape(h, -1), depth), bpp, kinds)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
