"""Blizzard texture (BLP) decoding, as ``PIL.Image.open(p).convert("RGB")``
gives it with Pillow 12's ``BlpImagePlugin`` (the GPU machine has no PIL).

* BLP1, JPEG (compression 0): the shared JPEG header and the first mipmap's
  bytes joined and decoded by ``io/jpeg.py``, then its RGB taken in the
  order B, G, R, as the plugin sets it.
* BLP1, palette (compression 1, encoding 4 or 5): 256 BGRA entries after the
  header, then the first mipmap's length of indices, read from just after
  the palette (the plugin does not seek to the mipmap's offset).
* BLP2, palette (encoding 1): the same entries, the indices read at the
  mipmap's offset.
* BLP2, DXT (encoding 2) with alpha encoding 0, 1 or 7: the plugin's own
  Python DXT1, DXT3 and DXT5 decoders, not the C ``bcn`` decoder: RGB565
  widened by a shift alone, DXT1's fourth colour transparent black where the
  first colour is not the larger, DXT3 and DXT5 always four colours. Their
  4 × 4 blocks fill rows padded to whole blocks, which are then read as the
  image's rows of 3 (no alpha) or 4 bytes a pixel: a width that is no
  multiple of 4, or DXT3/DXT5 without alpha, shears the picture exactly as
  Pillow shears it. The alpha of DXT3 and DXT5 is ``io/bcn.py``'s, which
  agrees with the plugin's bit for bit.

Anything else is refused as Pillow refuses it.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error
from sliders_conceptmod_tpu_torch.io.bcn import bc3_alpha
from sliders_conceptmod_tpu_torch.io.jpeg import decode_jpeg


def accept(prefix: bytes) -> bool:
    return prefix[:4] in (b"BLP1", b"BLP2")


def _truncated() -> ValueError:
    return error("BLP", "the file is truncated (Pillow refuses it too)")


def _read(data: bytes, at: int, n: int) -> bytes:
    part = data[at : at + max(n, 0)]
    if len(part) < n:
        raise _truncated()
    return part


def _palette(data: bytes, at: int) -> np.ndarray:
    """256 BGRA entries → ``[256, 4]`` RGBA."""
    bgra = np.frombuffer(_read(data, at, 1024), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def _indexed(data: bytes, at: int, length: int, palette: np.ndarray, channels: int, width: int,
             height: int) -> np.ndarray:
    idx = np.frombuffer(_read(data, at, length), np.uint8)
    return _as_rows(palette[idx][:, :channels].reshape(-1), width, height, channels)


def _as_rows(flat: np.ndarray, width: int, height: int, channels: int) -> np.ndarray:
    """``set_as_raw``: the bytes read as ``height`` rows of ``width`` pixels of
    ``channels`` bytes; too few raise as Pillow raises."""
    need = width * height * channels
    if flat.size < need:
        raise error("BLP", "not enough image data (Pillow refuses it too)")
    return flat[:need].reshape(height, width, channels)[:, :, :3].copy()


def _rgb565(c: np.ndarray) -> np.ndarray:
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _dxt_colours(raw: np.ndarray, dxt1: bool) -> np.ndarray:
    """8-byte colour blocks ``[n, 8]`` → ``[n, 16, 4]`` RGBA, as
    ``decode_dxt1`` (``dxt1``) and ``decode_dxt3``/``decode_dxt5`` compute
    them."""
    c0 = raw[:, 0].astype(np.int64) | raw[:, 1].astype(np.int64) << 8
    c1 = raw[:, 2].astype(np.int64) | raw[:, 3].astype(np.int64) << 8
    code = raw[:, 4:8].astype(np.int64)
    code = code[:, 0] | code[:, 1] << 8 | code[:, 2] << 16 | code[:, 3] << 24
    p0, p1 = _rgb565(c0), _rgb565(c1)
    four = (c0 > c1)[:, None] | (not dxt1)
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (2 * p1 + p0) // 3, 0)
    a = np.full((len(raw), 1), 255)
    table = np.stack([np.concatenate([p0, a], -1), np.concatenate([p1, a], -1), np.concatenate([p2, a], -1),
                      np.concatenate([p3, np.where(four, a, 0)], -1)], 1)
    idx = (code[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(table, idx[:, :, None], 1)


def _dxt(data: bytes, at: int, width: int, height: int, kind: int, channels: int) -> np.ndarray:
    bw, bh = (width + 3) // 4, (height + 3) // 4
    size = 8 if kind == 0 else 16
    raw = np.frombuffer(_read(data, at, bw * bh * size), np.uint8).reshape(bh * bw, size)
    if kind == 0:
        px = _dxt_colours(raw, True)
    else:
        px = _dxt_colours(raw[:, 8:], False)
        if kind == 1:
            nib = raw[:, :8].astype(np.int64)
            px[:, :, 3] = np.stack([nib & 15, nib >> 4], -1).reshape(-1, 16) * 17
        else:
            px[:, :, 3] = bc3_alpha(raw[:, :8])
        channels = 4  # decode_dxt3/decode_dxt5 write RGBA whatever the mode
    rows = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)[..., :channels]
    return rows.astype(np.uint8).reshape(-1)


def decode_blp(data: bytes) -> np.ndarray:
    """BLP bytes → uint8 ``[H, W, 3]`` of the first mipmap."""
    if not accept(data):
        raise NotThisFormat("not a BLP file")
    try:
        if data[:4] == b"BLP1":
            compression, alpha, width, height, encoding = struct.unpack_from("<iIIIi", data, 4)
            encoding_bits = None
            header = 28
        else:
            (compression,) = struct.unpack_from("<i", data, 4)
            encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
            width, height = struct.unpack_from("<II", data, 12)
            header = 20
            encoding_bits = alpha_encoding
    except struct.error:
        raise NotThisFormat("BLP: the header is truncated") from None
    channels = 4 if alpha else 3
    table = _read(data, header, 128)
    offsets, lengths = struct.unpack("<16I", table[:64]), struct.unpack("<16I", table[64:])
    pos = header + 128
    if encoding_bits is None:  # BLP1
        if compression == 0:
            (size,) = struct.unpack("<I", _read(data, pos, 4))
            jpeg_header = _read(data, pos + 4, size)
            pos = max(pos + 4 + size, offsets[0])
            rgb = decode_jpeg(jpeg_header + _read(data, pos, lengths[0]))
            return _as_rows(rgb[:, :, ::-1].reshape(-1), width, height, 3)  # raw "BGR", 3 bytes a pixel
        if compression == 1 and encoding in (4, 5):
            return _indexed(data, pos + 1024, lengths[0], _palette(data, pos), channels, width, height)
        raise error("BLP", f"compression {compression}, encoding {encoding} (Pillow refuses it too)")
    palette = _palette(data, pos)
    if compression != 1:
        raise error("BLP", f"compression {compression} (Pillow refuses it too)")
    if encoding == 1:
        return _indexed(data, offsets[0], lengths[0], palette, channels, width, height)
    if encoding != 2:
        raise error("BLP", f"encoding {encoding} (Pillow refuses it too)")
    kinds = {0: 0, 1: 1, 7: 2}
    if encoding_bits not in kinds:
        raise error("BLP", f"alpha encoding {encoding_bits} (Pillow refuses it too)")
    flat = _dxt(data, offsets[0], width, height, kinds[encoding_bits], channels)
    return _as_rows(flat, width, height, channels)
