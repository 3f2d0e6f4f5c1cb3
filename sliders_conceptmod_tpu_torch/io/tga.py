"""Truevision TGA decoding in numpy and plain Python, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``TgaImagePlugin`` (the GPU machine has no PIL).

* Image types 1 and 9 (colour-mapped, 8-bit indices), 2 and 10 (true
  colour: 16-bit ``ARRRRRGGGGGBBBBB`` little-endian, 24-bit BGR, 32-bit
  BGRA), 3 and 11 (grey: 8 bits, 8 bits with alpha in 16, or 1 bit packed);
  9–11 run-length coded, their packets crossing rows where they do.
* Colour maps of 16 and 24 bits, the entries before the map's first index
  black. Pillow's reader rejects a 15-bit map (identification moves on)
  and fails to unpack a 32-bit one, so the port refuses that.
* 5-bit channels scaled by ``· 255 // 31``, as Pillow's ``BGRA;15Z``.
* Origin: bottom rows first unless bit 5 of the descriptor is set; bit 4
  mirrors the image left to right.
* TGA has no signature: ``io/image.py`` tries it after every other format,
  with Pillow's header checks, as ``Image.open`` does.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error


def _rgb15(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31], -1)


def _rle(data: bytes, pos: int, depth: int, row_bytes: int, rows: int) -> bytes:
    """``TgaRleDecode.c``: packets of ``depth`` bytes a pixel, filled row
    by row; a literal packet may run on into the next row, a repeat packet
    that crosses a row's end is an overrun."""
    out = bytearray()
    total = row_bytes * rows
    x = 0
    while len(out) < total:
        if pos >= len(data):
            raise error("TGA", "the run-length data is truncated")
        head = data[pos]
        n = depth * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + depth > len(data):
                raise error("TGA", "the run-length data is truncated")
            if x + n > row_bytes:
                raise error("TGA", "a repeat packet crosses a row's end (Pillow refuses it too)")
            out += data[pos + 1 : pos + 1 + depth] * (n // depth)
            pos += 1 + depth
        else:
            if pos + 1 + n > len(data):
                raise error("TGA", "the run-length data is truncated")
            out += data[pos + 1 : pos + 1 + n]
            pos += 1 + n
        x = (x + n) % row_bytes
    return bytes(out[:total])


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes → uint8 ``[H, W, 3]``."""
    if len(data) < 18:
        raise NotThisFormat("not a TGA file")
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    kind = image_type & 7
    if image_type in (3, 11):
        mode = "1" if depth == 1 else "LA" if depth == 16 else "L"
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    orientation = flags & 0x30
    if orientation not in (0, 0x10, 0x20, 0x30):
        raise NotThisFormat("unknown TGA orientation")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        entry = {16: 2, 24: 3, 32: 4}.get(map_depth)
        if entry is None:
            raise NotThisFormat("unknown TGA map depth")
        if entry == 4:
            raise error("TGA", "a 32-bit colour map (Pillow has no unpacker for it and refuses it too)")
        raw = data[pos : pos + entry * size]
        pos += entry * size
        raw = bytes(entry * start) + raw
        n = len(raw) // entry
        pal = np.frombuffer(raw[: n * entry], np.uint8).reshape(n, entry)
        palette = np.zeros((256, 3), np.uint8)
        rgb = _rgb15(pal[:, 0] | (pal[:, 1].astype(np.int64) << 8)) if entry == 2 else pal[:, ::-1]
        palette[: min(n, 256)] = rgb[:256]
    raw_kind = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
                (2, 32): "BGRA"}.get((kind, depth))
    if raw_kind is None or (raw_kind == "P" and mode == "L"):
        raise error("TGA", f"image type {image_type} at {depth} bits (Pillow cannot decode it either)")
    row_bytes = (width * depth + 7) // 8
    if image_type & 8 and depth == 1:
        raise error("TGA", "a run-length coded 1-bit image (Pillow cannot decode it either)")
    if image_type & 8:
        buf = _rle(data, pos, depth // 8, row_bytes, height)
    else:
        buf = data[pos : pos + row_bytes * height]
        if len(buf) < row_bytes * height:
            raise error("TGA", "the image data is truncated")
    rows = np.frombuffer(buf, np.uint8).reshape(height, row_bytes)
    if raw_kind == "1":
        px = np.unpackbits(rows, axis=1)[:, :width] * 255
        rgb = np.repeat(px[:, :, None], 3, axis=2)
    elif raw_kind in ("P", "L", "LA"):
        idx = rows.reshape(height, width, -1)[:, :, 0]
        rgb = palette[idx] if raw_kind == "P" else np.repeat(idx[:, :, None], 3, axis=2)
    elif raw_kind == "BGRA;15Z":
        v = rows.reshape(height, width, 2).astype(np.int64)
        rgb = _rgb15(v[..., 0] | (v[..., 1] << 8))
    else:
        rgb = rows.reshape(height, width, -1)[:, :, 2::-1]
    if orientation in (0, 0x10):
        rgb = rgb[::-1]
    if orientation in (0x10, 0x30):
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb, np.uint8)
