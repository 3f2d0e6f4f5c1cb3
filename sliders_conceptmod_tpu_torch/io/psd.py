"""Photoshop (PSD) decoding of the merged image in numpy and plain Python,
as ``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``PsdImagePlugin`` (the GPU machine has no PIL).

* Version 1 files; the colour-mode data (a 768-byte palette, red, green
  and blue planes, for indexed images), the image resources and the layer
  section are skipped; the merged image follows, raw or PackBits (a table
  of each row's byte count, then the channels' rows, each channel one
  PackBits stream cut into rows as ``PackBitsDecode.c`` cuts it: a packet's
  bytes past a row's end are dropped; the table is read for the channels
  Pillow uses, so extra channels shift the data as they shift it for
  Pillow).
* Pillow's modes at 8 bits: bitmap (1 bit a pixel, packed, ``1`` white as
  Pillow reads it), grey, duotone and multichannel (the first channel),
  indexed (black where no 768-byte palette is stored), RGB (a fourth
  channel is alpha, later ones are dropped) and CMYK (stored inverted, then
  ``cmyk2rgb``). Fewer channels than the mode needs, other depths and other
  compressions are refused as Pillow refuses them. Lab converts through
  LittleCMS in Pillow, which the port does not reproduce: it is refused
  citing ROADMAP item 14.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import ITEM, NotThisFormat, cmyk2rgb, error

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
          (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"8BPS"


def _packbits_rows(data: bytes, pos: int, stride: int, rows: int) -> bytes:
    out = bytearray()
    x = 0
    while len(out) < stride * rows:
        if pos >= len(data):
            raise error("PSD", "the image data is truncated")
        n = data[pos]
        if n == 0x80:
            pos += 1
            continue
        if n > 0x80:
            if pos + 2 > len(data):
                raise error("PSD", "the image data is truncated")
            chunk = data[pos + 1 : pos + 2] * (257 - n)
            pos += 2
        else:
            if pos + n + 2 > len(data):
                raise error("PSD", "the image data is truncated")
            chunk = data[pos + 1 : pos + n + 2]
            pos += n + 2
        chunk = chunk[: stride - x]
        out += chunk
        x = (x + len(chunk)) % stride
    return bytes(out)


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes → uint8 ``[H, W, 3]`` of the merged image."""
    try:
        if len(data) < 26 or not accept(data) or struct.unpack_from(">H", data, 4)[0] != 1:
            raise NotThisFormat("not a PSD file")
        channels_stored, height, width, bits, psd_mode = struct.unpack_from(">HIIHH", data, 12)
        if (psd_mode, bits) not in _MODES:
            raise NotThisFormat(f"PSD: colour mode {psd_mode} at {bits} bits")
        mode, channels = _MODES[(psd_mode, bits)]
        if channels > channels_stored:
            raise error("PSD", "not enough channels (Pillow refuses it too)")
        if mode == "RGB" and channels_stored == 4:
            channels = 4  # RGBA; its row-count table has four channels' rows, any other count three
        pos = 26
        (size,) = struct.unpack_from(">I", data, pos)
        palette = None
        if size == 768 and mode == "P":
            palette = np.frombuffer(data[pos + 4 : pos + 4 + 768], np.uint8).reshape(3, 256).T
        pos += 4 + size
        for _ in range(2):  # image resources, then layers and masks
            (size,) = struct.unpack_from(">I", data, pos)
            pos += 4 + size
        (compression,) = struct.unpack_from(">H", data, pos)
    except (IndexError, struct.error):
        raise NotThisFormat("PSD: the header is truncated") from None
    pos += 2
    if width <= 0 or height <= 0:
        raise NotThisFormat("PSD: an empty image")
    if mode == "LAB":
        raise error("PSD", f"Lab colour is not supported ({ITEM}; Pillow converts it through LittleCMS)")
    stride = (width + 7) // 8 if mode == "1" else width
    need = stride * height
    planes = []
    if compression == 0:
        for c in range(channels):
            raw = data[pos + c * width * height : pos + c * width * height + need]
            if len(raw) < need:
                raise error("PSD", "the image data is truncated")
            planes.append(np.frombuffer(raw, np.uint8).reshape(height, stride))
    elif compression == 1:
        counts = np.frombuffer(data[pos : pos + 2 * channels * height], ">u2").astype(np.int64)
        if len(counts) < channels * height:
            raise error("PSD", "the row byte counts are truncated")
        start = pos + 2 * channels * height
        for c in range(channels):
            buf = _packbits_rows(data, start, stride, height)
            planes.append(np.frombuffer(buf, np.uint8).reshape(height, stride))
            start += int(counts[c * height : (c + 1) * height].sum())
    else:
        raise error("PSD", f"compression {compression} (Pillow cannot load it either)")
    if mode == "1":
        g = np.unpackbits(planes[0], axis=1)[:, :width] * 255
        return np.repeat(g[:, :, None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if mode == "P":
        return palette[planes[0]] if palette is not None else np.zeros((height, width, 3), np.uint8)
    s = np.stack(planes[:4 if mode == "CMYK" else 3], axis=-1)
    if mode == "CMYK":
        return cmyk2rgb(255 - s.astype(np.int64))
    return np.ascontiguousarray(s)
