"""Apple icon (ICNS) decoding, as ``PIL.Image.open(p).convert("RGB")`` gives
it with Pillow 12's ``IcnsImagePlugin`` (the GPU machine has no PIL).

* The directory: 8-byte entry headers up to the file size the header
  states; the largest size Pillow knows an entry of (its table of sizes, by
  width, height and scale) is the one opened.
* Every entry of that size is read, in the table's order: PNG entries
  through ``io/png.py`` (from the entry to the file's end), JPEG 2000
  entries (codestream or JP2) through ``io/jpeg2000.py``, legacy 24-bit
  entries either raw (three bytes a pixel) or in the plugin's run-length
  scheme (a byte below 128 copies that count plus one, any other repeats
  the next byte that count less 125), channel after channel (``it32``
  after four zero bytes), and the 8-bit masks, which are read and checked
  and then dropped with the alpha. A PNG or JPEG 2000 entry wins over a
  legacy one of the same size.
* The decoded size must be one Pillow allows for the file's sizes (an
  entry's size divided by a whole scale); the plugin refuses any other.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error
from sliders_conceptmod_tpu_torch.io.jpeg2000 import decode_jpeg2000
from sliders_conceptmod_tpu_torch.io.png import png_rgb

# IcnsFile.SIZES, in its order: (width, height, scale) → entry types
_SIZES = (((512, 512, 2), (b"ic10",)), ((512, 512, 1), (b"ic09",)), ((256, 256, 2), (b"ic14",)),
          ((256, 256, 1), (b"ic08",)), ((128, 128, 2), (b"ic13",)), ((128, 128, 1), (b"ic07", b"it32", b"t8mk")),
          ((64, 64, 1), (b"icp6",)), ((32, 32, 2), (b"ic12",)), ((48, 48, 1), (b"ih32", b"h8mk")),
          ((32, 32, 1), (b"icp5", b"il32", b"l8mk")), ((16, 16, 2), (b"ic11",)),
          ((16, 16, 1), (b"icp4", b"is32", b"s8mk")))
_LEGACY = (b"it32", b"ih32", b"il32", b"is32")
_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"icns"


def _legacy(data: bytes, start: int, length: int, w: int, h: int) -> np.ndarray:
    """``read_32``: raw interleaved RGB, or three run-length channels."""
    n = w * h
    if length == n * 3:
        raw = data[start : start + length]
        if len(raw) < length:
            raise error("ICNS", "not enough image data (Pillow refuses it too)")
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3).copy()
    out = np.zeros((3, n), np.uint8)
    pos = start
    for band in range(3):
        chunks, left = [], n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                size = b - 125
                chunks.append(data[pos : pos + 1] * size)
                pos += 1
            else:
                size = b + 1
                chunks.append(data[pos : pos + size])
                pos += size
            left -= size
        if left != 0:
            raise error("ICNS", f"a channel with {left} bytes left (Pillow refuses it too)")
        plane = b"".join(chunks)
        if len(plane) < n:
            raise error("ICNS", "not enough image data (Pillow refuses it too)")
        out[band] = np.frombuffer(plane[:n], np.uint8)
    return out.T.reshape(h, w, 3).copy()


def decode_icns(data: bytes) -> np.ndarray:
    """ICNS bytes → uint8 ``[H, W, 3]`` of the entry Pillow opens."""
    try:
        sig, filesize = struct.unpack_from(">4sI", data, 0)
        entries = {}
        i = 8
        while i < filesize:
            kind, blocksize = struct.unpack_from(">4sI", data, i)
            if blocksize <= 0:
                raise NotThisFormat("ICNS: an invalid block header")
            entries[kind] = (i + 8, blocksize - 8)
            i += blocksize
    except struct.error:
        raise NotThisFormat("ICNS: the directory is truncated") from None
    if not accept(sig):
        raise NotThisFormat("not an ICNS file")
    sizes = [size for size, kinds in _SIZES if any(k in entries for k in kinds)]
    if not sizes:
        raise NotThisFormat("ICNS: no 32-bit icon resources")
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    rgb = rgba = None
    for kind in dict(_SIZES)[best]:
        if kind not in entries:
            continue
        start, length = entries[kind]
        if kind in _MASKS:
            if len(data[start : start + w * h]) < w * h:
                raise error("ICNS", "not enough mask data (Pillow refuses it too)")
        elif kind in _LEGACY:
            if kind == b"it32":
                if data[start : start + 4] != b"\0\0\0\0":
                    raise error("ICNS", "an it32 entry without its four zero bytes (Pillow refuses it too)")
                start, length = start + 4, length - 4
            rgb = _legacy(data, start, length, w, h)
        else:
            head = data[start : start + 12]
            if head.startswith(b"\x89PNG\r\n\x1a\n"):
                decoder, entry = png_rgb, data[start:]
            elif head.startswith(_J2K) or head == b"\0\0\0\x0cjP  \x0d\x0a\x87\x0a":
                decoder, entry = decode_jpeg2000, data[start : start + length]
            else:
                raise error("ICNS", "an unsupported icon subimage format (Pillow refuses it too)")
            try:
                rgba = decoder(entry)
            except (IndexError, struct.error, zlib.error):  # the entry's readers on truncated data
                raise error("ICNS", "a truncated or corrupt PNG or JPEG 2000 entry (Pillow refuses it too)") from None
    img = rgba if rgba is not None else rgb
    if img is None:
        raise error("ICNS", "a mask without its icon (Pillow refuses it too)")
    ih, iw = img.shape[:2]
    if not any(iw and ih and s[1] * s[2] / ih == (s[0] * s[2]) // iw for s in sizes):
        raise error("ICNS", f"a {iw}x{ih} image is not one of the file's sizes (Pillow refuses it too)")
    return img
