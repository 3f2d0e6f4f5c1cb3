"""DirectDraw Surface (DDS) decoding, as ``PIL.Image.open(p).convert("RGB")``
gives it with Pillow 12's ``DdsImagePlugin`` (the GPU machine has no PIL):
the first surface of the 124-byte header's pixel format, read in the
plugin's order of flags.

* Uncompressed RGB(A) by its masks: each pixel a little-endian word of the
  bit count's bytes, each mask's bits shifted down and scaled to 8 bits as
  ``int(v / (mask >> shift) * 255)`` in double precision; a short file
  leaves the rest black, as the plugin's reader does.
* Luminance (8 bits) and luminance with alpha (16), and 8-bit palettes (a
  1024-byte RGBA palette first), read as Pillow's raw decoder reads them.
* FourCC DXT1, DXT3, DXT5, BC4U/ATI1, BC5U/ATI2 and BC5S, and the DX10
  header's BC1–BC7 (BC6H signed and unsigned) and R8G8B8A8, through
  ``io/bcn.py``.

Other formats are refused as Pillow refuses them.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error
from sliders_conceptmod_tpu_torch.io.bcn import decode_bcn

_RGB, _ALPHAPIXELS, _FOURCC, _PALETTE8, _LUMINANCE = 0x40, 0x1, 0x4, 0x20, 0x20000
# FourCC → (BCn, pixel format, mode)
_FOURCCS = {b"DXT1": (1, "DXT1"), b"DXT3": (2, "DXT3"), b"DXT5": (3, "DXT5"), b"BC4U": (4, "BC4"),
            b"ATI1": (4, "BC4"), b"BC5S": (5, "BC5S"), b"BC5U": (5, "BC5"), b"ATI2": (5, "BC5")}
# DXGI format → (BCn, pixel format); 0 is R8G8B8A8, read raw
_DXGI = {70: (1, "BC1"), 71: (1, "BC1"), 73: (2, "BC2"), 74: (2, "BC2"), 76: (3, "BC3"), 77: (3, "BC3"),
         79: (4, "BC4"), 80: (4, "BC4"), 82: (5, "BC5"), 83: (5, "BC5"), 84: (5, "BC5S"), 95: (6, "BC6H"),
         96: (6, "BC6HS"), 97: (7, "BC7"), 98: (7, "BC7"), 99: (7, "BC7"), 27: (0, "RGBA"), 28: (0, "RGBA"),
         29: (0, "RGBA")}


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"DDS "


def _raw(data: bytes, at: int, width: int, height: int, channels: int) -> np.ndarray:
    need = width * height * channels
    if len(data) < at + need:
        raise error("DDS", "the image data is truncated (Pillow refuses it too)")
    return np.frombuffer(data, np.uint8, need, at).reshape(height, width, channels)


def _grey(g: np.ndarray) -> np.ndarray:
    return np.repeat(g[:, :, :1], 3, axis=2)


def _masked(data: bytes, width: int, height: int, bitcount: int, masks) -> np.ndarray:
    """``DdsRgbDecoder``: each pixel a ``bitcount // 8``-byte word, each mask's
    bits scaled to 8 bits; past the file's end the words are 0."""
    nbytes = bitcount // 8
    n = width * height
    raw = np.frombuffer(data[128 : 128 + n * nbytes].ljust(n * nbytes, b"\0"), np.uint8).reshape(n, nbytes)
    words = np.zeros(n, np.uint64)
    for k in range(min(nbytes, 4)):  # the masks are 32-bit
        words |= raw[:, k].astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((n, 3), np.uint8)
    for i, mask in enumerate(masks[:3]):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = (words & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = (v.astype(np.float64) / total * 255).astype(np.int64)
    return out.reshape(height, width, 3)


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes → uint8 ``[H, W, 3]`` of the first surface."""
    if not accept(data) or len(data) < 8:
        raise NotThisFormat("not a DDS file")
    (header_size,) = struct.unpack_from("<I", data, 4)
    if header_size != 124:
        raise error("DDS", f"a header of {header_size} bytes (Pillow refuses it too)")
    if len(data) < 128:
        raise error("DDS", "the header is truncated (Pillow refuses it too)")
    height, width = struct.unpack_from("<II", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    if pfflags & _RGB:
        masks = struct.unpack_from("<4I", data, 92)
        return _masked(data, width, height, bitcount, masks)
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            return _grey(_raw(data, 128, width, height, 1))
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            return _grey(_raw(data, 128, width, height, 2))
        raise error("DDS", f"luminance of {bitcount} bits (Pillow refuses it too)")
    if pfflags & _PALETTE8:
        palette = np.zeros((256, 4), np.uint8)
        entries = np.frombuffer(data[128:1152][: len(data[128:1152]) // 4 * 4], np.uint8).reshape(-1, 4)
        palette[: len(entries)] = entries
        return palette[_raw(data, 1152, width, height, 1)[:, :, 0]][:, :, :3]
    if not pfflags & _FOURCC:
        raise error("DDS", f"pixel format flags {pfflags} (Pillow refuses them too)")
    offset = 128
    if fourcc == b"DX10":
        if len(data) < 148:
            raise error("DDS", "the DX10 header is truncated (Pillow refuses it too)")
        (dxgi,) = struct.unpack_from("<I", data, 128)
        if dxgi not in _DXGI:
            raise error("DDS", f"DXGI format {dxgi} (Pillow refuses it too)")
        n, pixel_format = _DXGI[dxgi]
        offset = 148
        if n == 0:
            return _raw(data, 148, width, height, 4)[:, :, :3].copy()
    elif fourcc in _FOURCCS:
        n, pixel_format = _FOURCCS[fourcc]
    else:
        raise error("DDS", f"pixel format {fourcc!r} (Pillow refuses it too)")
    img = decode_bcn(data[offset:], width, height, n, pixel_format)
    return _grey(img) if img.shape[2] == 1 else img[:, :, :3].copy()
