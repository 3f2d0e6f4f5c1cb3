"""TIFF decoding (the first image file directory) in numpy and plain
Python, as ``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``TiffImagePlugin`` and its libtiff 4.7 (the GPU machine has no PIL).

* Headers: both byte orders, and BigTIFF (``II+\\0``: 8-byte counts and
  offsets). Pillow takes a big-endian BigTIFF (``MM\\0+``) for a classic
  file and fails on it, so it is not identified; neither is any file whose
  tags Pillow's ``OPEN_INFO`` has no mode for.
* Strips and tiles (edge tiles cut to the image); planar configuration 1,
  and 2 (each sample in planes of its own).
* Uncompressed data goes through Pillow's own raw decoder, the rest
  through libtiff's codecs: PackBits, LZW (most significant bit first,
  code widths 9–12 switched one code early, as ``tif_lzw.c`` reads it),
  Deflate (8 and 32946), LZMA (34925, the standard library's ``lzma``),
  ZSTD (50000, ``io/zstd.py``: a strip's first frame, which must hold the
  strip), CCITT modified Huffman, T.4 and T.6 (2, 3 and 4,
  ``io/ccitt.py``; bilevel only) and JPEG (7: each strip or tile a JPEG
  stream, the ``JPEGTables`` stream read before it, decoded by
  ``io/jpeg.py``; YCbCr converted to RGB by libjpeg as libtiff's
  ``JPEGCOLORMODE_RGB`` asks, any other photometric passed through as
  libtiff's unknown colour space passes it). The horizontal predictor (2)
  on 8, 16 and 32-bit samples; fill order 2 reverses the bits of each
  stored byte first.
* YCbCr under any codec but JPEG goes, as Pillow sends it, through
  libtiff's RGBA interface: ``YCbCrSubsampling`` 1×1, 1×2, 2×1, 2×2, 4×1,
  4×2 and 4×4 (each data unit's chroma replicated over its pixels; 1×1 in
  separate planes too), ``YCbCrCoefficients`` and ``ReferenceBlackWhite``
  through ``TIFFYCbCrToRGBInit``'s single-precision tables and
  ``TIFFYCbCrtoRGB``'s clamping; ``YCbCrPositioning`` is read by nobody.
  Uncompressed YCbCr goes through Pillow's raw reader, 4 bytes a pixel and
  no conversion, as Pillow reads it (so a file Pillow writes is refused as
  truncated, as Pillow refuses it).
* Pixels, by Pillow's ``OPEN_INFO`` (mode, rawmode): bilevel and 2/4/8-bit
  grey (``WhiteIsZero`` inverted; 2 and 4 bits scaled by 85 and 17), 12,
  16 and 32-bit grey (modes ``I;16``, ``I`` and ``F``, which
  ``convert("RGB")`` clips at 255, not scales; a 16-bit ``WhiteIsZero`` is
  read as ``BlackIsZero``, as Pillow reads it), grey with alpha, RGB and
  CMYK at 8 and 16 bits (16-bit samples by their high byte) with extra
  samples (associated alpha is divided out as Pillow's ``RGBa`` unpacker
  does: ``c · 255 // a``, 0 where ``a`` is 0), CMYK by ``cmyk2rgb``, and
  1/2/4/8-bit palettes (``ColorMap`` entries taken by their high byte,
  black past its end).

Refused citing ROADMAP item 14: old-style JPEG (6) and the other codecs
libtiff has that Pillow cannot write here, Lab (converted through
LittleCMS), the predictor on subsampled YCbCr and planar uncompressed data
of more than 8 bits a sample. WebP-compressed TIFF is refused as Pillow
refuses it (its libtiff is built without WebP).
"""

from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict, List

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, cmyk2rgb, error, refuse
from sliders_conceptmod_tpu_torch.io.ccitt import decode_ccitt
from sliders_conceptmod_tpu_torch.io.jpeg import jpeg_planes, ycc_to_rgb
from sliders_conceptmod_tpu_torch.io.zstd import decode_zstd

_PREFIXES = (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+", b"II+\0")
_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I", 16: "Q"}
_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# Pillow's COMPRESSION_INFO: what it names (anything else is not identified)
_COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                 8: "tiff_adobe_deflate", 32771: "tiff_raw_16", 32773: "packbits", 32809: "tiff_thunderscan",
                 32946: "tiff_deflate", 34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                 50001: "webp"}


def accept(prefix: bytes) -> bool:
    return prefix[:4] in _PREFIXES


def _read_ifd(data: bytes, bo: str, offset: int, big: bool) -> Dict[int, List]:
    """The first IFD's entries as Pillow's ``ImageFileDirectory_v2.load``
    reads them: tag → list of values; a truncated directory keeps the
    entries read before its end."""
    tags: Dict[int, List] = {}
    word = 8 if big else 4
    try:
        (n,) = struct.unpack_from(bo + ("Q" if big else "H"), data, offset)
        pos = offset + (8 if big else 2)
        for _ in range(n):
            tag, typ, count, value = struct.unpack_from(bo + ("HHQ8s" if big else "HHI4s"), data, pos)
            pos += 20 if big else 12
            fmt = _TYPES.get(typ)
            if fmt is None:
                continue
            size = struct.calcsize(fmt) * count
            if size > word:
                at = struct.unpack(bo + ("Q" if big else "I"), value)[0]
                raw = data[at : at + size]
            else:
                raw = value[:size]
            if len(raw) != size or not raw:
                continue
            if fmt == "s":
                tags[tag] = [raw]
            elif fmt in ("II", "ii"):
                vals = struct.unpack(bo + fmt[0] * (2 * count), raw)
                tags[tag] = [vals[2 * k] / vals[2 * k + 1] if vals[2 * k + 1] else 0 for k in range(count)]
            else:
                tags[tag] = list(struct.unpack(bo + fmt * count, raw))
    except struct.error:
        pass
    return tags


def packbits_decode(data: bytes, size: int) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos : pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += bytes([data[pos]]) * (257 - n) if pos < len(data) else b""
            pos += 1
    return bytes(out)


def lzw_decode(data: bytes, size: int) -> bytes:
    """TIFF LZW: codes most significant bit first, 256 clears, 257 ends, the
    width grows when the next code would reach 511, 1023 and 2047."""
    a = np.frombuffer(bytes(data) + b"\0" * 4, np.uint8).astype(np.int64)
    win = ((a[:-3] << 16) | (a[1:-2] << 8) | a[2:-1]).tolist()  # 24 bits from each byte on
    nbits = len(data) * 8
    table: List[bytes] = []
    out = bytearray()
    bitpos, width, prev = 0, 9, None
    while bitpos + width <= nbits and len(out) < size:
        code = (win[bitpos >> 3] >> (24 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == 256:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if not table:
            raise error("TIFF", "LZW data without a clear code first")
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise error("TIFF", "an LZW code past the table")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


# Pillow 12.1's TiffImagePlugin.OPEN_INFO: (photometric, sample format, fill order, bits, extra samples)
# → (mode, rawmode): the entries both byte orders share, then each order's own
_OPEN_INFO = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"), (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"), (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"), (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"), (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"), (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"), (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"), (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"), (1, (2,), 1, (8,), ()): ("L", "L"), (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"), (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"), (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"), (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"), (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"), (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"), (3, (1,), 1, (1,), ()): ("P", "P;1"),
    (3, (1,), 2, (1,), ()): ("P", "P;1R"), (3, (1,), 1, (2,), ()): ("P", "P;2"),
    (3, (1,), 2, (2,), ()): ("P", "P;2R"), (3, (1,), 1, (4,), ()): ("P", "P;4"),
    (3, (1,), 2, (4,), ()): ("P", "P;4R"), (3, (1,), 1, (8,), ()): ("P", "P"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"), (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (3, (1,), 2, (8,), ()): ("P", "P;R"), (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"), (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"), (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB")
}
_OPEN_INFO_II = {
    (1, (1,), 1, (12,), ()): ("I;16", "I;12"), (0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (1, (1,), 1, (16,), ()): ("I;16", "I;16"), (1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (1, (2,), 1, (16,), ()): ("I", "I;16S"), (0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (1, (1,), 1, (32,), ()): ("I", "I;32N"), (1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (1, (3,), 1, (32,), ()): ("F", "F;32F"), (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16L"),
    (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"),
    (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
    (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"),
    (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
    (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L")
}
_OPEN_INFO_MM = {
    (1, (1,), 1, (16,), ()): ("I;16B", "I;16B"), (1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (0, (3,), 1, (32,), ()): ("F", "F;32BF"), (1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (1, (3,), 1, (32,), ()): ("F", "F;32BF"), (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16B"),
    (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16B"),
    (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16B"),
    (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16B"),
    (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16B"),
    (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16B")
}


def _open_info(bo: str, photo: int, fmt: tuple, fill: int, bps: tuple, extra: tuple):
    key = (photo, fmt, fill, bps, extra)
    return _OPEN_INFO.get(key) or (_OPEN_INFO_II if bo == "<" else _OPEN_INFO_MM).get(key)


def _unpack(rows: np.ndarray, bits: int, count: int, bo: str, fmt: int) -> np.ndarray:
    """Packed rows ``[h, bytes]`` → ``[h, count]`` samples of ``bits``."""
    if bits < 8:
        per = 8 // bits
        shifts = (8 - bits) - bits * np.arange(per)
        vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
        return vals.reshape(rows.shape[0], -1)[:, :count].astype(np.int64)
    if bits == 8:
        return rows[:, :count].astype(np.int64)
    if bits == 12:  # I;12: pairs of samples in three bytes, high bits first
        r = rows[:, : (count * 3 + 1) // 2].astype(np.int64)
        r = np.pad(r, ((0, 0), (0, (-r.shape[1]) % 3)))
        t = r.reshape(r.shape[0], -1, 3)
        v = np.stack([(t[..., 0] << 4) | (t[..., 1] >> 4), ((t[..., 1] & 15) << 8) | t[..., 2]], -1)
        return v.reshape(r.shape[0], -1)[:, :count]
    dt = {(16, 1): "u2", (16, 2): "i2", (32, 1): "i4", (32, 2): "i4", (32, 3): "f4"}[(bits, fmt)]
    v = rows[:, : count * bits // 8].copy().view(np.dtype(bo + dt))
    return v if dt == "f4" else v.astype(np.int64)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → uint8 ``[H, W, 3]`` of the first image."""
    if not accept(data):
        raise NotThisFormat("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43
    first = struct.unpack_from(bo + ("Q" if big else "I"), data, 8 if big else 4)[0]
    tags = _read_ifd(data, bo, first, big)

    def get(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    compression = get(259, 1)
    if compression not in _COMPRESSIONS:
        raise NotThisFormat(f"TIFF: compression {compression} is unknown to Pillow")
    planar, photo, fill, predictor = get(284, 1), get(262, 0), get(266, 1), get(317, 1)
    if compression == 6:
        photo = 6
    width, height = get(256), get(257)
    if width is None or height is None:
        raise NotThisFormat("TIFF: no image size")
    fmt = tuple(tags.get(339, [1]))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tuple(tags.get(258, [1]))
    extra = tuple(tags.get(338, []))
    count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    spp = get(277, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise NotThisFormat("TIFF: unknown data organization")
    raw_path = compression == 1
    info = _open_info(bo, photo, fmt, fill if raw_path else 1, bps, extra)
    if info is None:
        raise NotThisFormat(f"TIFF: no Pillow mode for photometric {photo}, {bps} bits, extra samples {extra}")
    if width <= 0 or height <= 0:
        raise NotThisFormat("TIFF: an empty image")
    mode, rawmode = info
    if compression in (2, 3, 4) and (bps != (1,) or photo not in (0, 1)):
        raise error("TIFF", f"CCITT compression of {bps}-bit samples, photometric {photo} (libtiff refuses it)")
    if compression == 50001:
        raise error("TIFF", "WebP compression (Pillow refuses it too: its libtiff is built without WebP)")
    if compression not in (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000):
        raise refuse("TIFF", f"{_COMPRESSIONS[compression]} compression")
    if mode == "LAB":
        raise refuse("TIFF", "Lab colour (Pillow converts it through LittleCMS)")
    ycbcr = photo == 6 and compression != 7 and not raw_path  # libtiff's RGBA interface converts it
    if ycbcr and (bps != (8, 8, 8) or extra):
        raise error("TIFF", f"YCbCr of {bps}-bit samples (libtiff's RGBA interface refuses it, and Pillow too)")
    bits = bps[0]
    if fill == 2 and raw_path and ((photo == 3 and bits < 8) or (photo == 0 and bits == 8)):
        raise error("TIFF", f"uncompressed, bit-reversed {bits}-bit samples of photometric {photo} (Pillow has no "
                            "unpacker for them and refuses it too)")
    if raw_path:
        predictor = 1  # Pillow's raw reader applies none
    if predictor not in (1, 2) or (predictor == 2 and fmt == (3,)):
        raise refuse("TIFF", f"predictor {predictor} on {'floating-point' if fmt == (3,) else 'integer'} samples")
    if 322 in tags:
        tw, th = get(322), get(323)
        offsets, counts = tags.get(324, []), tags.get(325, [])
    else:
        tw, th = width, min(get(278, height), height)
        offsets = tags.get(273)
        if offsets is None:
            raise NotThisFormat("TIFF: unknown data organization")
        counts = tags.get(279, [len(data)] * len(offsets))
    separate = planar == 2 and spp > 1
    if compression == 7:
        rgb, samples = _jpeg_image(data, tags, photo, width, height, tw, th, offsets, counts, separate, spp)
        return rgb if rgb is not None else _to_rgb(samples, mode, rawmode, bits, tags)
    sub = tuple(tags.get(530, [2, 2])[:2]) if ycbcr else (1, 1)
    if ycbcr and (sub not in _SUBSAMPLINGS or (separate and sub != (1, 1))):
        raise error("TIFF", f"YCbCr subsampled {sub[0]}x{sub[1]}{' in separate planes' if separate else ''} "
                            "(libtiff's RGBA interface refuses it, and Pillow too)")
    if ycbcr and predictor == 2 and sub != (1, 1):
        raise refuse("TIFF", "the predictor on subsampled YCbCr")
    if raw_path:
        if photo == 6 and planar != 2 and spp == 3:  # Pillow's raw reader takes 4 bytes a pixel ("RGBX")
            bps = (8, 8, 8, 8)
        samples = _raw_samples(data, bo, mode, rawmode, width, height, tw, th, offsets, planar, bps, count, fill)
        if planar == 2:  # one-band unpackers: 8-bit samples (1-bit for mode "1"), no inversion
            return _to_rgb(samples, mode, mode, 1 if mode == "1" else 8, tags)
        return _to_rgb(samples, mode, rawmode, bits, tags)
    if separate and spp > 4 and 322 not in tags:
        raise error("TIFF", f"{spp} separate planes (Pillow's libtiff decoder refuses them too)")
    if predictor == 2 and bits < 8 and compression != 32773:
        raise error("TIFF", f"the predictor on {bits}-bit samples (libtiff refuses it, and Pillow too)")
    per_plane = 1 if separate else spp
    row_bytes = (tw * bits * per_plane + 7) // 8
    across, down = -(-width // tw), -(-height // th)
    if sub != (1, 1):
        return _ycbcr_subsampled(data, tags, compression, fill, width, height, tw, th, offsets, counts, sub)
    samples = np.zeros((height, width, spp), np.float32 if fmt == (3,) else np.int64)
    for plane in range(spp if separate else 1):
        for ty in range(down):
            for tx in range(across):
                k = plane * across * down + ty * across + tx
                if k >= len(offsets):
                    raise error("TIFF", "fewer strips or tiles than the image needs")
                raw = data[offsets[k] : offsets[k] + (counts[k] if k < len(counts) else 0)]
                rows_here = th if 322 in tags else min(th, height - ty * th)
                need = row_bytes * rows_here
                buf = _decompress(raw, compression, fill, need, tw, rows_here, get(292, 0))
                tile = np.frombuffer(buf, np.uint8).reshape(rows_here, row_bytes)
                vals = _unpack(tile, bits, tw * per_plane, bo, fmt[0]).reshape(rows_here, tw, per_plane)
                if predictor == 2 and compression != 32773:  # libtiff's PackBits codec takes no predictor
                    vals = np.cumsum(vals, axis=1) % (1 << bits)
                    if fmt == (2,):
                        vals = np.where(vals >= 1 << (bits - 1), vals - (1 << bits), vals)
                y0, x0 = ty * th, tx * tw
                part = vals[: height - y0, : width - x0]
                if separate:
                    samples[y0 : y0 + part.shape[0], x0 : x0 + part.shape[1], plane] = part[:, :, 0]
                else:
                    samples[y0 : y0 + part.shape[0], x0 : x0 + part.shape[1]] = part
    if rawmode in ("I;16BS", "I;32BS", "F;32BF"):
        # Pillow renames only the ";16B"/";16L" rawmodes to native order for
        # libtiff, whose output is native (little-endian): these are read
        # byte-swapped
        kind = {"I;16BS": "<i2", "I;32BS": "<i4", "F;32BF": "<f4"}[rawmode]
        samples = samples.astype(kind).view(">" + kind[1:]).astype(samples.dtype)
    if ycbcr:
        return _ycbcr_to_rgb(tags, samples[..., 0], samples[..., 1], samples[..., 2])
    return _to_rgb(samples, mode, rawmode, bits, tags)


def _decompress(raw: bytes, compression: int, fill: int, need: int, width: int, rows: int, t4options: int) -> bytes:
    """A strip's or tile's stored bytes → ``need`` bytes of samples (cut, or
    padded with zeros)."""
    if fill == 2:
        raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    if compression == 32773:
        buf = packbits_decode(raw, need)
    elif compression == 5:
        buf = lzw_decode(raw, need)
    elif compression in (2, 3, 4):
        buf = decode_ccitt(raw, width, rows, compression, t4options)
    elif compression == 50000:  # libtiff reads one frame a strip and fails where it falls short
        buf = decode_zstd(raw)
        if len(buf) < need:
            raise error("TIFF", f"a ZSTD strip {need - len(buf)} bytes short (libtiff refuses it, and Pillow too)")
    else:  # LZMA and Deflate stop, as libtiff's codecs do, once the strip is full
        try:
            if compression == 34925:
                buf = lzma.LZMADecompressor().decompress(raw, need)
            else:
                buf = zlib.decompressobj().decompress(raw, need)
        except (lzma.LZMAError, zlib.error) as e:
            raise error("TIFF", f"corrupt {_COMPRESSIONS[compression]} data ({e})") from None
    return buf[:need].ljust(need, b"\0")


# the subsamplings libtiff's RGBA interface has a routine for (4×4, 4×2, 4×1, 2×2, 2×1, 1×2, 1×1), and the
# bytes a unit each routine skips past a tile's right edge by (4×4's routine takes 4×2's 10, not 18)
_SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
_SKEW_UNIT = {(4, 4): 10, (4, 2): 10, (4, 1): 6, (2, 2): 6, (2, 1): 4, (1, 2): 4, (1, 1): 3}


def _ycbcr_tables(tags: dict):
    """``tif_color.c::TIFFYCbCrToRGBInit`` in its single precision: the
    tables indexed by Y, Cb and Cr that ``TIFFYCbCrtoRGB`` sums, from
    ``YCbCrCoefficients`` and ``ReferenceBlackWhite`` (libtiff's defaults
    0.299/0.587/0.114 and 0, 255, 128, 255, 128, 255)."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, [0.299, 0.587, 0.114])[:3]]
    rbw = [f32(v) for v in tags.get(532, [0, 255, 128, 255, 128, 255])[:6]]
    if len(luma) < 3 or len(rbw) < 6 or any(np.isnan(luma)) or abs(luma[1]) < 1e-10:
        raise error("TIFF", "invalid YCbCrCoefficients (libtiff refuses them, and Pillow too)")
    if not all(f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in rbw):
        raise error("TIFF", "invalid ReferenceBlackWhite values (libtiff refuses them, and Pillow too)")
    lr, lg, lb = luma

    def fix(v):
        return int(float(f32(min(max(v, f32(0)), f32(2))) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2, d3, d4 = fix(f1), -fix(lr * f1 / lg), fix(f3), -fix(lb * f3 / lg)
    x = np.arange(-128, 128)

    def code2v(c, rb, rw, cr):
        den = rw - rb
        v = (c - int(rb)).astype(f32) * f32(cr) / (den if den != 0 else f32(1))
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)

    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    y = code2v(x + 128, rbw[0], rbw[1], 255)
    return y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768


def _ycbcr_to_rgb(tags: dict, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` on 8-bit samples, each result clamped to 0–255."""
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(tags)
    y, cb, cr = (np.asarray(v, np.int64) for v in (y, cb, cr))
    r = y_tab[y] + cr_r[cr]
    g = y_tab[y] + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y_tab[y] + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _ycbcr_subsampled(data, tags, compression, fill, width, height, tw, th, offsets, counts, sub):
    """Subsampled YCbCr strips or tiles as libtiff's RGBA interface puts them
    (``putcontig8bitYCbCr{44,42,41,22,21,12}tile``): data units of h × v Y
    samples (row by row), then Cb and Cr, each pixel of a unit converted
    with the unit's chroma; units past the image's edge are cut. A strip is
    read as ``gtStripContig`` reads it: its rows rounded up to whole units,
    times ``TIFFScanlineSize``, a unit row's bytes divided by v and rounded
    down, so 4 × 4 units an odd number across lose their strip's last two
    bytes a unit row to the zeros of libtiff's buffer. In a tile that
    overhangs the image's right edge, each unit row after the first starts
    where the put routine's skip leaves it (``_SKEW_UNIT``)."""
    h, v = sub
    across, down = -(-width // tw), -(-height // th)
    y = np.zeros((height, width), np.int64)
    cb = np.zeros_like(y)
    cr = np.zeros_like(y)
    t4 = tags.get(292, [0])[0]
    for ty in range(down):
        for tx in range(across):
            k = ty * across + tx
            if k >= len(offsets):
                raise error("TIFF", "fewer strips or tiles than the image needs")
            rows_here = th if 322 in tags else min(th, height - ty * th)
            ur, uc = -(-rows_here // v), -(-tw // h)
            unit = h * v + 2
            need = ur * uc * unit
            read = need if 322 in tags else ur * v * (uc * unit // v)
            raw = data[offsets[k] : offsets[k] + (counts[k] if k < len(counts) else 0)]
            buf = np.frombuffer(_decompress(raw, compression, fill, read, tw, rows_here, t4).ljust(need, b"\0"),
                                np.uint8)
            npix = min(tw, width - tx * tw)
            used = -(-npix // h)
            skew = (tw - npix) // h * _SKEW_UNIT[sub]  # the put routine's own skip past the tile's right edge
            at = (np.arange(ur)[:, None] * (used * unit + skew) + np.arange(used)[None, :] * unit)[..., None]
            units = np.zeros((ur, uc, unit), np.int64)
            units[:, :used] = buf[np.minimum(at + np.arange(unit), need - 1)]
            luma = units[:, :, : h * v].reshape(ur, uc, v, h).transpose(0, 2, 1, 3).reshape(ur * v, uc * h)
            chroma = [np.repeat(np.repeat(units[:, :, h * v + i], v, 0), h, 1) for i in (0, 1)]
            y0, x0 = ty * th, tx * tw
            rows, cols = min(rows_here, height - y0), min(tw, width - x0)
            for plane, src in ((y, luma), (cb, chroma[0]), (cr, chroma[1])):
                plane[y0 : y0 + rows, x0 : x0 + cols] = src[:rows, :cols]
    return _ycbcr_to_rgb(tags, y, cb, cr)


_BAND_BITS = {"R": 8, "G": 8, "B": 8, "A": 8, "C": 8, "M": 8, "Y": 8, "K": 8, "L": 8, "P": 8, "I": 32, "F": 32, "1": 1}
_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "L": "L", "P": "P", "I": "I", "F": "F", "1": "1"}


def _raw_samples(data, bo, mode, rawmode, width, height, tw, th, offsets, planar, bps, count, fill):
    """Pillow's own raw decoder over its tile list: each strip or tile read
    from its offset to the end of its rows (the byte counts are not read),
    rows of the tile's width where it overhangs the image's right edge; with
    separate planes each plane goes through the one-band unpacker of the
    rawmode's character at the plane's index, as Pillow picks it."""
    spp = len(bps)
    out = np.zeros((height, width, max(spp, len(_BANDS.get(mode, "")))), np.float64 if mode == "F" else np.int64)
    if tw == width and th == height and planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    for offset in offsets:
        stride = tw * sum(bps) / 8 if x + tw > width else 0
        tile_raw = rawmode
        if planar == 2:
            if layer >= len(rawmode):
                raise NotThisFormat("TIFF: more planes than the rawmode has bands")
            tile_raw = rawmode[layer]
            stride /= count
            if tile_raw not in _BANDS.get(mode, "") or tile_raw not in _BAND_BITS:
                raise error("TIFF", f"unknown raw mode {tile_raw!r} for a plane of mode {mode} (Pillow refuses it too)")
        xs, ys = min(x + tw, width) - x, min(y + th, height) - y
        pixel_bits = _BAND_BITS[tile_raw] if planar == 2 else sum(bps)
        row = (xs * pixel_bits + 7) // 8
        step = int(stride) or row
        if step < row:
            raise error("TIFF", "a strip narrower than its rows (Pillow refuses it too)")
        need = step * (ys - 1) + row
        raw = data[offset : offset + need]
        if len(raw) < need:
            raise error("TIFF", "the image data is truncated")
        raw = np.frombuffer(raw + b"\0" * (step - row), np.uint8).reshape(ys, step)[:, :row]
        if fill == 2:
            raw = _BIT_REVERSE[raw]
        if planar == 2:
            band = _BANDS[mode].index(tile_raw)
            if tile_raw in "IF":
                vals = raw.copy().view("<i4" if tile_raw == "I" else "<f4")
            else:
                vals = _unpack(raw, _BAND_BITS[tile_raw], xs, "<", 1)
            out[y : y + ys, x : x + xs, band] = vals[:, :xs]
        else:
            bits = bps[0]
            fmt = 3 if mode == "F" else 2 if rawmode in ("I;16S", "I;16BS", "I;32S", "I;32BS") else 1
            vals = _unpack(raw, bits, xs * spp, bo, fmt)
            out[y : y + ys, x : x + xs, :spp] = vals.reshape(ys, xs, spp)
        x += tw
        if x >= width:
            x, y = 0, y + th
            if y >= height:
                y, layer = 0, layer + 1
    return out


def _jpeg_image(data, tags, photo, width, height, tw, th, offsets, counts, separate, spp):
    """JPEG-compressed strips or tiles, each a JPEG stream read after the
    ``JPEGTables`` stream: (RGB, None) for YCbCr, which libjpeg converts, or
    (None, samples) for any other photometric, whose components libjpeg
    passes through."""
    tables = tags.get(347, [b""])[0]
    if isinstance(tables, int):
        tables = bytes(tags[347])
    across, down = -(-width // tw), -(-height // th)
    ycc = photo == 6 and not separate
    out = np.zeros((height, width, 3 if ycc else spp), np.int64)
    for plane in range(spp if separate else 1):
        for ty in range(down):
            for tx in range(across):
                k = plane * across * down + ty * across + tx
                if k >= min(len(offsets), len(counts)):
                    raise error("TIFF", "fewer strips or tiles than the image needs")
                comps = jpeg_planes(data[offsets[k] : offsets[k] + counts[k]], tables)
                if ycc:
                    px = ycc_to_rgb(*comps[:3])
                elif photo == 6 or any(c.shape != comps[0].shape for c in comps):
                    raise refuse("TIFF", f"JPEG-compressed photometric {photo} in separate or subsampled components")
                else:
                    px = np.stack(comps, -1)
                y0, x0 = ty * th, tx * tw
                part = px[: min(th, height - y0), : min(tw, width - x0)]
                sl = (slice(y0, y0 + part.shape[0]), slice(x0, x0 + part.shape[1]))
                if separate:
                    out[sl + (plane,)] = part[..., 0]
                else:
                    out[sl] = part[..., : out.shape[2]]
    return (out.astype(np.uint8), None) if ycc else (None, out)


def _to_rgb(s: np.ndarray, mode: str, rawmode: str, bits: int, tags: dict) -> np.ndarray:
    """Samples ``[H, W, spp]`` → RGB by Pillow's mode and rawmode."""
    if mode in ("1", "L", "LA"):
        g = s[..., 0]
        top = (1 << bits) - 1
        if "I" in rawmode.partition(";")[2]:
            g = top - g
        g = g * (255 // top) if bits < 8 else g
        return np.repeat(g.astype(np.uint8)[:, :, None], 3, axis=2)
    if mode in ("I;16", "I;16B", "I"):
        g = s[..., 0]
        if rawmode == "I;32N":
            g = g.astype(np.uint32).view(np.int32).astype(np.int64)
        return np.repeat(np.clip(g, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)
    if mode == "F":
        v = s[..., 0]
        with np.errstate(invalid="ignore"):
            g = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.where(v > 0, v, 0)), 0)).astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    if bits == 16:
        s = s >> 8
    if mode in ("P", "PA"):
        cmap = tags.get(320)
        if cmap is None:
            raise error("TIFF", "a palette image without a ColorMap")
        n = len(cmap) // 3
        pal = (np.array(cmap, np.int64).reshape(3, n).T // 256).astype(np.uint8)
        full = np.zeros((256, 3), np.uint8)
        full[: min(n, 256)] = pal[:256]
        return full[s[..., 0]]
    if mode == "CMYK":
        return cmyk2rgb(s[..., :4])
    rgb = s[..., :3]
    if rawmode.startswith("RGBa"):  # associated alpha
        a = s[..., 3:4]
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.minimum(rgb * 255 // np.maximum(a, 1), 255)))
    return rgb.astype(np.uint8)
