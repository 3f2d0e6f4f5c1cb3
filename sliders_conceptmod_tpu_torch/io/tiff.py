"""TIFF decoding (the first image file directory) in numpy and plain
Python, as ``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``TiffImagePlugin`` and its libtiff (the GPU machine has no PIL).

* Both byte orders (``II*\\0`` and ``MM\\0*``); strips and tiles (edge
  tiles cut to the image); planar configuration 1.
* Compression: none, PackBits, LZW (most significant bit first, code
  widths 9–12 switched one code early, as libtiff's ``tif_lzw.c`` reads
  it) and Deflate (8 and 32946); the horizontal predictor (2) on 8-bit
  samples under LZW and Deflate (libtiff's codecs that take one); fill
  order 2 reverses the bits of each stored byte first.
* Pixels, by Pillow's ``OPEN_INFO`` for 8 bits a sample and less: bilevel
  and 2/4/8-bit grey (``WhiteIsZero`` inverted; 2 and 4 bits scaled by 85
  and 17), grey with alpha, RGB with or without extra samples (associated
  alpha is divided out as Pillow's ``RGBa`` unpacker does:
  ``c · 255 // a``, 0 where ``a`` is 0), and 1/2/4/8-bit palettes
  (``ColorMap`` entries taken by their high byte, black past its end).

JPEG-in-TIFF, the other compressions, more than 8 bits a sample, CMYK,
separate planes and BigTIFF raise ``ValueError`` citing ROADMAP item 14.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

from sliders_conceptmod_tpu_torch.io.jpeg import ITEM

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d"}
_SIZES = {"B": 1, "s": 1, "H": 2, "I": 4, "II": 8, "b": 1, "h": 2, "i": 4, "ii": 8, "f": 4, "d": 8}
_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _error(what: str) -> ValueError:
    return ValueError(f"TIFF: {what}")


def _refuse(what: str) -> ValueError:
    return ValueError(f"TIFF: {what} is not supported ({ITEM})")


def _read_ifd(data: bytes, bo: str, offset: int) -> Dict[int, List]:
    """The first IFD's entries: tag → list of values."""
    (n,) = struct.unpack_from(bo + "H", data, offset)
    tags: Dict[int, List] = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from(bo + "HHI4s", data, offset + 2 + 12 * i)
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = _SIZES[fmt] * count
        raw = value[:size] if size <= 4 else data[struct.unpack(bo + "I", value)[0]:][:size]
        if fmt == "s":
            tags[tag] = [raw]
        elif fmt in ("II", "ii"):
            vals = struct.unpack(bo + fmt[0] * (2 * count), raw)
            tags[tag] = [vals[2 * k] / vals[2 * k + 1] if vals[2 * k + 1] else 0 for k in range(count)]
        else:
            tags[tag] = list(struct.unpack(bo + fmt * count, raw))
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
            raise _error("LZW data without a clear code first")
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise _error("an LZW code past the table")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _unpack(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """Packed rows → ``[h, width]`` samples of ``bits`` (1, 2, 4 or 8)."""
    if bits == 8:
        return rows[:, :width]
    per = 8 // bits
    shifts = (8 - bits) - bits * np.arange(per)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → uint8 ``[H, W, 3]`` of the first image."""
    if data[:4] == b"II*\0":
        bo = "<"
    elif data[:4] == b"MM\0*":
        bo = ">"
    elif data[:4] in (b"II+\0", b"MM\0+"):
        raise _refuse("BigTIFF")
    else:
        raise _error("not a TIFF file")
    tags = _read_ifd(data, bo, struct.unpack_from(bo + "I", data, 4)[0])

    def get(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    width, height = get(256), get(257)
    if not width or not height:
        raise _error("no image size")
    compression, photo = get(259, 1), get(262, 0)
    fill, planar, predictor = get(266, 1), get(284, 1), get(317, 1)
    spp = get(277, 1)
    bps = tuple(tags.get(258, [1]))
    if len(bps) == 1 and spp > 1:
        bps = bps * spp
    bps = bps[:spp]
    extra = tuple(tags.get(338, []))
    if compression in (6, 7):
        raise _refuse("JPEG-compressed TIFF")
    if compression not in (1, 5, 8, 32773, 32946):
        raise _refuse(f"TIFF compression {compression}")
    if max(bps) > 8 or len(set(bps)) > 1:
        raise _refuse(f"a TIFF of {bps} bits a sample")
    if photo not in (0, 1, 2, 3):
        raise _refuse(f"photometric interpretation {photo} (CMYK, YCbCr, Lab, ...)")
    if planar != 1 and spp > 1:
        raise _refuse("a TIFF with separate planes")
    if compression in (1, 32773):
        predictor = 1  # neither Pillow's raw reader nor libtiff's PackBits codec applies one
    if predictor not in (1, 2) or (predictor == 2 and bps[0] != 8):
        raise _refuse(f"predictor {predictor} on {bps[0]}-bit samples")
    bits = bps[0]
    if fill == 2 and compression == 1 and ((photo == 3 and bits < 8) or (photo == 0 and bits == 8)):
        raise _error(f"uncompressed, bit-reversed {bits}-bit samples of photometric {photo} (Pillow has no "
                     "unpacker for them and refuses them too)")
    if 322 in tags:
        tw, th = get(322), get(323)
        offsets, counts = tags[324], tags[325]
    else:
        tw, th = width, min(get(278, height), height)
        offsets, counts = tags[273], tags.get(279, [len(data)] * len(tags[273]))
    row_bytes = (tw * spp * bits + 7) // 8
    tiles_across = -(-width // tw)
    need = row_bytes * th
    # each tile's rows side by side, tile rows under each other
    planes = np.zeros((-(-height // th) * th, tiles_across * row_bytes), np.uint8)
    for k, (off, cnt) in enumerate(zip(offsets, counts)):
        ty, tx = divmod(k, tiles_across)
        if ty * th >= height:
            break
        raw = data[off : off + cnt]
        if fill == 2:
            raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        if compression == 1:
            buf = raw
        elif compression == 32773:
            buf = packbits_decode(raw, need)
        elif compression == 5:
            buf = lzw_decode(raw, need)
        else:
            buf = zlib.decompressobj().decompress(raw)
        tile = np.frombuffer(buf[:need].ljust(need, b"\0"), np.uint8).reshape(th, row_bytes)
        if predictor == 2:
            tile = np.cumsum(tile.reshape(th, tw, spp).astype(np.int64), axis=1).astype(np.uint8).reshape(th, -1)
        planes[ty * th : (ty + 1) * th, tx * row_bytes : (tx + 1) * row_bytes] = tile
    planes = planes[:height].reshape(height, tiles_across, row_bytes)
    s = np.concatenate([_unpack(planes[:, t], bits, tw * spp) for t in range(tiles_across)], axis=1)
    s = s[:, : width * spp].reshape(height, width, spp).astype(np.int64)
    return _to_rgb(s, photo, bits, extra, tags)


def _to_rgb(s: np.ndarray, photo: int, bits: int, extra: tuple, tags: dict) -> np.ndarray:
    """Samples ``[H, W, spp]`` → RGB by Pillow's mode and rawmode."""
    spp = s.shape[2]
    if photo in (0, 1):
        if spp != 1 + len(extra) or spp > 2:
            raise _refuse(f"grey with {spp} samples")
        g = s[..., 0]
        top = (1 << bits) - 1
        if photo == 0:
            g = top - g
        g = g * (255 // top)
        return np.repeat(g.astype(np.uint8)[:, :, None], 3, axis=2)
    if photo == 2:
        if bits != 8 or spp < 3:
            raise _refuse(f"RGB of {bits}-bit samples")
        rgb = s[..., :3]
        if spp > 3 and extra[:1] == (1,):  # associated alpha
            a = s[..., 3:4]
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.minimum(rgb * 255 // np.maximum(a, 1), 255)))
        return rgb.astype(np.uint8)
    cmap = tags.get(320)
    if cmap is None:
        raise _error("a palette image without a ColorMap")
    n = len(cmap) // 3
    pal = (np.array(cmap, np.int64).reshape(3, n).T // 256).astype(np.uint8)
    full = np.zeros((256, 3), np.uint8)
    full[: min(n, 256)] = pal[:256]
    return full[s[..., 0]]
