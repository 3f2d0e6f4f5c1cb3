"""BMP decoding in numpy and plain Python, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``BmpImagePlugin`` (the GPU machine has no PIL).

* Headers of 12 (OS/2: 16-bit sizes, 3-byte palette entries), 40, 52, 56,
  64, 108 and 124 bytes; rows bottom-up, or top-down where the height is
  negative; rows padded to 4 bytes.
* 1, 4 and 8 bits through the palette (its size from the header, else
  ``1 << bits``; indices past it read black), 16 bits as 5-5-5, 24 and 32
  bits as BGR(X), each 5-bit or 6-bit channel scaled by ``· 255 // 31``
  (``// 63``).
* BI_BITFIELDS with the masks Pillow accepts (a 40-byte header's three
  masks follow it; longer headers carry them, alpha from 56 bytes on).
* RLE8 and RLE4 as Pillow's ``BmpRleDecoder`` reads them, its quirks
  included: a delta escape skips two bytes before the two it reads, an
  absolute run of RLE4 reads ``n // 2`` bytes, and the pad to a 16-bit
  boundary is taken from the file's offset.
* Pillow's grey shortcut: a palette equal to the grey ramp (black and
  white for two entries) makes the image "L" (or "1"): its samples are
  the grey levels, and an uncompressed image whose depth is not 8 bits
  (1 bit) is refused, as Pillow refuses it.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import ITEM, error

_BITFIELDS = {  # (bits, masks) → the channel order of Pillow's rawmode
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _u16(b, o):
    return struct.unpack_from("<H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from("<I", b, o)[0]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """``BmpRleDecoder.decode``: the indices, rows in file order, zeros
    where the stream ends early."""
    out = bytearray()
    x = 0
    total = width * height
    while len(out) < total:
        if pos + 2 > len(data):
            break
        n, byte = data[pos], data[pos + 1]
        pos += 2
        if n:  # an encoded run
            n = min(n, max(0, width - x)) if x + n > width else n
            if rle4:
                out += bytes((byte >> 4) if i % 2 == 0 else (byte & 15) for i in range(n))
            else:
                out += bytes([byte]) * n
            x += n
        elif byte == 0:  # end of line
            out += b"\0" * (-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta (Pillow reads two bytes past the pair it skips)
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                break
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += b"\0" * (right + up * width)
            x = len(out) % width
        else:  # absolute run
            count = byte // 2 if rle4 else byte
            chunk = data[pos : pos + count]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < count:
                break
            x += byte
            pos += pos % 2  # to a 16-bit boundary of the file
    out = bytes(out[:total]) + b"\0" * max(0, total - len(out))
    return np.frombuffer(out, np.uint8).reshape(height, width)


def _unpack_bits(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """Packed rows (most significant first) → ``[h, width]`` values."""
    if bits == 8:
        return rows[:, :width]
    per = 8 // bits
    shifts = (8 - bits) - bits * np.arange(per)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → uint8 ``[H, W, 3]``."""
    if data[:2] != b"BM" or len(data) < 26:
        raise error("BMP", "not a BMP file")
    return decode_bitmap(data, 14, _u32(data, 10))


def decode_bitmap(data: bytes, at: int, offset: int = 0, halve: bool = False) -> np.ndarray:
    """The bitmap whose info header starts at ``at``: its pixels at
    ``offset``, or (``offset`` 0, a DIB) right after its header, masks and
    palette. ``halve``: an icon's or cursor's DIB, whose stored height
    counts its AND mask too, read at half that height."""
    header_size = _u32(data, at)
    h = data[at + 4 : at + header_size]
    pos = at + header_size
    top_down = False
    masks = None
    if header_size == 12:
        width, height, bits = _u16(h, 0), _u16(h, 2), _u16(h, 6)
        compression, colors, entry = 0, 0, 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        width = _u32(h, 0)
        top_down = h[7] == 0xFF
        height = 2**32 - _u32(h, 4) if top_down else _u32(h, 4)
        bits, compression, colors, entry = _u16(h, 10), _u32(h, 12), _u32(h, 28), 4
        if compression == 3:
            if len(h) >= 48:
                masks = tuple(_u32(h, 36 + 4 * i) for i in range(4 if len(h) >= 52 else 3))
                masks += (0,) * (4 - len(masks))
            else:
                masks = tuple(_u32(data, pos + 4 * i) for i in range(3)) + (0,)
                pos += 12
    else:
        raise error("BMP", f"a header of {header_size} bytes ({ITEM})")
    colors = colors or (1 << bits)
    if halve:
        height //= 2
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors  # Pillow's reading of an offset that leaves out the palette
    if bits not in (1, 4, 8, 16, 24, 32):
        raise error("BMP", f"{bits} bits a pixel ({ITEM})")
    if compression not in (0, 1, 2, 3):
        raise error("BMP", f"compression {compression} ({ITEM})")
    rawmode = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}[bits]
    if compression == 3:
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in _BITFIELDS:
            raise error("BMP", f"a bitfields layout Pillow refuses too: {bits} bits, masks {masks}")
        rawmode = _BITFIELDS[key]
    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise error("BMP", f"a palette of {colors} entries")
        raw = np.frombuffer(data[pos : pos + entry * colors].ljust(entry * colors, b"\0"), np.uint8)
        pos += entry * colors
        pal = raw.reshape(colors, entry)[:, 2::-1]  # BGR(X) → RGB
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(tuple(pal[i]) == (v, v, v) for i, v in enumerate(ramp)):
            rawmode = "1" if colors == 2 else "L"
            if compression == 0 and bits != (1 if colors == 2 else 8):
                raise error("BMP", f"a {bits}-bit image with a {colors}-entry grey-ramp palette "
                                   "(Pillow refuses it too)")
        else:
            palette = np.zeros((256, 3), np.uint8)
            palette[: min(colors, 256)] = pal[:256]
    offset = offset or pos
    if compression in (1, 2):
        if bits > 8:
            raise error("BMP", "run-length coding of a direct-colour image")
        idx = _rle(data, offset, width, height, compression == 2)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * height
        raw = np.frombuffer(data[offset : offset + need].ljust(need, b"\0"), np.uint8).reshape(height, stride)
        idx = None
    if idx is None and rawmode in ("P;1", "P;4", "P", "1", "L"):
        unit = {"P;1": 1, "P;4": 4, "P": 8, "1": 1, "L": 8}[rawmode]
        idx = _unpack_bits(raw, unit, width)
    if idx is not None:
        if not top_down:
            idx = idx[::-1]
        if rawmode == "1" and compression == 0:
            return np.repeat((idx * 255).astype(np.uint8)[:, :, None], 3, axis=2)
        if palette is None:  # "L", or "1" from a run-length stream (its bytes taken as grey)
            return np.repeat(idx.astype(np.uint8)[:, :, None], 3, axis=2)
        return palette[idx]
    px = raw[:, : width * (bits // 8)].reshape(height, width, bits // 8).astype(np.int64)
    if not top_down:
        px = px[::-1]
    if bits == 16:
        v = px[..., 0] | (px[..., 1] << 8)
        if rawmode == "BGR;16":
            r, g, b = ((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63, (v & 31) * 255 // 31
        else:
            r, g, b = ((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.uint8)
    order = rawmode[: bits // 8]
    return np.stack([px[..., order.index(c)] for c in "RGB"], -1).astype(np.uint8)
