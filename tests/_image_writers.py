"""Writers of GIF, BMP and TIFF files for the decoder tests, for the kinds
Pillow does not write: GIF frames offset on a larger screen, local and
short palettes, transparency and interlacing; BMP headers of every size,
16/32-bit and bitfields layouts, top-down rows and RLE4/RLE8 streams;
TIFF in both byte orders, with tiles, several strips, PackBits, LZW and
Deflate, the horizontal predictor, fill order 2, WhiteIsZero, 2/4-bit grey
and palettes, and associated alpha. The tests take Pillow's decode of these
files as the reference."""

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def gif_lzw(indices, min_size: int) -> bytes:
    """GIF LZW, least significant bit first, with a clear code first and
    another whenever the table fills."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def fresh():
        return {(i,): i for i in range(clear)}, end + 1, min_size + 1

    table, nxt, size = fresh()
    emit(clear, size)
    w = ()
    for k in indices:
        wk = w + (int(k),)
        if wk in table:
            w = wk
            continue
        emit(table[w], size)
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            table, nxt, size = fresh()
        w = (int(k),)
    if w:
        emit(table[w], size)
        nxt += 1
        if nxt > (1 << size) and size < 12:
            size += 1
    emit(end, size)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255)) + b"\0"


def write_gif(indices: np.ndarray, screen=None, offset=(0, 0), global_palette=None, local_palette=None,
              transparency=None, interlace: bool = False, min_size: int = 8, version: bytes = b"GIF89a") -> bytes:
    """One frame of palette ``indices`` ``[h, w]`` at ``offset`` on a screen
    (default: the frame's size); palettes ``[n, 3]`` with n a power of 2."""
    h, w = indices.shape
    sw, sh = screen or (w + offset[0], h + offset[1])

    def pal_bits(p):
        return max(int(np.log2(len(p))) - 1, 0)

    flags = 0
    if global_palette is not None:
        flags = 0x80 | 0x70 | pal_bits(global_palette)
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0)
    if global_palette is not None:
        out += np.asarray(global_palette, np.uint8).tobytes()
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    fflags = (0x40 if interlace else 0)
    if local_palette is not None:
        fflags |= 0x80 | pal_bits(local_palette)
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h, fflags)
    if local_palette is not None:
        out += np.asarray(local_palette, np.uint8).tobytes()
    rows = list(range(h))
    if interlace:
        rows = list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + list(range(1, h, 2))
    out += bytes([min_size]) + _sub_blocks(gif_lzw(indices[rows].reshape(-1), min_size))
    return out + b"\x3b"


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp_rle(idx: np.ndarray, rle4: bool, delta: bool = False) -> bytes:
    """RLE8/RLE4 of ``idx`` rows (bottom-up as stored): encoded runs of
    equal values, absolute runs of 3+ differing values, end of line and end
    of bitmap; ``delta`` puts a delta escape (0, 2, dx, dy) at the start."""
    out = bytearray()
    if delta:
        out += bytes([0, 2, 1, 0])
    for row in idx:
        row = [int(v) for v in row]
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3 or len(row) - i < 3:
                n = j - i
                out += bytes([n, (row[i] << 4) | row[i] if rle4 else row[i]])
                i = j
                continue
            j = i + 3
            while j < len(row) and j - i < 254 and row[j] != row[j - 1]:
                j += 1
            run = row[i:j]
            if rle4:
                packed = bytes((run[k] << 4) | (run[k + 1] if k + 1 < len(run) else 0) for k in range(0, len(run), 2))
                out += bytes([0, len(run)]) + packed
                if len(packed) % 2:
                    out += b"\0"
            else:
                out += bytes([0, len(run)]) + bytes(run)
                if len(run) % 2:
                    out += b"\0"
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def write_bmp(pixels: np.ndarray, bits: int, header_size: int = 40, palette=None, compression: int = 0,
              masks=None, top_down: bool = False, colors: int = 0, rle_delta: bool = False) -> bytes:
    """``pixels``: palette indices ``[h, w]`` for ``bits`` ≤ 8, else raw
    words ``[h, w]`` (16 or 32 bits) or BGR bytes ``[h, w, 3]`` (24)."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if compression in (1, 2):
        body = bmp_rle(rows, compression == 2, rle_delta)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits < 8:
            per = 8 // bits
            padded = np.zeros((h, -(-w // per) * per), np.int64)
            padded[:, :w] = rows
            grouped = padded.reshape(h, -1, per)
            packed = sum(grouped[:, :, k] << (8 - bits * (k + 1)) for k in range(per)).astype(np.uint8)
        elif bits == 8:
            packed = rows.astype(np.uint8)
        elif bits == 24:
            packed = rows.astype(np.uint8).reshape(h, -1)
        else:
            packed = rows.astype("<u2" if bits == 16 else "<u4").view(np.uint8).reshape(h, -1)
        body = b"".join(bytes(r) + b"\0" * (stride - len(bytes(r))) for r in packed)
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]  # RGB → BGR
        if header_size != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if header_size == 12:
        header = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        header = struct.pack("<IiiHHIIiiII", header_size, w, -h if top_down else h, 1, bits, compression, len(body),
                             2835, 2835, colors, 0)
        extra = b""
        if masks is not None and header_size == 40:
            pal = struct.pack("<III", *masks[:3]) + pal
        elif masks is not None:
            extra = struct.pack("<IIII", *(tuple(masks) + (0,) * (4 - len(masks))))
        header += (extra + b"\0" * header_size)[: header_size - 40]
    offset = 14 + len(header) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + header + pal + body


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def tiff_packbits(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: most significant bit first, the width switched one code
    early (libtiff's reading), a clear code before the table fills."""
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = fresh()
    emit(256, width)

    def grow():  # libtiff's LZWEncode after a new entry: clear at 4094 entries, else widen past the mask
        nonlocal table, nxt, width
        if nxt == 4094:
            emit(256, width)
            table, nxt, width = fresh()
        elif nxt > (1 << width) - 1:
            width += 1

    w = b""
    for b in data:
        wk = w + bytes([b])
        if wk in table:
            w = wk
            continue
        emit(table[w], width)
        table[wk] = nxt
        nxt += 1
        grow()
        w = bytes([b])
    if w:
        emit(table[w], width)
        nxt += 1
        grow()
    emit(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def write_tiff(samples: np.ndarray, bits: int = 8, photometric: int = 2, byte_order: str = "<", compression: int = 1,
               predictor: int = 1, rows_per_strip=None, tile=None, fill_order: int = 1, extra_samples=(),
               colormap=None) -> bytes:
    """``samples`` ``[h, w, spp]`` (values below ``1 << bits``) → TIFF.
    ``tile``: (width, length), multiples of 16; strips otherwise."""
    h, w, spp = samples.shape
    bo = byte_order
    tw, th = tile if tile else (w, rows_per_strip or h)
    pieces = []
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            block = np.zeros((th, tw, spp), np.int64)
            part = samples[ty : ty + th, tx : tx + tw]
            block[: part.shape[0], : part.shape[1]] = part
            if not tile:
                block = block[: min(th, h - ty)]
            if predictor == 2:
                block = block.copy()
                block[:, 1:] = (block[:, 1:] - block[:, :-1]) % 256
            flat = block.reshape(block.shape[0], -1)
            if bits < 8:
                per = 8 // bits
                padded = np.zeros((flat.shape[0], -(-flat.shape[1] // per) * per), np.int64)
                padded[:, : flat.shape[1]] = flat
                g = padded.reshape(flat.shape[0], -1, per)
                flat = sum(g[:, :, k] << (8 - bits * (k + 1)) for k in range(per))
            raw = flat.astype(np.uint8).tobytes()
            if compression == 32773:
                raw = tiff_packbits(raw)
            elif compression == 5:
                raw = tiff_lzw(raw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw)
            if fill_order == 2:  # the stored bytes, bit-reversed
                raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
            pieces.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [1])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    data_start = 8
    blob = b"".join(pieces)
    offsets, pos = [], data_start
    for p in pieces:
        offsets.append(pos)
        pos += len(p)
    if tile:
        entries[322], entries[323] = (3, [tw]), (3, [th])
        entries[324], entries[325] = (4, offsets), (4, [len(p) for p in pieces])
    else:
        entries[273], entries[278], entries[279] = (4, offsets), (4, [th]), (4, [len(p) for p in pieces])
    ifd_at = data_start + len(blob) + (len(blob) & 1)
    n = len(entries)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd, extra = b"", b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        fmt = "H" if typ == 3 else "I"
        payload = struct.pack(bo + fmt * len(vals), *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", extra_at + len(extra))
            extra += payload
        ifd += struct.pack(bo + "HHI", tag, typ, len(vals)) + field
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I", ifd_at)
    return (head + blob + b"\0" * (len(blob) & 1) + struct.pack(bo + "H", n) + ifd + struct.pack(bo + "I", 0)
            + extra)
