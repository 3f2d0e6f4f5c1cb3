"""Writers of GIF, BMP and TIFF files for the decoder tests, for the kinds
Pillow does not write: GIF frames offset on a larger screen, local and
short palettes, transparency and interlacing; BMP headers of every size,
16/32-bit and bitfields layouts, top-down rows and RLE4/RLE8 streams;
TIFF in both byte orders, with tiles, several strips, PackBits, LZW and
Deflate, the horizontal predictor, fill order 2, WhiteIsZero, 2/4-bit grey
and palettes, and associated alpha. The tests take Pillow's decode of these
files as the reference."""

import lzma
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
               colormap=None, planar: int = 1, bigtiff: bool = False, sample_format=None, pieces=None,
               extra_tags=None) -> bytes:
    """``samples`` ``[h, w, spp]`` (values below ``1 << bits``; floats for
    ``sample_format`` 3) → TIFF. ``tile``: (width, length), multiples of 16;
    strips otherwise. ``planar`` 2 stores each sample in planes of its own.
    ``pieces``: the strips or tiles already coded (JPEG), in place of
    ``samples``'. ``extra_tags``: tag → (type, values)."""
    h, w, spp = samples.shape
    bo = byte_order
    tw, th = tile if tile else (w, rows_per_strip or h)
    planes = [samples[:, :, k : k + 1] for k in range(spp)] if planar == 2 else [samples]
    dtype = {8: np.uint8, 16: np.uint16, 32: np.float32 if sample_format == 3 else np.uint32}.get(bits)
    if pieces is None:
        pieces = []
        for plane in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), samples.dtype)
                    part = plane[ty : ty + th, tx : tx + tw]
                    block[: part.shape[0], : part.shape[1]] = part
                    if not tile:
                        block = block[: min(th, h - ty)]
                    if predictor == 2:
                        block = block.astype(np.int64)
                        block[:, 1:] = (block[:, 1:] - block[:, :-1]) % (1 << bits)
                    flat = block.reshape(block.shape[0], -1)
                    if bits < 8:
                        per = 8 // bits
                        padded = np.zeros((flat.shape[0], -(-flat.shape[1] // per) * per), np.int64)
                        padded[:, : flat.shape[1]] = flat
                        g = padded.reshape(flat.shape[0], -1, per)
                        raw = sum(g[:, :, k] << (8 - bits * (k + 1)) for k in range(per)).astype(np.uint8).tobytes()
                    else:
                        raw = flat.astype(np.dtype(dtype).newbyteorder(bo)).tobytes()
                    if compression == 32773:
                        raw = tiff_packbits(raw)
                    elif compression == 5:
                        raw = tiff_lzw(raw)
                    elif compression in (8, 32946):
                        raw = zlib.compress(raw)
                    elif compression == 34925:
                        raw = lzma.compress(raw)
                    if fill_order == 2:  # the stored bytes, bit-reversed
                        raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                    pieces.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    entries.update(extra_tags or {})
    off_type, off_fmt, word = (16, "Q", 8) if bigtiff else (4, "I", 4)
    data_start = 16 if bigtiff else 8
    blob = b"".join(pieces)
    offsets, pos = [], data_start
    for p in pieces:
        offsets.append(pos)
        pos += len(p)
    if tile:
        entries[322], entries[323] = (3, [tw]), (3, [th])
        entries[324], entries[325] = (off_type, offsets), (4, [len(p) for p in pieces])
    else:
        entries[273], entries[278], entries[279] = (off_type, offsets), (4, [th]), (4, [len(p) for p in pieces])
    ifd_at = data_start + len(blob) + (len(blob) & 1)
    n = len(entries)
    entry_size = 20 if bigtiff else 12
    count_fmt = "Q" if bigtiff else "H"
    extra_at = ifd_at + struct.calcsize(count_fmt) + entry_size * n + word
    ifd, extra = b"", b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        fmt = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}[typ]
        payload = vals if isinstance(vals, bytes) else struct.pack(bo + fmt * len(vals), *vals)
        count = len(payload) if isinstance(vals, bytes) else len(vals)
        if len(payload) <= word:
            field = payload.ljust(word, b"\0")
        else:
            field = struct.pack(bo + off_fmt, extra_at + len(extra))
            extra += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack(bo + "HH" + off_fmt, tag, typ, count) + field
    if bigtiff:
        head = (b"II+\0" if bo == "<" else b"MM\0+") + struct.pack(bo + "HHQ", 8, 0, ifd_at)
    else:
        head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I", ifd_at)
    return (head + blob + b"\0" * (len(blob) & 1) + struct.pack(bo + count_fmt, n)
            + ifd + struct.pack(bo + off_fmt, 0) + extra)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


def tga_rle(pixels: list, rows: int, cross_rows: bool) -> bytes:
    """Run-length packets over the pixels (``bytes`` each), across row ends
    or within each row."""
    out = bytearray()
    lines = [pixels] if cross_rows else [pixels[i * (len(pixels) // rows):(i + 1) * (len(pixels) // rows)]
                                         for i in range(rows)]
    for line in lines:
        i = 0
        while i < len(line):
            j = i + 1
            while j < len(line) and j - i < 128 and line[j] == line[i]:
                j += 1
            if j - i >= 2:
                out += bytes([0x80 | (j - i - 1)]) + line[i]
                i = j
                continue
            j = i + 1
            while j < len(line) and j - i < 128 and (j + 1 >= len(line) or line[j] != line[j + 1]):
                j += 1
            out += bytes([j - i - 1]) + b"".join(line[i:j])
            i = j
    return bytes(out)


def write_tga(pixels: np.ndarray, image_type: int, depth: int, colormap=None, map_depth: int = 24,
              map_start: int = 0, top: bool = False, mirror: bool = False, cross_rows: bool = True,
              id_field: bytes = b"") -> bytes:
    """``pixels``: ``[h, w]`` indices, grey or 16-bit words, or ``[h, w, c]``
    RGB(A) or grey+alpha. ``colormap``: ``[n, 3]`` RGB, or ``[n]`` 16-bit
    words for a 15/16-bit map. Types 9–11 are run-length coded."""
    px = np.asarray(pixels, np.int64)
    h, w = px.shape[:2]
    rows = px if top else px[::-1]
    if mirror:
        rows = rows[:, ::-1]
    if depth == 1:
        packed = np.packbits(rows.astype(np.uint8), axis=1)
        body = packed.tobytes()
        flat = None
    elif depth == 16 and px.ndim == 2:
        flat = [struct.pack("<H", int(v)) for v in rows.reshape(-1)]
    elif px.ndim == 3 and px.shape[2] >= 3:
        flat = [bytes([int(p[2]), int(p[1]), int(p[0])] + [int(v) for v in p[3:]]) for p in rows.reshape(h * w, -1)]
    else:
        flat = [bytes(int(v) for v in np.atleast_1d(p)) for p in rows.reshape(h * w, -1)]
    if flat is not None:
        body = tga_rle(flat, h, cross_rows) if image_type & 8 else b"".join(flat)
    cmap = b""
    if colormap is not None:
        cm = np.asarray(colormap, np.int64)
        if map_depth in (15, 16):
            cmap = b"".join(struct.pack("<H", int(v)) for v in cm)
        else:
            cmap = b"".join(bytes([int(c[2]), int(c[1]), int(c[0])] + [255] * (map_depth == 32)) for c in cm)
    n = 0 if colormap is None else len(colormap)
    flags = (0x20 if top else 0) | (0x10 if mirror else 0) | (8 if depth == 32 or (depth == 16 and px.ndim == 3) else 0)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(colormap is not None), image_type, map_start if n else 0, n,
                       map_depth if n else 0, 0, 0, w, h, depth, flags)
    return head + id_field + cmap + body


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------


def write_psd(channels: np.ndarray, psd_mode: int, bits: int = 8, compression: int = 0, palette=None,
              resources: bytes = b"", layers: bytes = b"") -> bytes:
    """``channels`` ``[c, h, w]`` (1-bit: 0/1 per pixel) → a PSD whose merged
    image holds them, raw (0) or PackBits per row (1). ``palette``: ``[256,
    3]`` for indexed mode."""
    ch = np.asarray(channels, np.int64)
    c, h, w = ch.shape
    rows = []
    for k in range(c):
        for y in range(h):
            r = ch[k, y]
            rows.append(np.packbits(r.astype(np.uint8)).tobytes() if bits == 1 else r.astype(np.uint8).tobytes())
    if compression == 1:
        packed = [tiff_packbits(r) for r in rows]
        body = b"".join(struct.pack(">H", len(p)) for p in packed) + b"".join(packed)
    else:
        body = b"".join(rows)
    mode_data = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, psd_mode)
    sections = b"".join(struct.pack(">I", len(s)) + s for s in (mode_data, resources, layers))
    return head + sections + struct.pack(">H", compression) + body


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------


def icon_dib(pixels: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """A DIB of an icon entry: ``write_bmp``'s bitmap without its file header,
    its height doubled, the AND mask's rows (1 bit a pixel, 32-bit aligned)
    after the pixels."""
    bmp = write_bmp(pixels, bits, 40, palette=palette)
    h, w = np.asarray(pixels).shape[:2]
    dib = bytearray(bmp[14:])
    struct.pack_into("<i", dib, 8, 2 * h)
    m = np.zeros((h, -(-w // 32) * 32), np.uint8)
    if mask is not None:
        m[:, :w] = mask
    return bytes(dib) + np.packbits(m[::-1], axis=1).tobytes()


def write_icon(entries, cursor: bool = False) -> bytes:
    """``entries``: ``(payload, width, height, colours, bpp)``, payload a DIB
    (``icon_dib``) or a PNG file. A cursor's planes/bpp fields hold its hot
    spot (``bpp`` is written as given)."""
    head = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    offset = 6 + 16 * len(entries)
    directory, blobs = b"", b""
    for payload, w, h, colours, bpp in entries:
        directory += struct.pack("<BBBBHHII", w % 256, h % 256, colours % 256, 0, 1, bpp, len(payload), offset)
        blobs += payload
        offset += len(payload)
    return head + directory + blobs


def jpeg_tiff(image: np.ndarray, photometric: int = 6, sampling=((2, 2), (1, 1), (1, 1)), rows_per_strip=None,
              tile=None, abbreviated: bool = True, byte_order: str = "<") -> bytes:
    """A JPEG-compressed TIFF (compression 7) of ``image`` ``[h, w, c]``:
    each strip or tile its own JPEG stream, written by ``_jpeg_writer`` in
    YCbCr (photometric 6, ``YCbCrSubsampling`` from ``sampling``) or with
    its components as they are (``ycc`` off: RGB, grey, CMYK); with
    ``abbreviated``, the tables go once into ``JPEGTables`` and each stream
    carries none."""
    from _jpeg_writer import write_jpeg

    h, w, c = image.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    pieces, tables = [], None
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            block = np.zeros((th, tw, c), np.uint8)
            part = image[ty : ty + th, tx : tx + tw]
            block[: part.shape[0], : part.shape[1]] = part
            if not tile:
                block = block[: min(th, h - ty)]
            stream = write_jpeg(block if c > 1 else block[:, :, 0], sampling[:c] if c > 1 else ((1, 1),),
                                ids=tuple(range(1, c + 1)), jfif=False, ycc=photometric == 6)
            if abbreviated:  # DQT before SOF, DHT between SOF and SOS in the writer's streams
                sof, dht, sos = (stream.index(m) for m in (b"\xff\xc0", b"\xff\xc4", b"\xff\xda"))
                if tables is None:
                    tables = stream[:sof] + stream[dht:sos] + b"\xff\xd9"
                stream = b"\xff\xd8" + stream[sof:dht] + stream[sos:]
            pieces.append(stream)
    extra = {530: (3, [sampling[0][0], sampling[0][1]])} if photometric == 6 else {}
    if tables is not None:
        extra[347] = (7, tables)
    return write_tiff(image, 8, photometric, byte_order, 7, rows_per_strip=rows_per_strip, tile=tile,
                      pieces=pieces, extra_tags=extra)


# ---------------------------------------------------------------------------
# JPEG 2000
# ---------------------------------------------------------------------------


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_wrap(codestream: bytes, nc: int, bpc: int, height: int, width: int, enumcs=16, icc: bytes = None,
             palette=None) -> bytes:
    """A JP2 file around ``codestream``: ``colr`` by enumeration
    (``enumcs``) or an ICC profile (``icc``); ``palette`` ``[n, 3]`` adds
    ``pclr`` and ``cmap`` boxes mapping component 0 through it."""
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc - 1, 7, 0, 0))
    colr = _box(b"colr", b"\x02\x00\x00" + icc if icc is not None else struct.pack(">BBBI", 1, 0, 0, enumcs))
    boxes = ihdr + colr
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        boxes += _box(b"pclr", struct.pack(">HB", len(pal), 3) + bytes([7, 7, 7]) + pal.tobytes())
        boxes += _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(3)))
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + _box(b"jp2h", boxes)
            + _box(b"jp2c", codestream))
