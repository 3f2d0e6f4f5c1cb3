"""Writers of image files for the decoder tests, for the kinds Pillow does
not write: GIF frames offset on a larger screen, local and short palettes,
transparency and interlacing; BMP headers of every size, 16/32-bit and
bitfields layouts, top-down rows and RLE4/RLE8 streams; TIFF in both byte
orders, with tiles, several strips, PackBits, LZW, Deflate and ZSTD, the
horizontal predictor, fill order 2, WhiteIsZero, 2/4-bit grey and palettes,
associated alpha, CCITT fax rows (T.4 with 2-D coding and fill bits, T.6)
and subsampled YCbCr data units; TGA, PSD, ICO/CUR and JP2 boxes; PCX bit
planes and DCX, SGI run-length rows, DDS headers of every pixel format
(BC4, BC6H, BC7 and masks included), FTEX, BLP (JPEG and DXT) and ICNS
(legacy run-length and mask entries). The tests take Pillow's decode of
these files as the reference."""

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
                    elif compression == 50000:
                        import zstandard

                        raw = zstandard.ZstdCompressor(level=9).compress(raw)
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
        fmt = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}[typ]  # 5: rationals as (num, den) pairs
        payload = vals if isinstance(vals, bytes) else struct.pack(bo + fmt * len(vals), *vals)
        count = len(payload) if isinstance(vals, bytes) else len(vals) // (2 if typ == 5 else 1)
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


# ---------------------------------------------------------------------------
# TIFF: CCITT fax rows, subsampled YCbCr
# ---------------------------------------------------------------------------

# T.4's codes, as the decoder under test has them: the tests pin them against Pillow's writer separately
from sliders_conceptmod_tpu_torch.io.ccitt import BLACK_CODES, EXTENDED_CODES, MODE_CODES, WHITE_CODES  # noqa: E402


def _fax_run(run: int, black: bool) -> str:
    codes = BLACK_CODES if black else WHITE_CODES
    out = ""
    while run >= 2624:
        out += EXTENDED_CODES[2560]
        run -= 2560
    if run >= 64:
        make = run & ~63
        out += EXTENDED_CODES[make] if make > 1728 else codes[make]
        run -= make
    return out + codes[run]


def _fax_changes(row: np.ndarray) -> list:
    """Positions where a row of 0/1 (1 black) changes colour, white before it."""
    prev = np.concatenate([[0], row[:-1]])
    return [int(i) for i in np.flatnonzero(row != prev)]


def _fax_1d(row: np.ndarray) -> str:
    w = len(row)
    edges = _fax_changes(row) + [w]
    out, a0, black = "", 0, False
    for e in edges:
        out += _fax_run(e - a0, black)
        a0, black = e, not black
        if e == w:
            break
    return out


def _fax_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """T.4's two-dimensional coding of ``row`` against ``ref``."""
    w = len(row)
    cur = _fax_changes(row) + [w, w]
    above = _fax_changes(ref) + [w, w]
    out, a0, colour, start = "", 0, 0, True

    def first(changes, pos, parity=None):
        for i, c in enumerate(changes):
            if (c > pos or (start and c >= pos)) and (parity is None or i % 2 == parity or c >= w):
                return i
        return len(changes) - 1

    while a0 < w:
        ia1 = first(cur, a0)
        a1 = cur[ia1]
        ib1 = first(above, a0, colour)
        b1 = above[ib1]
        b2 = above[min(ib1 + 1, len(above) - 1)]
        if b2 < a1:
            out += MODE_CODES["P"]
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += MODE_CODES[a1 - b1]
            a0, colour = a1, colour ^ 1
        else:
            a2 = cur[ia1 + 1]
            out += MODE_CODES["H"] + _fax_run(a1 - a0, bool(colour)) + _fax_run(a2 - a1, not colour)
            a0 = a2
        start = False
    return out


def fax_strip(bits: np.ndarray, compression: int, t4options: int = 0, k: int = 2, fill_order: int = 1,
              rtc: bool = False) -> bytes:
    """Rows of 0/1 (1 black) → one strip of compression 2 (rows byte-aligned),
    3 (T.4: an EOL before every row; with ``t4options`` bit 0, a tag bit
    after it and every ``k``-th row one-dimensional, the rest coded against
    the row above; bit 2, fill bits so each EOL ends on a byte) or 4 (T.6).
    ``rtc`` ends a T.4 strip with six EOLs (T.6: an EOFB)."""
    h, w = bits.shape
    out = ""
    ref = np.zeros(w, np.int64)
    eol = "000000000001"
    for y in range(h):
        row = bits[y].astype(np.int64)
        if compression == 2:
            out += _fax_1d(row)
            out += "0" * (-len(out) % 8)
        elif compression == 3:
            if t4options & 4:
                out += "0" * ((4 - len(out)) % 8)  # the EOL's 12 bits end on a byte
            out += eol
            one_d = not t4options & 1 or y % k == 0
            if t4options & 1:
                out += "1" if one_d else "0"
            out += _fax_1d(row) if one_d else _fax_2d(row, ref)
        else:
            out += _fax_2d(row, ref)
        ref = row
    if rtc:
        out += (eol + ("1" if t4options & 1 else "")) * 6 if compression == 3 else eol * 2
    out += "0" * (-len(out) % 8)
    data = bytes(int(out[i : i + 8], 2) for i in range(0, len(out), 8))
    if fill_order == 2:
        data = bytes(int(f"{b:08b}"[::-1], 2) for b in data)
    return data


def fax_tiff(bits: np.ndarray, compression: int, photometric: int = 0, rows_per_strip=None, fill_order: int = 1,
             byte_order: str = "<", **kw) -> bytes:
    """A bilevel TIFF whose strips ``fax_strip`` codes (``T4Options`` from
    ``t4options``)."""
    h, w = bits.shape
    rps = rows_per_strip or h
    pieces = [fax_strip(bits[y : y + rps], compression, fill_order=fill_order, **kw) for y in range(0, h, rps)]
    extra = {292: (4, [kw.get("t4options", 0)])} if compression == 3 else {}
    return write_tiff(np.zeros((h, w, 1), np.int64), 1, photometric, byte_order, compression, rows_per_strip=rps,
                      fill_order=fill_order, pieces=pieces, extra_tags=extra)


def ycbcr_units(ycc: np.ndarray, sub, rows: int, cols: int) -> bytes:
    """A strip or tile ``[rows, cols]`` of Y, Cb, Cr as TIFF's data units:
    h × v Y samples, then the unit's Cb and Cr (taken at its first pixel);
    ``ycc`` is padded by edge copies to whole units."""
    h, v = sub
    ur, uc = -(-rows // v), -(-cols // h)
    pad = np.pad(ycc, ((0, ur * v - ycc.shape[0]), (0, uc * h - ycc.shape[1]), (0, 0)), mode="edge")
    blocks = pad.reshape(ur, v, uc, h, 3).transpose(0, 2, 1, 3, 4)
    luma = blocks[..., 0].reshape(ur, uc, v * h)
    chroma = blocks[:, :, 0, 0, 1:]
    return np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()


def ycbcr_tiff(ycc: np.ndarray, sub=(2, 2), compression: int = 8, rows_per_strip=None, tile=None,
               byte_order: str = "<", extra_tags=None) -> bytes:
    """A YCbCr TIFF (photometric 6) of ``ycc`` ``[h, w, 3]`` at ``sub``
    subsampling, each strip or tile compressed by Deflate (8), LZW (5),
    PackBits (32773), LZMA (34925) or ZSTD (50000)."""
    h, w, _ = ycc.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    pieces = []
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            part = ycc[ty : ty + th, tx : tx + tw]
            rows = th if tile else part.shape[0]
            raw = ycbcr_units(part, sub, rows, tw)
            if compression == 8:
                raw = zlib.compress(raw)
            elif compression == 5:
                raw = tiff_lzw(raw)
            elif compression == 32773:
                raw = tiff_packbits(raw)
            elif compression == 34925:
                raw = lzma.compress(raw)
            elif compression == 50000:
                import zstandard

                raw = zstandard.ZstdCompressor().compress(raw)
            pieces.append(raw)
    extra = {530: (3, list(sub))}
    extra.update(extra_tags or {})
    return write_tiff(ycc, 8, 6, byte_order, compression, rows_per_strip=rows_per_strip, tile=tile, pieces=pieces,
                      extra_tags=extra)


# ---------------------------------------------------------------------------
# PCX, DCX, SGI
# ---------------------------------------------------------------------------


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX run-length rows: runs of up to 63 within a row, single bytes of
    192 and above escaped as runs of one."""
    out = bytearray()
    for row in rows:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 63:
                n += 1
            if n > 1 or row[x] >= 0xC0:
                out += bytes([0xC0 | n, row[x]])
            else:
                out.append(row[x])
            x += n
    return bytes(out)


def write_pcx(rows: np.ndarray, width: int, bits: int, planes: int, version: int = 5, stride=None,
              palette16=None, palette256=None, origin=(0, 0)) -> bytes:
    """A PCX of ``rows`` ``[h, planes * stride]`` bytes as stored; the
    header's stride is ``stride`` (default: the rows' own)."""
    h = rows.shape[0]
    stored = rows.shape[1] // planes
    head = bytearray(128)
    x0, y0 = origin
    struct.pack_into("<BBBBHHHHHH", head, 0, 10, version, 1, bits, x0, y0, x0 + width - 1, y0 + h - 1, 72, 72)
    if palette16 is not None:
        head[16:64] = np.asarray(palette16, np.uint8).reshape(-1)[:48].tobytes().ljust(48, b"\0")
    head[65] = planes
    struct.pack_into("<HH", head, 66, stride if stride is not None else stored, 1)
    tail = b"" if palette256 is None else b"\x0c" + np.asarray(palette256, np.uint8).tobytes()
    return bytes(head) + pcx_rle(rows.astype(np.uint8)) + tail


def pcx_planes(index: np.ndarray, planes: int, stride: int) -> np.ndarray:
    """Palette indices ``[h, w]`` → ``planes`` 1-bit planes of ``stride``
    bytes a row (bit k of an index in plane k)."""
    h, w = index.shape
    out = np.zeros((h, planes * stride), np.uint8)
    for k in range(planes):
        bits = np.zeros((h, stride * 8), np.uint8)
        bits[:, :w] = (index >> k) & 1
        out[:, k * stride : (k + 1) * stride] = np.packbits(bits, axis=1)
    return out


def write_dcx(frames) -> bytes:
    """A DCX directory over PCX ``frames``."""
    head = struct.pack("<I", 0x3ADE68B1)
    offset = 4 + 4 * (len(frames) + 1)
    table = b""
    for f in frames:
        table += struct.pack("<I", offset)
        offset += len(f)
    return head + table + b"\0\0\0\0" + b"".join(frames)


def write_sgi(planes: np.ndarray, bpc: int = 1, rle: bool = True, dimension=None) -> bytes:
    """``planes`` ``[z, h, w]`` (top row first) → an SGI file, its rows
    stored bottom up, run-length coded (``rle``: literal and repeat runs of
    up to 127, each row ending in a zero count) or raw."""
    z, h, w = planes.shape
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHH", 474, 1 if rle else 0, bpc, dim, w, h, z).ljust(512, b"\0")
    fmt = ">u2" if bpc == 2 else "u1"
    flipped = planes[:, ::-1]
    if not rle:
        return head + flipped.astype(fmt).tobytes()
    rows, starts, lengths = [], [], []
    pos = 512 + 8 * z * h
    for k in range(z):
        for y in range(h):
            row = flipped[k, y].astype(np.int64)
            code = []
            x = 0
            while x < w:
                n = 1
                while x + n < w and row[x + n] == row[x] and n < 127:
                    n += 1
                if n >= 3:
                    code += [n, int(row[x])]
                    x += n
                    continue
                m = 1
                while x + m < w and m < 127 and not (x + m + 2 < w and row[x + m] == row[x + m + 1] == row[x + m + 2]):
                    m += 1
                code += [0x80 | m] + [int(v) for v in row[x : x + m]]
                x += m
            code.append(0)
            blob = np.array(code, fmt).tobytes()
            rows.append(blob)
            starts.append(pos)
            lengths.append(len(blob))
            pos += len(blob)
    tables = struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths)
    return head + tables + b"".join(rows)


# ---------------------------------------------------------------------------
# DDS, FTEX, BLP
# ---------------------------------------------------------------------------

DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "BC5S": 84, "BC6H": 95, "BC6HS": 96, "BC7": 98,
        "RGBA": 28}


def write_dds(width: int, height: int, payload: bytes, fourcc: bytes = b"", dxgi=None, pfflags: int = 0,
              bitcount: int = 0, masks=(0, 0, 0, 0), palette=None) -> bytes:
    """A DDS header and ``payload``: a FourCC (``fourcc``), the DX10 header
    of ``dxgi`` (a ``DXGI`` name), or ``pfflags`` with ``bitcount`` and
    ``masks`` (uncompressed, luminance, or a 256-entry RGBA ``palette``)."""
    if dxgi is not None:
        fourcc = b"DX10"
    flags = 0x4 if fourcc else pfflags
    head = struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 0) + b"\0" * 44
    head += struct.pack("<II4sI", 32, flags, fourcc.ljust(4, b"\0") if fourcc else b"\0" * 4, bitcount)
    head += struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    out = b"DDS " + head
    if dxgi is not None:
        out += struct.pack("<5I", DXGI[dxgi], 3, 0, 1, 0)
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    return out + payload


def write_ftex(width: int, height: int, payload: bytes, kind: int) -> bytes:
    """An FTEX file of one format (0 DXT1, 1 uncompressed) and one mipmap."""
    head = b"FTEX" + struct.pack("<6i", 1, width, height, 1, 1, kind) + struct.pack("<i", 32)
    return head + struct.pack("<i", len(payload)) + payload


def write_blp(version: int, width: int, height: int, mip: bytes, compression: int = 1, encoding: int = 1,
              alpha: int = 0, alpha_encoding: int = 0, palette=None, jpeg_header: bytes = None) -> bytes:
    """A BLP1 or BLP2 file whose first mipmap is ``mip``: after a 256-entry
    BGRA ``palette`` (zeros by default), or after BLP1's shared
    ``jpeg_header``."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, width, height, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0, width, height)
    if jpeg_header is not None:
        middle = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        middle = np.zeros((256, 4), np.uint8).tobytes() if palette is None else np.asarray(palette, np.uint8).tobytes()
    offset = len(head) + 128 + len(middle)
    return (head + struct.pack("<16I", offset, *([0] * 15)) + struct.pack("<16I", len(mip), *([0] * 15)) + middle
            + mip)


def split_jpeg(stream: bytes):
    """A JPEG stream → (its markers up to the scan, the scan and EOI), as
    BLP1 keeps a header shared by its mipmaps."""
    sos = stream.index(b"\xff\xda")
    return stream[:sos], stream[sos:]


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------


def icns_rle(channel: np.ndarray) -> bytes:
    """The ICNS run-length scheme: a byte below 128 copies that count plus
    one, 128 + n − 3 repeats the next byte n times (3 ≤ n ≤ 130)."""
    data = channel.astype(np.uint8).reshape(-1).tolist()
    out, x = bytearray(), 0
    while x < len(data):
        n = 1
        while x + n < len(data) and data[x + n] == data[x] and n < 130:
            n += 1
        if n >= 3:
            out += bytes([n + 125, data[x]])
            x += n
            continue
        m = 1
        while x + m < len(data) and m < 128 and not (x + m + 2 < len(data) and data[x + m] == data[x + m + 1]
                                                     == data[x + m + 2]):
            m += 1
        out += bytes([m - 1]) + bytes(data[x : x + m])
        x += m
    return bytes(out)


def write_icns(entries) -> bytes:
    """``entries``: (type, payload) in file order."""
    body = b"".join(kind + struct.pack(">I", 8 + len(p)) + p for kind, p in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body
