"""WebP lossless (VP8L) decoding in numpy and plain Python, as libwebp's
``vp8l_dec.c`` decodes it (the format of RFC 9649, section 3 onwards).

A VP8L stream is an ARGB image behind up to four transforms. The decoder
reads, in order:

* the header: signature ``0x2f``, 14-bit width − 1 and height − 1, the alpha
  hint and a 3-bit version (0);
* the transforms, each at most once: predictor, cross-colour, subtract-green
  and colour indexing (a palette, with 2, 4 or 8 pixels bundled into one
  where it has 16 entries or fewer). Predictor and cross-colour carry a
  sub-image of per-tile data; colour indexing a palette image whose entries
  are coded as deltas;
* the colour cache (1–11 bits) and the prefix codes: one group of five
  canonical codes (green + lengths + cache, red, blue, alpha, distance), or a
  meta prefix image that picks a group per tile. A code is "simple" (one or
  two symbols of 1 or 8 bits) or given by code lengths, themselves coded by a
  19-symbol code with the repeat codes 16 (previous length), 17 and 18
  (zeros);
* the pixels: literals, LZ77 backward references whose distance code maps
  through the 120-entry neighbourhood table, and colour-cache hits.

The transforms are then undone in reverse order of their appearance. The
entropy decoding and the predictor are sequential per pixel: they run in
plain Python over packed 32-bit ARGB integers; the predictor's modes that do
not read the left pixel, cross-colour, subtract-green and colour indexing
run on whole rows or the whole image in numpy. :func:`decode_vp8l` returns
the ARGB words; RGB is taken from them.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import ITEM, error

NUM_LITERAL_CODES, NUM_LENGTH_CODES, NUM_DISTANCE_CODES = 256, 24, 40
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the (dx, dy) of distance codes 1..120 (RFC 9649, section 4.2.2): distance = dx + dy · width, at least 1
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
)
assert len(DISTANCE_MAP) == 120
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
BLACK = 0xFF000000


class BitReader:
    """Least-significant-bit-first reader over the stream; ``win[i]`` holds
    the 32 bits from byte ``i`` on."""

    def __init__(self, data: bytes):
        a = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.int64)
        self.win = (a[:-4] | (a[1:-3] << 8) | (a[2:-2] << 16) | (a[3:-1] << 24)).tolist()
        self.nbits = len(data) * 8
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > self.nbits:
            raise error("WebP lossless", "the stream is truncated")


Code = Tuple[List[int], int]  # (table of symbol << 4 | length, mask of the bits it is indexed by)


def build_code(lengths: List[int]) -> Code:
    """Canonical prefix code from code lengths, as ``huffman_utils.c`` builds
    it: codes in order of length, then symbol; read most significant bit
    first from the least-significant-bit-first stream. One used symbol costs
    zero bits."""
    used = [(n, s) for s, n in enumerate(lengths) if n]
    if not used:
        raise error("WebP lossless", "a prefix code with no symbol")
    if len(used) == 1:
        return [used[0][1] << 4], 0
    maxlen = max(n for n, _ in used)
    table = np.zeros(1 << maxlen, np.int64)
    code = 0
    for n in range(1, maxlen + 1):
        for s in sorted(s for m, s in used if m == n):
            rev = int(f"{code:0{n}b}"[::-1], 2)
            table[rev :: 1 << n] = (s << 4) | n
            code += 1
        code <<= 1
    if code != 1 << (maxlen + 1):
        raise error("WebP lossless", "a prefix code that is not complete")
    return table.tolist(), (1 << maxlen) - 1


def _read_symbol(br: BitReader, code: Code) -> int:
    table, mask = code
    p = br.pos
    e = table[(br.win[p >> 3] >> (p & 7)) & mask]
    br.pos = p + (e & 15)
    return e >> 4


def _read_code(br: BitReader, alphabet: int) -> Code:
    lengths = [0] * alphabet
    if br.read(1):  # simple code: one or two symbols
        num = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        if first >= alphabet:
            raise error("WebP lossless", "a simple code's symbol is past its alphabet")
        lengths[first] = 1
        if num == 2:
            second = br.read(8)
            if second >= alphabet:
                raise error("WebP lossless", "a simple code's symbol is past its alphabet")
            lengths[second] = 1
        return build_code(lengths)
    num_codes = br.read(4) + 4
    cl_lengths = [0] * 19
    for i in range(num_codes):
        cl_lengths[CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = build_code(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise error("WebP lossless", "more code lengths than symbols")
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        n = _read_symbol(br, cl_code)
        if n < 16:
            lengths[symbol] = n
            symbol += 1
            if n:
                prev = n
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise error("WebP lossless", "a repeat code runs past the alphabet")
        fill = prev if n == 16 else 0
        lengths[symbol : symbol + repeat] = [fill] * repeat
        symbol += repeat
    return build_code(lengths)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _prefix_value(br: BitReader, symbol: int) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _decode_stream(br: BitReader, width: int, height: int, top_level: bool) -> np.ndarray:
    """``DecodeImageStream`` without transforms: cache, codes, pixels →
    uint32 ``[height, width]``."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise error("WebP lossless", f"colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if top_level and br.read(1):
        meta_bits = br.read(3) + 2
        mw, mh = _subsample(width, meta_bits), _subsample(height, meta_bits)
        meta = ((_decode_stream(br, mw, mh, False) >> 8) & 0xFFFF).astype(np.int64)
    num_groups = int(meta.max()) + 1 if meta is not None else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    alphabets = (NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size, 256, 256, 256, NUM_DISTANCE_CODES)
    groups = [[_read_code(br, a) for a in alphabets] for _ in range(num_groups)]
    br.check()
    out = _decode_pixels(br, width, height, groups, meta, meta_bits, cache_bits)
    br.check()
    return out


def _decode_pixels(br: BitReader, width: int, height: int, groups, meta, meta_bits: int,
                   cache_bits: int) -> np.ndarray:
    """``DecodeImageData``: literals, backward references and cache hits,
    each pixel inserted into the cache in order."""
    total = width * height
    out = [0] * total
    win, pos, nbits = br.win, br.pos, br.nbits
    shift = 32 - cache_bits
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES
    meta_rows = meta.tolist() if meta is not None else None
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    i = col = row = cached = 0
    group = groups[0]
    gt, gm = group[0]
    while i < total:
        if meta_rows is not None and (col & mask) == 0:
            group = groups[meta_rows[row >> meta_bits][col >> meta_bits]]
            gt, gm = group[0]
        e = gt[(win[pos >> 3] >> (pos & 7)) & gm]
        pos += e & 15
        code = e >> 4
        if code < NUM_LITERAL_CODES:
            t, m = group[1]
            e = t[(win[pos >> 3] >> (pos & 7)) & m]
            pos += e & 15
            red = e >> 4
            t, m = group[2]
            e = t[(win[pos >> 3] >> (pos & 7)) & m]
            pos += e & 15
            blue = e >> 4
            t, m = group[3]
            e = t[(win[pos >> 3] >> (pos & 7)) & m]
            pos += e & 15
            argb = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            out[i] = argb
            if cache is not None:
                cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
                cached = i + 1
            i += 1
            col += 1
            if col == width:
                col = 0
                row += 1
        elif code < cache_limit:
            br.pos = pos
            length = _prefix_value(br, code - NUM_LITERAL_CODES)
            t, m = group[4]
            p = br.pos
            e = t[(win[p >> 3] >> (p & 7)) & m]
            br.pos = p + (e & 15)
            dist_code = _prefix_value(br, e >> 4)
            pos = br.pos
            if dist_code > 120:
                dist = dist_code - 120
            else:
                dx, dy = DISTANCE_MAP[dist_code - 1]
                dist = max(dy * width + dx, 1)
            if dist > i or length > total - i:
                raise error("WebP lossless", "a backward reference outside the image")
            if dist >= length:
                out[i : i + length] = out[i - dist : i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
            col += length
            while col >= width:
                col -= width
                row += 1
            if cache is not None:
                for k in range(cached, i):
                    p = out[k]
                    cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached = i
            if meta_rows is not None and (col & mask) and i < total:
                group = groups[meta_rows[row >> meta_bits][col >> meta_bits]]
                gt, gm = group[0]
        elif cache is not None and code - cache_limit < len(cache):
            argb = cache[code - cache_limit]
            out[i] = argb
            cached = i + 1
            i += 1
            col += 1
            if col == width:
                col = 0
                row += 1
        else:
            raise error("WebP lossless", "a symbol past the green alphabet")
        if pos > nbits:
            raise error("WebP lossless", "the stream is truncated")
    br.pos = pos
    return np.array(out, np.uint32).reshape(height, width)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(t: int, left: int, tl: int) -> int:
    """Predictor 11: the neighbour (top or left) nearer in Manhattan distance
    to the gradient estimate left + top − top-left."""
    d = 0
    for s in (24, 16, 8, 0):
        c = (tl >> s) & 0xFF
        d += abs(((left >> s) & 0xFF) - c) - abs(((t >> s) & 0xFF) - c)
    return t if d <= 0 else left


def _clamp_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        v = ((a >> s) & 0xFF) + ((b >> s) & 0xFF) - ((c >> s) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(a: int, b: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        x, y = (a >> s) & 0xFF, (b >> s) & 0xFF
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))  # C division truncates toward zero
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _predict(mode: int, left: int, top: int, tr: int, tl: int) -> int:
    if mode == 1:
        return left
    if mode == 5:
        return _avg2(_avg2(left, tr), top)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, top)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(top, tr))
    if mode == 11:
        return _select(top, left, tl)
    if mode == 12:
        return _clamp_full(left, top, tl)
    if mode == 13:
        return _clamp_half(_avg2(left, top), tl)
    raise AssertionError(mode)


_NO_LEFT = np.array([1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1], bool)  # modes that do not read L


def _avg2_np(a, b):
    return (((a ^ b) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (a & b)


def _add_np(a, b):
    hi, lo = np.uint32(0xFF00FF00), np.uint32(0x00FF00FF)
    return (((a & hi) + (b & hi)) & hi) | (((a & lo) + (b & lo)) & lo)


def _inverse_predictor(res: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    """Add each pixel's prediction from the pixels already decoded: the top
    row from black then its left; the first column from the top; the rest
    by the tile's mode (``data``'s green), the top-right of the last column
    being the first pixel of the current row."""
    h, w = res.shape
    out = np.empty_like(res)
    row0 = res[0].tolist()
    acc = BLACK
    for x in range(w):
        acc = _add(row0[x], acc)
        row0[x] = acc
    out[0] = row0
    tiles = ((data >> np.uint32(8)) & np.uint32(15)).astype(np.int64)
    cols = np.arange(w) >> bits
    for y in range(1, h):
        modes = tiles[y >> bits][cols]
        modes[0] = 2
        top = out[y - 1]
        tr = np.empty_like(top)
        tr[:-1] = top[1:]
        tr[-1] = _add(int(res[y, 0]), int(top[0]))  # the current row's first pixel (mode 2)
        tl = np.empty_like(top)
        tl[1:] = top[:-1]
        tl[0] = 0
        pred = np.zeros_like(top)
        pred[:] = np.uint32(BLACK)  # modes 0, 14, 15
        for mode, value in ((2, top), (3, tr), (4, tl), (8, _avg2_np(tl, top)), (9, _avg2_np(top, tr))):
            sel = modes == mode
            pred[sel] = value[sel]
        cur = _add_np(res[y], pred)
        needs_left = ~_NO_LEFT[modes]
        if needs_left.any():
            c = cur.tolist()
            t, r_row, l_row = top.tolist(), res[y].tolist(), tl.tolist()
            m = modes.tolist()
            for x in np.nonzero(needs_left)[0].tolist():
                right = t[x + 1] if x + 1 < w else c[0]
                c[x] = _add(r_row[x], _predict(m[x], c[x - 1], t[x], right, l_row[x]))
            cur = np.array(c, np.uint32)
        out[y] = cur
    return out


def _inverse_cross_color(res: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    h, w = res.shape
    mult = data[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]

    def s8(v):
        return ((v & 0xFF).astype(np.int64) ^ 0x80) - 0x80

    g2r, g2b, r2b = s8(mult), s8(mult >> np.uint32(8)), s8(mult >> np.uint32(16))
    green = s8(res >> np.uint32(8))
    red = ((res >> np.uint32(16)) & np.uint32(0xFF)).astype(np.int64)
    blue = (res & np.uint32(0xFF)).astype(np.int64)
    red = (red + ((g2r * green) >> 5)) & 0xFF
    blue = (blue + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 0xFF
    return (res & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << np.uint32(16)) | blue.astype(np.uint32)


def _inverse_subtract_green(res: np.ndarray) -> np.ndarray:
    g = (res >> np.uint32(8)) & np.uint32(0xFF)
    rb = (res & np.uint32(0x00FF00FF)) + ((g << np.uint32(16)) | g)
    return (res & np.uint32(0xFF00FF00)) | (rb & np.uint32(0x00FF00FF))


def _inverse_color_indexing(packed: np.ndarray, width: int, bits: int, palette: np.ndarray) -> np.ndarray:
    """Unbundle ``1 << bits`` indices from each packed pixel's green (first
    pixel in the low bits) and look them up in the palette (transparent
    black past its end)."""
    idx = ((packed >> np.uint32(8)) & np.uint32(0xFF)).astype(np.int64)
    if bits:
        per, bpp = 1 << bits, 8 >> bits
        x = np.arange(width)
        idx = (idx[:, x >> bits] >> (bpp * (x & (per - 1)))) & ((1 << bpp) - 1)
    full = np.zeros(256, np.uint32)
    full[: len(palette)] = palette
    return full[idx]


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L bitstream (the ``VP8L`` chunk's payload) → uint32 ARGB
    ``[H, W]``."""
    if len(data) < 5 or data[0] != 0x2F:
        raise error("WebP lossless", "no VP8L signature")
    br = BitReader(data)
    br.read(8)
    width, height = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha hint
    if br.read(3) != 0:
        raise error("WebP lossless", f"unknown version ({ITEM})")
    transforms = []
    xsize = width
    while br.read(1):
        kind = br.read(2)
        if any(t[0] == kind for t in transforms):
            raise error("WebP lossless", "a transform used twice")
        if kind in (PREDICTOR, CROSS_COLOR):
            bits = br.read(3) + 2
            sub = _decode_stream(br, _subsample(xsize, bits), _subsample(height, bits), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == COLOR_INDEXING:
            num = br.read(8) + 1
            bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
            pal = _decode_stream(br, num, 1, False)[0].view(np.uint8).reshape(num, 4)
            pal = np.cumsum(pal.astype(np.int64), axis=0) & 0xFF  # each entry a delta on the one before, per byte
            pal = pal.astype(np.uint8).reshape(-1).view(np.uint32)
            transforms.append((kind, bits, pal, xsize))
            xsize = _subsample(xsize, bits)
        else:
            transforms.append((kind, 0, None, xsize))
    img = _decode_stream(br, xsize, height, True)
    for kind, bits, sub, w in reversed(transforms):
        if kind == PREDICTOR:
            img = _inverse_predictor(img, bits, sub)
        elif kind == CROSS_COLOR:
            img = _inverse_cross_color(img, bits, sub)
        elif kind == SUBTRACT_GREEN:
            img = _inverse_subtract_green(img)
        else:
            img = _inverse_color_indexing(img, w, bits, sub)
    return img


def argb_to_rgb(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB ``[H, W]`` → uint8 RGB ``[H, W, 3]``."""
    return np.stack([(argb >> np.uint32(s)) & np.uint32(0xFF) for s in (16, 8, 0)], -1).astype(np.uint8)
