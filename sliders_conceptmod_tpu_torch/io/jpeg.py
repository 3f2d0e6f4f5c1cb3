"""JPEG decoding in numpy: what ``PIL.Image.open(p).convert("RGB")`` gives
with Pillow 12's bundled libjpeg-turbo (the GPU machine has no PIL). The JAX
image-pair loader opens JPEG folders through PIL
(``sliders_conceptmod_tpu/train/imageslider.py::load_image_array``).

Scope, as libjpeg-turbo decodes with Pillow's settings (``JDCT_ISLOW``,
``do_fancy_upsampling``):

* entropy coding: baseline and extended sequential Huffman (SOF0/SOF1) and
  progressive Huffman (SOF2: spectral selection, successive approximation of
  DC and AC, first and refinement scans), restart intervals (DRI/RSTn),
  8-bit samples;
* one component (grey, repeated to RGB) or three: YCbCr, or RGB where no
  JFIF marker is present and the Adobe marker's transform is 0 or the
  component ids are 'R', 'G', 'B' (``jdapimin.c::default_decompress_parms``);
* the integer "islow" IDCT of ``jidctint.c``: its 13-bit fixed-point
  constants, two passes descaled by 11 and 18 bits, and the post-IDCT range
  limit table (a ``& 1023`` index, so far-out values wrap as libjpeg's do);
* upsampling as ``jdsample.c`` picks it per component: the triangle
  ("fancy") filters for h2v1 and h2v2 when the component is more than two
  samples wide, and for h1v2, with their alternating rounding biases; box
  replication for any other integral factor. The rows above the first and
  below the last real row are edge copies (``jdmainct.c``'s context rows),
  as are the columns beside the first and last real column;
* ``jdcolor.c``'s fixed-point YCbCr → RGB tables (16 fractional bits);
* sizes that are not multiples of the MCU: each component is cut to its real
  size before it is upsampled, the image after.

EXIF orientation is not applied: ``Image.open`` does not apply it either.
Arithmetic coding, 12-bit, lossless and hierarchical JPEGs, and four
components (CMYK/YCCK) raise ``ValueError``. Huffman decoding is plain
Python over a 16-bit lookup table; the IDCT, upsampling and colour passes
run on whole planes in numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

ITEM = "ROADMAP.md queue 1, item 14"

# jpeg_natural_order: zigzag index k → natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_NATURAL_FROM_ZIGZAG = np.argsort(ZIGZAG)  # natural index n → its zigzag index

# jidctint.c: CONST_BITS 13, PASS1_BITS 2 and the FIX_* constants
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """``jdmaster.c::prepare_range_limit_table`` seen from the IDCT: entry
    ``x & 1023`` of the table that starts ``CENTERJSAMPLE`` into it."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()

_SOF_REFUSED = {
    0xC3: "lossless JPEGs are not supported",
    0xC5: "hierarchical JPEGs are not supported",
    0xC6: "hierarchical JPEGs are not supported",
    0xC7: "hierarchical JPEGs are not supported",
    0xC9: "arithmetic-coded JPEGs are not supported",
    0xCA: "arithmetic-coded JPEGs are not supported",
    0xCB: "arithmetic-coded JPEGs are not supported",
    0xCD: "arithmetic-coded hierarchical JPEGs are not supported",
    0xCE: "arithmetic-coded hierarchical JPEGs are not supported",
    0xCF: "arithmetic-coded lossless JPEGs are not supported",
}


def _refuse(what: str) -> ValueError:
    return ValueError(f"JPEG: {what} ({ITEM})")


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable = None  # latched at the component's first scan, as jdinput.c latches it
        self.coefs: List[int] = []  # zigzag-ordered coefficients, 64 per block, block rows of ``bw``
        self.bw = self.bh = 0  # the buffer's size in blocks (whole MCUs)
        self.width_in_blocks = self.height_in_blocks = 0  # a non-interleaved scan's extent
        self.dw = self.dh = 0  # downsampled (real) size in samples
        self.dc_table = self.ac_table = 0


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 65536-entry table: the next 16 bits → ``length << 8 | symbol``
    (0 where no code starts)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


class _Bits:
    """A big-endian bit reader over one entropy-coded segment (byte stuffing
    removed); past its end it reads zeros, as libjpeg does."""

    def __init__(self, segment: bytes):
        a = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()
        self.limit = len(segment) * 8 + 32
        self.pos = 0

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        if p + n > self.limit:
            raise ValueError("JPEG entropy-coded data is truncated")
        self.pos = p + n
        return (self.win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def decode(self, lut: List[int]) -> int:
        p = self.pos
        if p >= self.limit:
            raise ValueError("JPEG entropy-coded data is truncated")
        e = lut[(self.win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if e == 0:
            raise ValueError("JPEG: bad Huffman code")
        self.pos = p + (e >> 8)
        return e & 0xFF


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``pos``: its segments between RSTn markers
    (stuffed zeros removed) and the position of the marker that ends it."""
    arr = np.frombuffer(data, np.uint8)
    ff = pos + np.nonzero(arr[pos:-1] == 0xFF)[0]
    nxt = arr[ff + 1]
    is_marker = (nxt != 0) & ~((nxt >= 0xD0) & (nxt <= 0xD7)) & (nxt != 0xFF)
    end = int(ff[is_marker][0]) if is_marker.any() else len(data)
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    cuts = [pos] + [int(r) for r in rst] + [end]
    segs = []
    for i in range(len(cuts) - 1):
        a = cuts[i] if i == 0 else cuts[i] + 2
        segs.append(data[a : cuts[i + 1]].replace(b"\xff\x00", b"\xff"))
    return segs, end


def _idct_1d(x: List[np.ndarray]) -> List[np.ndarray]:
    """The eight undescaled outputs of ``jpeg_idct_islow``'s 1-D pass."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantized coefficients ``[N, 8, 8]`` (natural order, rows the
    vertical frequency) → samples ``[N, 8, 8]`` uint8, as ``jidctint.c``."""
    c = blocks.astype(np.int64)
    n1 = CONST_BITS - PASS1_BITS
    cols = _idct_1d([c[:, k, :] for k in range(8)])  # pass 1: down each column
    ws = np.stack([(v + (1 << (n1 - 1))) >> n1 for v in cols], axis=1)
    n2 = CONST_BITS + PASS1_BITS + 3
    rows = _idct_1d([ws[:, :, k] for k in range(8)])  # pass 2: along each row
    out = np.stack([(v + (1 << (n2 - 1))) >> n2 for v in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


def _upsample(plane: np.ndarray, fh: int, fv: int, fancy: bool) -> np.ndarray:
    """One component's real samples ``[dh, dw]`` → ``[dh·fv, dw·fh]`` by
    ``jdsample.c``'s method for the factor (fh, fv)."""
    p = plane.astype(np.int64)
    if fh == 1 and fv == 1:
        return p
    dw = p.shape[1]
    if fancy and fh == 2 and fv == 1 and dw > 2:  # h2v1_fancy_upsample
        left = np.concatenate([p[:, :1], p[:, :-1]], 1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
        out = np.empty((p.shape[0], 2 * dw), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out
    if fancy and fh == 1 and fv == 2:  # h1v2_fancy_upsample
        above = np.concatenate([p[:1], p[:-1]], 0)
        below = np.concatenate([p[1:], p[-1:]], 0)
        out = np.empty((2 * p.shape[0], dw), np.int64)
        out[0::2] = (3 * p + above + 1) >> 2
        out[1::2] = (3 * p + below + 2) >> 2
        return out
    if fancy and fh == 2 and fv == 2 and dw > 2:  # h2v2_fancy_upsample
        above = np.concatenate([p[:1], p[:-1]], 0)
        below = np.concatenate([p[1:], p[-1:]], 0)
        out = np.empty((2 * p.shape[0], 2 * dw), np.int64)
        for r, far in ((0, above), (1, below)):
            c = 3 * p + far  # the column sums
            left = np.concatenate([c[:, :1], c[:, :-1]], 1)
            right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
            out[r::2, 0::2] = (3 * c + left + 8) >> 4
            out[r::2, 1::2] = (3 * c + right + 7) >> 4
        return out
    return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)  # box: h2v1_upsample, h2v2_upsample, int_upsample


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert`` with its tables (SCALEBITS 16)."""
    one_half = 1 << 15

    def fix(x):
        return int(x * 65536 + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 ``[H, W, 3]``, as ``Image.open(p).convert("RGB")``."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    qtables: Dict[int, np.ndarray] = {}
    dc_luts: Dict[int, List[int]] = {}
    ac_luts: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    frame = None  # (height, width, progressive)
    restart_interval = 0
    saw_jfif = False
    adobe_transform = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # libjpeg skips garbage before a marker (with a warning)
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1  # fill bytes
        if pos >= len(data):
            raise ValueError("JPEG ends before its EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2 : pos + length]
        nxt = pos + length
        if marker in _SOF_REFUSED:
            raise _refuse(_SOF_REFUSED[marker])
        if marker == 0xDE:
            raise _refuse("hierarchical JPEGs are not supported (DHP marker)")
        if marker == 0xCC:
            raise _refuse("arithmetic-coded JPEGs are not supported (DAC marker)")
        if marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            if precision != 8:
                raise _refuse(f"{precision}-bit samples are not supported (8-bit only)")
            if nc == 4:
                raise _refuse("4-component (CMYK/YCCK) JPEGs are not supported")
            if nc not in (1, 3):
                raise _refuse(f"{nc}-component JPEGs are not supported")
            if height == 0 or width == 0:
                raise _refuse("a JPEG whose height comes in a DNL marker is not supported")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = (height, width, marker == 0xC2)
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.coefs = [0] * (c.bw * c.bh * 64)
                c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
                c.width_in_blocks, c.height_in_blocks = -(-c.dw // 8), -(-c.dh // 8)
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = seg[p + 1 : p + 17]
                n = sum(counts)
                (dc_luts if tc == 0 else ac_luts)[th] = _huffman_lut(counts, seg[p + 17 : p + 17 + n])
                p += 17 + n
        elif marker == 0xDB:  # DQT (values in zigzag order, as the coefficients are kept)
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq:
                    qtables[tq] = np.frombuffer(seg[p + 1 : p + 129], ">u2").astype(np.int64)
                    p += 129
                else:
                    qtables[tq] = np.frombuffer(seg[p + 1 : p + 65], np.uint8).astype(np.int64)
                    p += 65
        elif marker == 0xDD:  # DRI
            restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            saw_jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            by_id = {c.id: c for c in comps}
            scomps = []
            for i in range(ns):
                c = by_id[seg[1 + 2 * i]]
                c.dc_table, c.ac_table = seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15
                if c.qtable is None:
                    c.qtable = qtables[c.tq]
                scomps.append(c)
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            segments, nxt = _segments(data, pos + length)
            _decode_scan(frame, comps, scomps, ss, se, ahal >> 4, ahal & 15, segments, restart_interval,
                         dc_luts, ac_luts)
        pos = nxt
    if frame is None:
        raise ValueError("JPEG without a frame header")
    return _output(frame, comps, saw_jfif, adobe_transform)


def _decode_scan(frame, comps, scomps, ss, se, ah, al, segments, restart_interval, dc_luts, ac_luts) -> None:
    """Decode one scan's MCUs into the components' coefficient lists."""
    height, width, progressive = frame
    if len(scomps) == 1:  # non-interleaved: one block per MCU over the component's own extent
        c = scomps[0]
        units = [(c, by * c.bw + bx) for by in range(c.height_in_blocks) for bx in range(c.width_in_blocks)]
        mcus = [[u] for u in units]
    else:
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        mcus = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcus.append([(c, (my * c.v + y) * c.bw + mx * c.h + x)
                             for c in scomps for y in range(c.v) for x in range(c.h)])
    per = restart_interval or len(mcus)
    if not progressive:
        kind = "baseline"
    elif ss == 0:
        kind = "dc_first" if ah == 0 else "dc_refine"
    else:
        kind = "ac_first" if ah == 0 else "ac_refine"
    for r, start in enumerate(range(0, len(mcus), per)):
        reader = _Bits(segments[r] if r < len(segments) else b"")
        pred = {id(c): 0 for c in scomps}
        eobrun = [0]
        for mcu in mcus[start : start + per]:
            for c, block in mcu:
                base = block * 64
                if kind == "baseline":
                    _block_baseline(reader, c, base, pred, dc_luts[c.dc_table], ac_luts[c.ac_table])
                elif kind == "dc_first":
                    s = reader.decode(dc_luts[c.dc_table])
                    pred[id(c)] += _extend(reader.bits(s), s)
                    c.coefs[base] = pred[id(c)] << al
                elif kind == "dc_refine":
                    if reader.bits(1):
                        c.coefs[base] |= 1 << al
                elif kind == "ac_first":
                    _block_ac_first(reader, c.coefs, base, ss, se, al, ac_luts[c.ac_table], eobrun)
                else:
                    _block_ac_refine(reader, c.coefs, base, ss, se, al, ac_luts[c.ac_table], eobrun)


def _block_baseline(reader: _Bits, c: _Component, base: int, pred: dict, dc: List[int], ac: List[int]) -> None:
    coefs = c.coefs
    s = reader.decode(dc)
    pred[id(c)] += _extend(reader.bits(s), s)
    coefs[base] = pred[id(c)]
    k = 1
    while k < 64:
        rs = reader.decode(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise ValueError("JPEG: coefficient index past 63")
            coefs[base + k] = _extend(reader.bits(s), s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break


def _block_ac_first(reader: _Bits, coefs: List[int], base: int, ss: int, se: int, al: int, ac: List[int],
                    eobrun: List[int]) -> None:
    """``jdphuff.c::decode_mcu_AC_first`` for one block."""
    if eobrun[0] > 0:
        eobrun[0] -= 1
        return
    k = ss
    while k <= se:
        rs = reader.decode(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise ValueError("JPEG: coefficient index past 63")
            coefs[base + k] = _extend(reader.bits(s), s) << al
        elif r == 15:
            k += 15
        else:
            eobrun[0] = (1 << r) + reader.bits(r) - 1
            return
        k += 1


def _block_ac_refine(reader: _Bits, coefs: List[int], base: int, ss: int, se: int, al: int, ac: List[int],
                     eobrun: List[int]) -> None:
    """``jdphuff.c::decode_mcu_AC_refine`` for one block."""
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun[0] == 0:
        while k <= se:
            rs = reader.decode(ac)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if reader.bits(1) else m1
            elif r != 15:
                eobrun[0] = (1 << r) + reader.bits(r)
                break  # the rest of the block goes as an end-of-band
            while k <= se:  # skip r zero coefficients, refining the nonzero ones passed
                i = base + k
                if coefs[i]:
                    if reader.bits(1) and not coefs[i] & p1:
                        coefs[i] += p1 if coefs[i] >= 0 else m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    raise ValueError("JPEG: coefficient index past 63")
                coefs[base + k] = s
            k += 1
    if eobrun[0] > 0:
        while k <= se:  # refine the nonzero coefficients past the end of band
            i = base + k
            if coefs[i] and reader.bits(1) and not coefs[i] & p1:
                coefs[i] += p1 if coefs[i] >= 0 else m1
            k += 1
        eobrun[0] -= 1


def _output(frame, comps: List[_Component], saw_jfif: bool, adobe_transform) -> np.ndarray:
    height, width, _ = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.qtable is None:
            raise ValueError(f"JPEG component {c.id} has no scan")
        zz = np.asarray(c.coefs, np.int64).reshape(-1, 64) * c.qtable[None, :]
        samples = idct_islow(zz[:, _NATURAL_FROM_ZIGZAG].reshape(-1, 8, 8))
        plane = samples.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        fh, fv = hmax // c.h, vmax // c.v
        if hmax % c.h or vmax % c.v:
            raise ValueError("JPEG: fractional sampling factors are not supported (libjpeg refuses them too)")
        planes.append(_upsample(plane[: c.dh, : c.dw], fh, fv, fancy=True)[:height, :width])
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[:, :, None], 3, axis=2)
    ids = tuple(c.id for c in comps)
    rgb = not saw_jfif and (adobe_transform == 0 if adobe_transform is not None else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)
