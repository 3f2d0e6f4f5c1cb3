"""JPEG decoding in numpy: what ``PIL.Image.open(p).convert("RGB")`` gives
with Pillow 12's bundled libjpeg-turbo (the GPU machine has no PIL). The JAX
image-pair loader opens JPEG folders through PIL
(``sliders_conceptmod_tpu/train/imageslider.py::load_image_array``).

Scope, as libjpeg-turbo decodes with Pillow's settings (``JDCT_ISLOW``,
``do_fancy_upsampling``):

* entropy coding: baseline and extended sequential Huffman (SOF0/SOF1) and
  progressive Huffman (SOF2: spectral selection, successive approximation of
  DC and AC, first and refinement scans); arithmetic coding, sequential and
  progressive (SOF9/SOF10): the QM decoder of T.81 Annex D with libjpeg's
  113-state table, the DC and AC statistics of F.1.4.4 and G.1.3.3, a DAC
  marker's conditioning (defaults L 0, U 1, K 5), the statistics reset at
  every scan and restart; restart intervals (DRI/RSTn); 8-bit samples;
* lossless frames (SOF3, Huffman): the seven predictors of T.81 H.1.2.1 and
  the point transform, one sample a data unit, subsampled components
  upsampled by replication; restart intervals of whole MCU rows (others are
  refused, as libjpeg-turbo refuses them); libjpeg-turbo 3 decodes them
  without colour conversion, so a file marked YCbCr (JFIF or Adobe 1) or
  YCCK is refused, as Pillow refuses it;
* one component (grey, repeated to RGB), three: YCbCr, or RGB where no
  JFIF marker is present and the Adobe marker's transform is 0 or the
  component ids are 'R', 'G', 'B' (any ids for a lossless frame;
  ``jdapimin.c::default_decompress_parms``), or four: CMYK (Adobe transform
  0 or no Adobe marker) or YCCK (any other transform), which ``jdcolor.c``
  turns to CMYK, then Pillow's inverted Adobe rawmode ``CMYK;I`` and
  ``Convert.c::cmyk2rgb``;
* the integer "islow" IDCT of ``jidctint.c``: its 13-bit fixed-point
  constants, two passes descaled by 11 and 18 bits, and the post-IDCT range
  limit table (a ``& 1023`` index, so far-out values wrap as libjpeg's do);
* ``jpeg_planes``: a stream's components without colour conversion, its
  tables optionally from a separate abbreviated stream (a TIFF's
  ``JPEGTables``);
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
12-bit, hierarchical (SOF5–7, SOF13–15, DHP) and arithmetic-coded lossless
(SOF11) JPEGs raise ``ValueError`` saying Pillow refuses them too.
Entropy decoding is plain Python (Huffman over a 16-bit lookup table, the
arithmetic decoder per decision); the IDCT, upsampling and colour passes
run on whole planes in numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# ITEM, NotThisFormat and cmyk2rgb are re-exported here, where the readers first found them
from sliders_conceptmod_tpu_torch.io._common import ITEM, NotThisFormat, cmyk2rgb, error  # noqa: F401

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

# frame kinds libjpeg-turbo 3 (and so Pillow) does not decode: hierarchical (differential) frames, and
# arithmetic-coded lossless
_SOF_REFUSED = {
    0xC5: "hierarchical JPEGs", 0xC6: "hierarchical JPEGs", 0xC7: "hierarchical JPEGs",
    0xCB: "arithmetic-coded lossless JPEGs",
    0xCD: "hierarchical JPEGs", 0xCE: "hierarchical JPEGs", 0xCF: "hierarchical JPEGs",
}

# T.81 Table D.2 as libjpeg's jpeg_aritab holds it: Qe << 16 | next index after an MPS << 8 | switch << 7 |
# next index after an LPS; entry 113 is the fixed, non-adapting bin of probability one half
ARITAB = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
]
assert len(ARITAB) == 114


def _refused_by_pillow(what: str) -> ValueError:
    return ValueError(f"JPEG: {what} are not supported; Pillow refuses them too")


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


class _Arith:
    """``jdarith.c::arith_decode`` over one entropy-coded segment (stuffing
    removed): the QM decoder of T.81 Annex D, reading zeros past its end."""

    def __init__(self, segment: bytes):
        self.data, self.pos = segment, 0
        self.c, self.a, self.ct = 0, 0, -16

    def decode(self, st: List[int], i: int) -> int:
        """One binary decision with the adaptive state ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:  # the two first bytes are in: A starts at 0x10000
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional exchange: the LPS interval was the larger
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _BadArithmeticCode(Exception):
    """libjpeg's ``JWRN_ARITH_BAD_CODE``: a warning, after which the rest of
    the restart interval decodes nothing (``entropy->ct = -1``)."""


def _jcoef(v: int) -> int:
    """A coefficient as libjpeg stores it: a 16-bit ``JCOEF``."""
    return ((v + 32768) & 0xFFFF) - 32768


class _ArithStats:
    """One interval's statistics: 64 DC and 256 AC bins per table, the DC
    predictions and contexts per component, the fixed bin."""

    def __init__(self, ncomp: int):
        self.dc = [[0] * 64 for _ in range(4)]
        self.ac = [[0] * 256 for _ in range(4)]
        self.last_dc = [0] * ncomp
        self.dc_context = [0] * ncomp
        self.fixed = [113]


def _arith_magnitude(dec: _Arith, st: List[int], i: int, x1: int, dc: bool) -> Tuple[int, int]:
    """Figures F.23–F.24: the magnitude category from bin ``i`` (SP or SN),
    then from ``x1`` on (a DC goes there at once, an AC after a second
    decision at ``i``), then its bits; returns (|v| − 1, the category's top
    bit)."""
    m = dec.decode(st, i)
    if m:
        if dc or dec.decode(st, i):
            if not dc:
                m <<= 1
            i = x1
            while dec.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _BadArithmeticCode("magnitude overflow")
                i += 1
    v, cat = m, m
    i += 14
    while m > 1:
        m >>= 1
        if dec.decode(st, i):
            v |= m
    return v, cat


def _arith_dc_diff(dec: _Arith, stats: _ArithStats, k: int, tbl: int, cond: dict) -> int:
    """Figure F.19 with the conditioning of F.1.4.4.1: one DC difference."""
    st = stats.dc[tbl]
    i = stats.dc_context[k]
    if dec.decode(st, i) == 0:
        stats.dc_context[k] = 0
        return 0
    sign = dec.decode(st, i + 1)
    v, cat = _arith_magnitude(dec, st, i + 2 + sign, 20, True)
    lo, hi = cond["dc"].get(tbl, (0, 1))
    if cat < (1 << lo) >> 1:
        stats.dc_context[k] = 0
    elif cat > (1 << hi) >> 1:
        stats.dc_context[k] = 12 + 4 * sign
    else:
        stats.dc_context[k] = 4 + 4 * sign
    v += 1
    return -v if sign else v


def _arith_ac(dec: _Arith, stats: _ArithStats, coefs: List[int], base: int, ss: int, se: int, al: int, tbl: int,
              cond: dict) -> None:
    """Figure F.20 (G.1.3.3 for a first progressive scan): AC coefficients
    ``ss..se`` of one block."""
    st = stats.ac[tbl]
    kx = cond["ac"].get(tbl, 5)
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if dec.decode(st, i):
            return  # end of block
        while dec.decode(st, i + 1) == 0:
            i += 3
            k += 1
            if k > se:
                raise _BadArithmeticCode("spectral overflow")
        sign = dec.decode(stats.fixed, 0)
        v, _ = _arith_magnitude(dec, st, i + 2, 189 if k <= kx else 217, False)
        v += 1
        coefs[base + k] = _jcoef((-v if sign else v) * (1 << al))
        k += 1


def _arith_ac_refine(dec: _Arith, stats: _ArithStats, coefs: List[int], base: int, ss: int, se: int, al: int,
                     tbl: int) -> None:
    """``decode_mcu_AC_refine``: one more bit of ``ss..se`` of one block."""
    st = stats.ac[tbl]
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coefs[base + kex]:
        kex -= 1
    k = ss - 1
    while k < se:
        i = 3 * k
        if k >= kex and dec.decode(st, i):
            return
        while True:
            j = base + k + 1
            if coefs[j]:  # previously nonzero: a correction bit
                if dec.decode(st, i + 2):
                    coefs[j] = _jcoef(coefs[j] + (m1 if coefs[j] < 0 else p1))
                break
            if dec.decode(st, i + 1):  # newly nonzero
                coefs[j] = m1 if dec.decode(stats.fixed, 0) else p1
                break
            i += 3
            k += 1
            if k >= se:
                raise _BadArithmeticCode("spectral overflow")
        k += 1


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


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, clip: bool = True) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert`` with its tables (SCALEBITS 16);
    ``clip=False`` leaves the sums unclipped (int64)."""
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
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8) if clip else out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 ``[H, W, 3]``, as ``Image.open(p).convert("RGB")``."""
    return _output(*_read(data))


def jpeg_planes(data: bytes, tables: bytes = b"") -> List[np.ndarray]:
    """The components of a JPEG stream, each upsampled to the image's size
    and not colour converted, as libjpeg gives them for an unknown colour
    space (or before converting YCbCr, as a TIFF's reader asks). ``tables``:
    an abbreviated stream of tables only (a TIFF's ``JPEGTables``), read
    before ``data``'s own markers."""
    if tables:
        if data[:2] != b"\xff\xd8" or tables[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG stream (no SOI marker)")
        data = (tables[:-2] if tables[-2:] == b"\xff\xd9" else tables) + data[2:]
    frame, comps, _, _ = _read(data)
    return _planes(frame, comps)


def _read(data: bytes):
    """The markers and scans of a JPEG stream: (frame, components, JFIF
    seen, Adobe transform)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    qtables: Dict[int, np.ndarray] = {}
    dc_luts: Dict[int, List[int]] = {}
    ac_luts: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    frame = None  # (height, width, progressive, coding: "huffman", "arithmetic" or "lossless")
    restart_interval = 0
    conditioning = {"dc": {}, "ac": {}}  # DAC: table → (L, U) for DC, K for AC
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
            raise _refused_by_pillow(_SOF_REFUSED[marker])
        if marker == 0xDE:
            raise _refused_by_pillow("hierarchical JPEGs (DHP marker)")
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            precision, height, width, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            if precision != 8:
                raise _refused_by_pillow(f"{precision}-bit samples (8-bit only)")
            if nc not in (1, 3, 4):
                raise error("JPEG", f"{nc}-component JPEGs are not supported ({ITEM})")
            if height == 0 or width == 0:
                raise error("JPEG", f"a JPEG whose height comes in a DNL marker is not supported ({ITEM})")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            coding = "lossless" if marker == 0xC3 else "arithmetic" if marker in (0xC9, 0xCA) else "huffman"
            frame = (height, width, marker in (0xC2, 0xCA), coding)
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if coding == "lossless":  # one sample a data unit; c.bw × c.bh the MCU-padded plane
                for c in comps:
                    c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
                    c.bw, c.bh = -(-width // hmax) * c.h, -(-height // vmax) * c.v
                    c.coefs = [0] * (c.dw * c.dh)  # the samples
                continue
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
        elif marker == 0xCC:  # DAC
            for p in range(0, len(seg) - 1, 2):
                tc, tb, cs = seg[p] >> 4, seg[p] & 15, seg[p + 1]
                if tc == 0:
                    conditioning["dc"][tb] = (cs & 15, cs >> 4)
                else:
                    conditioning["ac"][tb] = cs
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
                    c.qtable = qtables[c.tq] if frame[3] != "lossless" else 1
                scomps.append(c)
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            segments, nxt = _segments(data, pos + length)
            if frame[3] == "lossless":
                _decode_lossless_scan(frame, comps, scomps, ss, ahal & 15, segments, restart_interval, dc_luts)
            else:
                _decode_scan(frame, comps, scomps, ss, se, ahal >> 4, ahal & 15, segments, restart_interval,
                             dc_luts, ac_luts, conditioning)
        pos = nxt
    if frame is None:
        raise ValueError("JPEG without a frame header")
    return frame, comps, saw_jfif, adobe_transform


def _decode_scan(frame, comps, scomps, ss, se, ah, al, segments, restart_interval, dc_luts, ac_luts,
                 conditioning) -> None:
    """Decode one scan's MCUs into the components' coefficient lists."""
    height, width, progressive, coding = frame
    if len(scomps) == 1:  # non-interleaved: one block per MCU over the component's own extent
        c = scomps[0]
        units = [(0, c, by * c.bw + bx) for by in range(c.height_in_blocks) for bx in range(c.width_in_blocks)]
        mcus = [[u] for u in units]
    else:
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        mcus = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcus.append([(k, c, (my * c.v + y) * c.bw + mx * c.h + x)
                             for k, c in enumerate(scomps) for y in range(c.v) for x in range(c.h)])
    per = restart_interval or len(mcus)
    if not progressive:
        kind = "baseline"
    elif ss == 0:
        kind = "dc_first" if ah == 0 else "dc_refine"
    else:
        kind = "ac_first" if ah == 0 else "ac_refine"
    for r, start in enumerate(range(0, len(mcus), per)):
        segment = segments[r] if r < len(segments) else b""
        if coding == "arithmetic":  # statistics and the decoder restart with every interval
            _arith_interval(_Arith(segment), _ArithStats(len(scomps)), mcus[start : start + per], kind, ss, se, al,
                            conditioning)
            continue
        reader = _Bits(segment)
        pred = {id(c): 0 for c in scomps}
        eobrun = [0]
        for mcu in mcus[start : start + per]:
            for _, c, block in mcu:
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


def _arith_interval(dec: _Arith, stats: _ArithStats, mcus, kind: str, ss: int, se: int, al: int,
                    conditioning: dict) -> None:
    """One restart interval of an arithmetic-coded scan (``jdarith.c``); a
    bad code leaves the rest of the interval as it was, as libjpeg does."""
    try:
        for mcu in mcus:
            for k, c, block in mcu:
                base = block * 64
                if kind == "baseline":
                    stats.last_dc[k] += _arith_dc_diff(dec, stats, k, c.dc_table, conditioning)
                    c.coefs[base] = _jcoef(stats.last_dc[k])
                    _arith_ac(dec, stats, c.coefs, base, 1, 63, 0, c.ac_table, conditioning)
                elif kind == "dc_first":
                    stats.last_dc[k] += _arith_dc_diff(dec, stats, k, c.dc_table, conditioning)
                    c.coefs[base] = _jcoef(stats.last_dc[k] * (1 << al))
                elif kind == "dc_refine":
                    if dec.decode(stats.fixed, 0):
                        c.coefs[base] = _jcoef(c.coefs[base] | (1 << al))
                elif kind == "ac_first":
                    _arith_ac(dec, stats, c.coefs, base, ss, se, al, c.ac_table, conditioning)
                else:
                    _arith_ac_refine(dec, stats, c.coefs, base, ss, se, al, c.ac_table)
    except _BadArithmeticCode:
        pass


def _decode_lossless_scan(frame, comps, scomps, predictor, pt, segments, restart_interval, dc_luts) -> None:
    """A lossless (SOF3) scan as libjpeg-turbo 3 decodes it
    (``jddiffct.c``, ``jdlhuff.c``, ``jdlossls.c``): per sample a
    Huffman-coded difference (category 16 is 32768 with no extra bits),
    MCUs of h × v samples of each component (one sample where the scan has
    one component), the padding samples past a component's edge decoded and
    dropped. Each component's rows are then undone from T.81 H.1.2.1's
    predictors: ``2^(7 − Pt)`` at the start of the first row after the
    scan's start or a restart, the left sample along that row, the sample
    above at the start of the other rows, the selected predictor elsewhere;
    modulo 2^16. Restarts are taken at the start of MCU rows only, so an
    interval that is not whole MCU rows is refused, as libjpeg-turbo
    refuses it."""
    height, width = frame[:2]
    if len(scomps) == 1:
        c = scomps[0]
        mcux, mcuy, units = c.dw, c.dh, [(c, 1, 1)]
    else:
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        mcux, mcuy, units = -(-width // hmax), -(-height // vmax), [(c, c.h, c.v) for c in scomps]
    if restart_interval and restart_interval % mcux:
        raise _refused_by_pillow(f"a lossless restart interval of {restart_interval} MCUs in rows of {mcux} "
                                 "(libjpeg-turbo takes whole MCU rows only)")
    rows_per = restart_interval // mcux if restart_interval else mcuy
    diffs = [[[0] * (mcux * h) for _ in range(mcuy * v)] for c, h, v in units]
    for r, y_start in enumerate(range(0, mcuy, rows_per)):
        reader = _Bits(segments[r] if r < len(segments) else b"")
        for my in range(y_start, min(y_start + rows_per, mcuy)):
            for mx in range(mcux):
                for k, (c, h, v) in enumerate(units):
                    lut = dc_luts[c.dc_table]
                    for yy in range(v):
                        row = diffs[k][my * v + yy]
                        for xx in range(h):
                            s = reader.decode(lut)
                            row[mx * h + xx] = 32768 if s == 16 else _extend(reader.bits(s), s)
    for k, (c, h, v) in enumerate(units):
        plane = [0] * (c.dw * c.dh)
        w = c.dw
        for y in range(c.dh):
            d = diffs[k][y]
            i0 = y * w
            if (y // v) % rows_per == 0 and y % v == 0:  # the first row after the scan's start or a restart
                acc = 1 << (7 - pt)
                for x in range(w):
                    acc = (acc + d[x]) & 0xFFFF
                    plane[i0 + x] = acc
                continue
            plane[i0] = (plane[i0 - w] + d[0]) & 0xFFFF
            for x in range(1, w):
                i = i0 + x
                ra, rb, rc = plane[i - 1], plane[i - w], plane[i - w - 1]
                pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                        (ra + rb) >> 1)[predictor - 1]
                plane[i] = (pred + d[x]) & 0xFFFF
        c.coefs = [(val << pt) & 0xFF for val in plane]


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


def _planes(frame, comps: List[_Component]) -> List[np.ndarray]:
    """Each component's samples at the image's size."""
    height, width, _, coding = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.qtable is None:
            raise ValueError(f"JPEG component {c.id} has no scan")
        fh, fv = hmax // c.h, vmax // c.v
        if coding == "lossless":  # libjpeg-turbo upsamples lossless samples by replication
            plane = np.asarray(c.coefs, np.int64).reshape(c.dh, c.dw)
            planes.append(_upsample(plane, fh, fv, fancy=False)[:height, :width])
            continue
        zz = np.asarray(c.coefs, np.int64).reshape(-1, 64) * c.qtable[None, :]
        samples = idct_islow(zz[:, _NATURAL_FROM_ZIGZAG].reshape(-1, 8, 8))
        plane = samples.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        if hmax % c.h or vmax % c.v:
            raise ValueError("JPEG: fractional sampling factors are not supported (libjpeg refuses them too)")
        planes.append(_upsample(plane[: c.dh, : c.dw], fh, fv, fancy=True)[:height, :width])
    return planes


def _output(frame, comps: List[_Component], saw_jfif: bool, adobe_transform) -> np.ndarray:
    coding = frame[3]
    planes = _planes(frame, comps)
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[:, :, None], 3, axis=2)
    if len(comps) == 4:
        if adobe_transform not in (None, 0):  # YCCK (an unknown transform is taken for YCCK as well)
            if coding == "lossless":
                raise _refused_by_pillow("lossless JPEGs in YCCK (libjpeg converts no lossless colour space)")
            planes = list(_ycck_to_cmyk(*planes))
        return _cmyk_to_rgb(np.stack(planes, axis=-1))
    ids = tuple(c.id for c in comps)
    if saw_jfif:
        rgb = False
    elif adobe_transform is not None:
        rgb = adobe_transform == 0
    else:  # no marker: the component ids decide, and a lossless file is taken for RGB
        rgb = ids == (82, 71, 66) or coding == "lossless"
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    if coding == "lossless":
        raise _refused_by_pillow("lossless JPEGs in YCbCr (libjpeg converts no lossless colour space)")
    return ycc_to_rgb(*planes)


def _ycck_to_cmyk(y, cb, cr, k):
    """``jdcolor.c::ycck_cmyk_convert``: YCbCr → RGB by the same tables,
    each inverted to C, M, Y and range-limited; K passes through."""
    rgb = ycc_to_rgb(y, cb, cr, clip=False)
    return tuple(np.clip(255 - rgb[..., i], 0, 255) for i in range(3)) + (k,)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """What Pillow makes of libjpeg's CMYK: the Adobe rawmode ``CMYK;I``
    inverts every channel, then ``cmyk2rgb``."""
    return cmyk2rgb(255 - cmyk.astype(np.int64))
