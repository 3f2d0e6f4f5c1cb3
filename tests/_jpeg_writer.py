"""A baseline JPEG writer for the decoder tests: any sampling factors per
component (Pillow writes only 4:4:4, 4:2:2 and 4:2:0), the standard
Huffman tables of ITU T.81 Annex K, and an optional JFIF or Adobe marker and
component ids. The tests take Pillow's decode of its files as the reference;
its own quality does not matter."""

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io.jpeg import ARITAB

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# Annex K.1 quantisation tables (natural order)
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
                     47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
# Annex K.3: (counts per length 1..16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
    "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
    "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
    "f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a"
    "35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596"
    "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
    "f5f6f7f8f9fa"))


def _codes(table):
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        self.acc, self.n = (self.acc << length) | (value & ((1 << length) - 1)), self.n + length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones


def _category(v):
    return int(abs(v)).bit_length()


def _dct_matrix():
    c = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)])
    return c


def _coefficients(image, sampling, quality_scale, ycc):
    """The quantised blocks per component ``[by, bx, 64]`` (zigzag order)
    over whole MCUs, and the two quantisation tables. A fourth component
    (CMYK or YCCK) passes through as the luma of the others does."""
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        img = img[:, :, None]
    h_img, w_img, nc = img.shape
    if ycc and nc in (3, 4):
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        img = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                        0.5 * r - 0.418688 * g - 0.081312 * b + 128] + [img[..., k] for k in range(3, nc)], -1)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    pad = np.pad(img, ((0, mcuy * 8 * vmax - h_img), (0, mcux * 8 * hmax - w_img), (0, 0)), mode="edge")
    qtabs = [np.clip(np.round(LUMA_Q * quality_scale), 1, 255), np.clip(np.round(CHROMA_Q * quality_scale), 1, 255)]
    C = _dct_matrix()
    blocks = []
    for ci in range(nc):
        h, v = sampling[ci]
        fy, fx = vmax // v, hmax // h
        plane = pad[:, :, ci].reshape(pad.shape[0] // fy, fy, pad.shape[1] // fx, fx).mean((1, 3)) - 128
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        b = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", C, b, C).reshape(bh, bw, 64)
        blocks.append(np.round(coef / qtabs[_table(ci)]).astype(np.int64)[:, :, ZIGZAG])
    return blocks, qtabs, mcux, mcuy


def _table(ci):
    """Component → table: luma 0, chroma 1, and a fourth component (K) 0."""
    return 1 if ci in (1, 2) else 0


def _marker(code, payload):
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


def _header(qtabs, nc, jfif, adobe_transform):
    out = b"\xff\xd8"
    if jfif:
        out += _marker(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe_transform]))
    for t, q in enumerate(qtabs[: min(nc, 2)]):
        out += _marker(0xDB, bytes([t]) + bytes(q.astype(np.int64)[ZIGZAG].astype(np.uint8)))
    return out


def _sof(marker, h_img, w_img, sampling, ids, nc):
    sof = struct.pack(">BHHB", 8, h_img, w_img, nc)
    for ci in range(nc):
        h, v = sampling[ci]
        sof += bytes([ids[ci], (h << 4) | v, _table(ci)])
    return _marker(marker, sof)


def _mcu_blocks(blocks, sampling, comps, mcux, mcuy, size):
    """Per MCU of a scan over ``comps``: its (component, block) list; one
    block per MCU where the scan has one component, over that component's
    own extent (``size`` is the image's (h, w))."""
    if len(comps) == 1:
        ci = comps[0]
        hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
        rows = -(-(-(-size[0] * sampling[ci][1] // vmax)) // 8)
        cols = -(-(-(-size[1] * sampling[ci][0] // hmax)) // 8)
        return [[(ci, blocks[ci][by, bx])] for by in range(rows) for bx in range(cols)]
    out = []
    for my in range(mcuy):
        for mx in range(mcux):
            out.append([(ci, blocks[ci][my * sampling[ci][1] + y, mx * sampling[ci][0] + x])
                        for ci in comps for y in range(sampling[ci][1]) for x in range(sampling[ci][0])])
    return out


def write_jpeg(image: np.ndarray, sampling=((2, 2), (1, 1), (1, 1)), quality_scale: float = 0.5,
               ids=(1, 2, 3), jfif: bool = True, adobe_transform=None, ycc: bool = True, restart: int = 0) -> bytes:
    """``image`` uint8 ``[H, W, 3]`` (``[H, W, 4]`` CMYK or YCCK; ``[H, W]``
    grey, one component) → baseline JPEG bytes. ``sampling`` gives each
    component's (h, v); ``ycc`` converts RGB to YCbCr first (leave it off
    for an RGB or CMYK file)."""
    img = np.asarray(image)
    if img.ndim == 2:
        sampling, ids = ((1, 1),), ids[:1]
    h_img, w_img = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    blocks, qtabs, mcux, mcuy = _coefficients(img, sampling if img.ndim == 3 else ((1, 1),), quality_scale, ycc)
    if nc == 1:
        sampling = ((1, 1),)
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    segments, w = [], _BitWriter()
    pred = [0] * nc
    for n_mcu, mcu in enumerate(_mcu_blocks(blocks, sampling, list(range(nc)), mcux, mcuy, (h_img, w_img))):
        if restart and n_mcu and n_mcu % restart == 0:
            w.flush()
            segments.append(bytes(w.out) + bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8]))
            w, pred = _BitWriter(), [0] * nc
        for ci, blk in mcu:
            dc_codes, ac_codes = tables[_table(ci)]
            diff = int(blk[0]) - pred[ci]
            pred[ci] = int(blk[0])
            s = _category(diff)
            w.put(*dc_codes[s])
            if s:
                w.put(diff if diff > 0 else diff - 1, s)
            run = 0
            for k in range(1, 64):
                a = int(blk[k])
                if a == 0:
                    run += 1
                    continue
                while run > 15:
                    w.put(*ac_codes[0xF0])
                    run -= 16
                s = _category(a)
                w.put(*ac_codes[(run << 4) | s])
                w.put(a if a > 0 else a - 1, s)
                run = 0
            if run:
                w.put(*ac_codes[0x00])
    w.flush()
    segments.append(bytes(w.out))
    out = _header(qtabs, nc, jfif, adobe_transform) + _sof(0xC0, h_img, w_img, sampling, ids, nc)
    for tc, th, (counts, symbols) in ((0, 0, DC_LUMA), (1, 0, AC_LUMA), (0, 1, DC_CHROMA), (1, 1, AC_CHROMA)):
        if th < min(nc, 2):
            out += _marker(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols))
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ids[ci], (_table(ci) << 4) | _table(ci)]) for ci in range(nc))
    out += _marker(0xDA, sos + b"\x00\x3f\x00") + b"".join(segments)
    return out + b"\xff\xd9"


# ---------------------------------------------------------------------------
# arithmetic coding (ITU T.81 Annex D and F.1.4, G.1.3), as jcarith.c codes it
# ---------------------------------------------------------------------------


class _ArithEncoder:
    """The QM encoder with libjpeg's byte output (stacked 0xFF bytes, carry
    propagation and the final flush)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _emit_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._emit_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._emit_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._emit_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _shift_al(v, al):
    """The point transform of an AC coefficient: division rounding toward 0."""
    return v >> al if v >= 0 else -((-v) >> al)


class _ArithScan:
    """One scan's statistics and encoder; ``restart()`` ends an interval."""

    def __init__(self, ncomp, dc_l, dc_u, ac_k):
        self.segments = []
        self.ncomp, self.dc_l, self.dc_u, self.ac_k = ncomp, dc_l, dc_u, ac_k
        self._reset()

    def _reset(self):
        self.enc = _ArithEncoder()
        self.dc_stats = [[0] * 64 for _ in range(4)]
        self.ac_stats = [[0] * 256 for _ in range(4)]
        self.last_dc = [0] * self.ncomp
        self.dc_context = [0] * self.ncomp
        self.fixed = [113]

    def restart(self, n):
        self.segments.append(self.enc.finish() + bytes([0xFF, 0xD0 + n % 8]))
        self._reset()

    def finish(self):
        self.segments.append(self.enc.finish())
        return b"".join(self.segments)

    def _magnitude(self, st, i, v, stats, x1):
        """Figures F.8 and F.9 from bin ``i`` (SP/SN): category, then bits."""
        e = self.enc
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            if x1 is None:  # DC: X1 = 20
                st, i = stats, 20
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
            else:
                v2 >>= 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i = x1
                    while True:
                        v2 >>= 1
                        if not v2:
                            break
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
        e.encode(st, i, 0)
        i += 14
        while True:
            m >>= 1
            if not m:
                break
            e.encode(st, i, 1 if m & v else 0)
        return m

    def dc(self, ci, tbl, value, al=0):
        e, stats = self.enc, self.dc_stats[tbl]
        m = value >> al
        i = self.dc_context[ci]
        v = m - self.last_dc[ci]
        if v == 0:
            e.encode(stats, i, 0)
            self.dc_context[ci] = 0
            return
        self.last_dc[ci] = m
        e.encode(stats, i, 1)
        if v > 0:
            e.encode(stats, i + 1, 0)
            i += 2
            ctx = 4
        else:
            v = -v
            e.encode(stats, i + 1, 1)
            i += 3
            ctx = 8
        # the category, recomputed as the decoder sees it, for the context
        cat = 0 if v == 1 else 1 << ((v - 1).bit_length() - 1)
        self._magnitude(stats, i, v, stats, None)
        if cat < (1 << self.dc_l[tbl]) >> 1:
            ctx = 0
        elif cat > (1 << self.dc_u[tbl]) >> 1:
            ctx += 8
        self.dc_context[ci] = ctx

    def ac(self, tbl, zz, ss=1, se=63, al=0):
        e, stats = self.enc, self.ac_stats[tbl]
        vals = [_shift_al(int(zz[k]), al) for k in range(64)]
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(stats, i, 0)
            while vals[k] == 0:
                e.encode(stats, i + 1, 0)
                i += 3
                k += 1
            e.encode(stats, i + 1, 1)
            e.encode(self.fixed, 0, 1 if vals[k] < 0 else 0)
            self._magnitude(stats, i + 2, abs(vals[k]), stats, 189 if k <= self.ac_k[tbl] else 217)
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)

    def dc_refine(self, value, al):
        self.enc.encode(self.fixed, 0, (value >> al) & 1)

    def ac_refine(self, tbl, zz, ss, se, ah, al):
        e, stats = self.enc, self.ac_stats[tbl]
        cur = [_shift_al(int(zz[k]), al) for k in range(64)]
        prev = [_shift_al(int(zz[k]), ah) for k in range(64)]
        ke = se
        while ke > 0 and cur[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and prev[kex] == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(stats, i, 0)
            while True:
                v = abs(cur[k])
                if v:
                    if v >> 1:
                        e.encode(stats, i + 2, v & 1)
                    else:
                        e.encode(stats, i + 1, 1)
                        e.encode(self.fixed, 0, 1 if cur[k] < 0 else 0)
                    break
                e.encode(stats, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)


# a progressive script: (components, Ss, Se, Ah, Al); None for components means each one alone
_PROGRESSIVE_SCRIPT = [("all", 0, 0, 0, 1), (None, 1, 5, 0, 2), (None, 6, 63, 0, 2), (None, 1, 63, 2, 1),
                       (None, 1, 63, 1, 0), ("all", 0, 0, 1, 0)]


def write_jpeg_arithmetic(image: np.ndarray, sampling=((2, 2), (1, 1), (1, 1)), quality_scale: float = 0.5,
                          progressive: bool = False, restart: int = 0, conditioning=None, ycc: bool = True,
                          adobe_transform=None, jfif: bool = True) -> bytes:
    """Arithmetic-coded JPEG (SOF9 sequential or SOF10 progressive) of
    ``image`` (grey, 3 or 4 components). ``conditioning``: a DAC marker's
    ``{"dc": [(L, U) per table], "ac": [K per table]}``; libjpeg's defaults
    (L 0, U 1, K 5) otherwise."""
    img = np.asarray(image)
    nc = 1 if img.ndim == 2 else img.shape[2]
    if nc == 1:
        sampling = ((1, 1),)
    blocks, qtabs, mcux, mcuy = _coefficients(img, sampling, quality_scale, ycc)
    ntab = min(nc, 2)
    dc_l, dc_u, ac_k = [0] * 4, [1] * 4, [5] * 4
    dac = b""
    if conditioning:
        for t, (l, u) in enumerate(conditioning.get("dc", [])):
            dc_l[t], dc_u[t] = l, u
            dac += bytes([t, (u << 4) | l])
        for t, k in enumerate(conditioning.get("ac", [])):
            ac_k[t] = k
            dac += bytes([0x10 | t, k])
    out = _header(qtabs, nc, jfif, adobe_transform) + _sof(0xCA if progressive else 0xC9, img.shape[0], img.shape[1],
                                                           sampling, (1, 2, 3, 4), nc)
    if dac:
        out += _marker(0xCC, dac)
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    script = _PROGRESSIVE_SCRIPT if progressive else [("all", 0, 63, 0, 0)]
    for comps, ss, se, ah, al in script:
        for group in ([list(range(nc))] if comps == "all" else [[c] for c in range(nc)]):
            mcus = _mcu_blocks(blocks, sampling, group, mcux, mcuy, img.shape[:2])
            scan = _ArithScan(nc, dc_l, dc_u, ac_k)
            for n, mcu in enumerate(mcus):
                if restart and n and n % restart == 0:
                    scan.restart(n // restart - 1)
                for ci, blk in mcu:
                    t = _table(ci)
                    if not progressive:
                        scan.dc(ci, t, int(blk[0]))
                        scan.ac(t, blk)
                    elif ss == 0:
                        if ah == 0:
                            scan.dc(ci, t, int(blk[0]), al)
                        else:
                            scan.dc_refine(int(blk[0]), al)
                    elif ah == 0:
                        scan.ac(t, blk, ss, se, al)
                    else:
                        scan.ac_refine(t, blk, ss, se, ah, al)
            sos = bytes([len(group)]) + b"".join(bytes([ci + 1, (_table(ci) << 4) | _table(ci)])
                                                 for ci in group)
            out += _marker(0xDA, sos + bytes([ss, se, (ah << 4) | al])) + scan.finish()
    return out + b"\xff\xd9"


# ---------------------------------------------------------------------------
# lossless (SOF3, Huffman), to see what Pillow makes of one
# ---------------------------------------------------------------------------

# a DC-style table for the 17 difference categories 0..16
LOSSLESS_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], list(range(17)))


def write_jpeg_lossless(image: np.ndarray, predictor: int = 1, point_transform: int = 0, sampling=None,
                        restart: int = 0) -> bytes:
    """8-bit lossless JPEG (SOF3) of ``image`` (grey, 3 or 4 components),
    one interleaved scan with the given predictor (1–7). ``sampling``: each
    component's (h, v); a subsampled component takes every ``hmax // h``-th
    column and ``vmax // v``-th row of its plane. ``restart``: an RSTn
    marker every that many MCUs; the prediction restarts (first-row rules)
    only where an interval starts a row of MCUs."""
    img = np.asarray(image, np.int64)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nc = img.shape
    sampling = sampling or ((1, 1),) * nc
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    planes = []
    for c, (sh, sv) in enumerate(sampling):
        real = img[:: vmax // sv, :: hmax // sh, c][: -(-h * sv // vmax), : -(-w * sh // hmax)] >> point_transform
        padded = np.pad(real, ((0, mcuy * sv - real.shape[0]), (0, mcux * sh - real.shape[1])), mode="edge")
        planes.append(padded)
    reset_rows = {0} | ({r * restart // mcux for r in range(1, mcux * mcuy // restart + 1)
                        if (r * restart) % mcux == 0} if restart else set())
    diffs = []
    for c, (sh, sv) in enumerate(sampling):
        x = planes[c]
        d = np.zeros_like(x)
        first = True
        for y in range(x.shape[0]):
            if y % sv == 0 and y // sv in reset_rows:
                first = True
            for xx in range(x.shape[1]):
                ra = int(x[y, xx - 1]) if xx else None
                if first:
                    p = ra if xx else 1 << (8 - point_transform - 1)
                elif xx == 0:
                    p = int(x[y - 1, xx])
                else:
                    rb, rc = int(x[y - 1, xx]), int(x[y - 1, xx - 1])
                    p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                         7: (ra + rb) // 2}[predictor]
                diff = (int(x[y, xx]) - p) % 65536
                d[y, xx] = diff - 65536 if diff >= 32768 else diff
            first = False
        diffs.append(d)
    codes = _codes(LOSSLESS_DC)
    wr = _BitWriter()
    n = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n and n % restart == 0:
                wr.flush()
                wr.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            n += 1
            for c, (sh, sv) in enumerate(sampling):
                for yy in range(sv):
                    for xx in range(sh):
                        diff = int(diffs[c][my * sv + yy, mx * sh + xx])
                        s = _category(diff)
                        wr.put(*codes[s])
                        if s and s < 16:
                            wr.put(diff if diff > 0 else diff - 1, s)
    wr.flush()
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(bytes([c + 1, (sh << 4) | sv, 0])
                                                       for c, (sh, sv) in enumerate(sampling))
    out = b"\xff\xd8" + _marker(0xC3, sof)
    out += _marker(0xC4, bytes([0]) + bytes(LOSSLESS_DC[0]) + bytes(LOSSLESS_DC[1]))
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0x00]) for c in range(nc)) + bytes([predictor, 0, point_transform])
    return out + _marker(0xDA, sos) + bytes(wr.out) + b"\xff\xd9"
