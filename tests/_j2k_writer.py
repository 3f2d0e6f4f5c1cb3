"""A small JPEG 2000 codestream writer for the decoder tests: what Pillow's
OpenJPEG encoder never writes. One tile, 8-bit unsigned components, the
reversible 5/3 transform at any number of levels, one precinct a
resolution, and:

* every code-block style: selective bypass (raw sig/ref passes from the
  fifth bit-plane on), context reset, termination on each pass, vertically
  causal contexts, predictable termination (OpenJPEG's ``erterm``) and
  segmentation symbols;
* several layers, the passes of each code-block spread over them;
* the five progression orders, and POC markers;
* SOP and EPH markers, packet headers moved into PPM or PPT markers;
* a region of interest coded by maxshift (RGN).

The MQ coder and the passes follow T.800 Annexes C and D; the tests take
Pillow's decode of each file as the reference, so the writer's own choices
(truncation points, termination padding) need only give files OpenJPEG
reads."""

import struct

import numpy as np

# MQ coder states (T.800 Table C.2)
QE = [0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601,
      0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401,
      0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025,
      0x0015, 0x0009, 0x0005, 0x0001, 0x5601]
NMPS = [1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
        31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46]
NLPS = [1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25,
        26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46]
SWITCH = [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1] + [0] * 32
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
UNI, AGG = 18, 17
ORDERS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


class MQEncoder:
    """T.800 C.2 (OpenJPEG's ``mqc.c`` conventions: a dummy byte before
    the output, carries into it, FLUSH or ``erterm`` at a segment's end)."""

    def __init__(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.reset_contexts()
        self.restart()

    def reset_contexts(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[UNI], self.state[AGG], self.state[0] = 46, 3, 4

    def restart(self):
        self.buf = bytearray([0])
        self.bp = 0
        self.a, self.c, self.ct = 0x8000, 0, 12

    def _byteout(self):
        def put(v):
            self.bp += 1
            if self.bp == len(self.buf):
                self.buf.append(0)
            self.buf[self.bp] = v & 0xFF

        if self.buf[self.bp] == 0xFF:
            put(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            put(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.buf[self.bp] += 1
            if self.buf[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                put(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                put(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d: int, cx: int):
        st = self.state[cx]
        qe = QE[st]
        if d == self.mps[cx]:
            self.a -= qe
            if self.a & 0x8000 == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.state[cx] = NMPS[st]
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if SWITCH[st]:
                self.mps[cx] = 1 - self.mps[cx]
            self.state[cx] = NLPS[st]
            self._renorm()

    def numbytes(self) -> int:
        return self.bp

    def flush(self, erterm: bool = False) -> bytes:
        if erterm:
            k = 11 - self.ct + 1
            while k > 0:
                self.c <<= self.ct
                self.ct = 0
                self._byteout()
                k -= self.ct
            if self.buf[self.bp] != 0xFF:
                self._byteout()
            end = self.bp + (self.buf[self.bp] != 0xFF)
            return bytes(self.buf[1:end])
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        end = self.bp + (self.buf[self.bp] != 0xFF)
        return bytes(self.buf[1:end])


class RawEncoder:
    """Bypass coding: bits most significant first, seven after a 0xFF."""

    def __init__(self):
        self.out, self.c, self.ct = bytearray(), 0, 8

    def encode(self, d: int, cx=None):
        self.ct -= 1
        self.c += d << self.ct
        if self.ct == 0:
            self.out.append(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0

    def numbytes(self) -> int:
        return len(self.out)

    def flush(self, erterm: bool = False) -> bytes:
        if self.ct < 7 or (self.ct == 7 and (erterm or (self.out and self.out[-1] != 0xFF))):
            bit = 0
            while self.ct > 0:
                self.ct -= 1
                self.c += bit << self.ct
                bit = 1 - bit
            self.out.append(self.c)
        elif self.ct == 7 and self.out and self.out[-1] == 0xFF:
            self.out.pop()
        return bytes(self.out)


def _zc(h, v, d, band):
    if band == 1:
        h, v = v, h
    if band == 3:
        hv = h + v
        if d == 0:
            return min(hv, 2)
        if d == 1:
            return 3 + min(hv, 2)
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if h == 0:
        return (0 if d == 0 else 1 if d == 1 else 2) if v == 0 else 3 if v == 1 else 4
    if h == 1:
        return (5 if d == 0 else 6) if v == 0 else 7
    return 8


_SC = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
       (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}


def encode_codeblock(q: np.ndarray, band: int, style: int, start_plane: int):
    """Coefficients ``q`` [h, w] (ints) → (segments [(bytes, passes)],
    bytes needed after each pass), coded from bit-plane ``start_plane``."""
    h, w = q.shape
    mag = np.abs(q)
    neg = (q < 0).astype(int)
    sig = np.zeros((h + 2, w + 2), int)
    sgn = np.zeros((h + 2, w + 2), int)
    visited = np.zeros((h, w), int)
    refined = np.zeros((h, w), int)
    vsc = bool(style & VSC)

    def nb(y, x):
        s = sig
        south = 0 if (vsc and y % 4 == 3) else 1
        hh = s[y + 1, x] + s[y + 1, x + 2]
        vv = s[y, x + 1] + s[y + 2, x + 1] * south
        dd = s[y, x] + s[y, x + 2] + (s[y + 2, x] + s[y + 2, x + 2]) * south
        return hh, vv, dd, south

    def sign_ctx(y, x):
        south = 0 if (vsc and y % 4 == 3) else 1

        def contrib(yy, xx, use=1):
            return use * sig[yy, xx] * (1 - 2 * sgn[yy, xx])

        hs = max(-1, min(1, contrib(y + 1, x) + contrib(y + 1, x + 2)))
        vs = max(-1, min(1, contrib(y, x + 1) + contrib(y + 2, x + 1, south)))
        return _SC[(hs, vs)]

    def set_sig(y, x):
        sig[y + 1, x + 1] = 1
        sgn[y + 1, x + 1] = neg[y, x]

    def scan():
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    yield y, x

    segments = []
    lengths = []
    npasses = 3 * start_plane + 1 if start_plane >= 0 else 0
    plane = start_plane
    ptype = 2
    coder = None
    seg_passes = 0
    seg_raw = False
    mq = MQEncoder()
    erterm = bool(style & PTERM)
    for k in range(npasses):
        raw = bool(style & LAZY) and k >= 10 and ptype < 2
        seg_start = coder is None
        if seg_start:
            if raw:
                coder = RawEncoder()
            else:
                mq.restart()
                coder = mq
            seg_raw = raw
        bit = 1 << plane
        if ptype == 0:
            for y, x in scan():
                if sig[y + 1, x + 1] or visited[y, x]:
                    continue
                hh, vv, dd, _ = nb(y, x)
                if hh + vv + dd == 0:
                    continue
                d = 1 if mag[y, x] & bit else 0
                coder.encode(d, _zc(hh, vv, dd, band))
                if d:
                    ctx, xorbit = sign_ctx(y, x)
                    coder.encode(neg[y, x] if seg_raw else neg[y, x] ^ xorbit, ctx)
                    set_sig(y, x)
                visited[y, x] = 1
        elif ptype == 1:
            for y, x in scan():
                if not sig[y + 1, x + 1] or visited[y, x]:
                    continue
                hh, vv, dd, _ = nb(y, x)
                ctx = 16 if refined[y, x] else (15 if hh + vv + dd else 14)
                coder.encode(1 if mag[y, x] & bit else 0, ctx)
                refined[y, x] = 1
        else:
            for y0 in range(0, h, 4):
                for x in range(w):
                    rows = list(range(y0, min(y0 + 4, h)))
                    start = 0
                    if len(rows) == 4 and all(not sig[y + 1, x + 1] and not visited[y, x] and sum(nb(y, x)[:3]) == 0
                                              for y in rows):
                        bits = [1 if mag[y, x] & bit else 0 for y in rows]
                        if not any(bits):
                            coder.encode(0, AGG)
                            continue
                        coder.encode(1, AGG)
                        r = bits.index(1)
                        coder.encode(r >> 1, UNI)
                        coder.encode(r & 1, UNI)
                        y = rows[r]
                        ctx, xorbit = sign_ctx(y, x)
                        coder.encode(neg[y, x] ^ xorbit, ctx)
                        set_sig(y, x)
                        start = r + 1
                    for y in rows[start:]:
                        if sig[y + 1, x + 1] or visited[y, x]:
                            continue
                        hh, vv, dd, _ = nb(y, x)
                        d = 1 if mag[y, x] & bit else 0
                        coder.encode(d, _zc(hh, vv, dd, band))
                        if d:
                            ctx, xorbit = sign_ctx(y, x)
                            coder.encode(neg[y, x] ^ xorbit, ctx)
                            set_sig(y, x)
            visited[:] = 0
            if style & SEGSYM:
                for b in (1, 0, 1, 0):
                    coder.encode(b, UNI)
        if style & RESET and not seg_raw:
            mq.reset_contexts()
        seg_passes += 1
        # the segment ends here: termination on each pass, or bypass changing the coder next
        nxt = k + 1
        next_raw = bool(style & LAZY) and nxt >= 10 and ((ptype + 1) % 3) < 2
        done = nxt == npasses or style & TERMALL or (style & LAZY and nxt >= 10 and next_raw != seg_raw)
        before = sum(len(s) for s, _ in segments)
        if done:
            data = coder.flush(erterm)
            segments.append((data, seg_passes))
            lengths.append(before + len(data))
            coder, seg_passes = None, 0
        else:
            lengths.append(before + coder.numbytes())
        ptype = (ptype + 1) % 3
        if ptype == 0:
            plane -= 1
    # a pass's truncation point never passes its segment's end
    ends = []
    total = 0
    for data, p in segments:
        total += len(data)
        ends += [total] * p
    lengths = [min(a, b) for a, b in zip(np.maximum.accumulate(lengths).tolist(), ends)]
    return segments, lengths


def _fwd53(a: np.ndarray) -> np.ndarray:
    """One forward 5/3 level along the last axis (even start): [low | high]."""
    n = a.shape[-1]
    if n == 1:
        return a.copy()
    x = a.astype(np.int64).copy()
    idx = np.arange(n)
    odd = idx[1::2]
    left, right = odd - 1, np.where(odd + 1 < n, odd + 1, odd - 1)
    x[..., odd] -= (x[..., left] + x[..., right]) >> 1
    even = idx[0::2]
    left = np.where(even - 1 >= 0, even - 1, even + 1)
    right = np.where(even + 1 < n, even + 1, even - 1)
    x[..., even] += (x[..., left] + x[..., right] + 2) >> 2
    return np.concatenate([x[..., 0::2], x[..., 1::2]], axis=-1)


class _BitWriter:
    def __init__(self):
        self.out, self.byte, self.n = bytearray(), 0, 0

    def bit(self, b: int):
        limit = 7 if self.out and self.out[-1] == 0xFF else 8
        self.byte = (self.byte << 1) | b
        self.n += 1
        if self.n == limit:
            self.out.append(self.byte)
            self.byte, self.n = 0, 0

    def bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self) -> bytes:
        limit = 7 if self.out and self.out[-1] == 0xFF else 8
        if self.n:
            self.out.append(self.byte << (limit - self.n))
            self.byte, self.n = 0, 0
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    def __init__(self, w: int, h: int, values):
        self.levels = []
        cur = np.array(values, np.int64).reshape(h, w)
        while True:
            self.levels.append(cur)
            if cur.size <= 1:
                break
            hh, ww = -(-cur.shape[0] // 2), -(-cur.shape[1] // 2)
            nxt = np.full((hh, ww), 1 << 30, np.int64)
            for y in range(cur.shape[0]):
                for x in range(cur.shape[1]):
                    nxt[y // 2, x // 2] = min(nxt[y // 2, x // 2], cur[y, x])
            cur = nxt
        self.low = [np.zeros_like(v) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]

    def encode(self, bw: _BitWriter, leaf: int, threshold: int):
        w = self.levels[0].shape[1]
        path = []
        y, x = divmod(leaf, w)
        for li in range(len(self.levels)):
            path.append((li, y, x))
            y, x = y // 2, x // 2
        low = 0
        for li, y, x in reversed(path):
            if low > self.low[li][y, x]:
                self.low[li][y, x] = low
            else:
                low = self.low[li][y, x]
            while low < threshold:
                if low >= self.levels[li][y, x]:
                    if not self.known[li][y, x]:
                        bw.bit(1)
                        self.known[li][y, x] = True
                    break
                bw.bit(0)
                low += 1
            self.low[li][y, x] = low


def write_j2k(planes, levels: int = 1, cblk=(4, 4), style: int = 0, layers: int = 1, order: str = "LRCP",
              poc=None, sop: bool = False, eph: bool = False, headers: str = "", roi=None) -> bytes:
    """``planes``: a list of uint8 ``[h, w]`` components → a codestream.
    ``headers``: "" (in the packets), "ppm" or "ppt". ``roi``: (shift,
    (y0, y1, x0, x1)) in each band's own coordinates scaled from the image's."""
    planes = [np.asarray(p, np.int64) - 128 for p in planes]
    nc = len(planes)
    h, w = planes[0].shape
    guard = 2
    # bands per component: resolution 0 the LL, then (HL, LH, HH) for each level up
    comps = []
    for x in planes:
        bands = {}
        ll = x
        for lvl in range(levels, 0, -1):
            t = _fwd53(_fwd53(ll.T).T)  # vertical, then horizontal
            hh_, ww_ = ll.shape
            lh, lw = -(-hh_ // 2), -(-ww_ // 2)
            r = levels - lvl + 1
            bands[(r, 1)] = t[:lh, lw:]
            bands[(r, 2)] = t[lh:, :lw]
            bands[(r, 3)] = t[lh:, lw:]
            ll = t[:lh, :lw]
        bands[(0, 0)] = ll
        comps.append(bands)
    gain = {0: 0, 1: 1, 2: 1, 3: 2}
    expn = {b: 8 + gain[b] for b in range(4)}
    roishift = 0
    if roi:
        roishift, (ry0, ry1, rx0, rx1) = roi
        for bands in comps:
            for (r, b), arr in bands.items():
                scale = 1 << (levels - r + (1 if r else 0)) if r else 1 << levels
                ys, xs = slice(ry0 // scale, -(-ry1 // scale)), slice(rx0 // scale, -(-rx1 // scale))
                part = arr[ys, xs]
                arr[ys, xs] = np.sign(part) * (np.abs(part) << roishift)
    cbw, cbh = cblk
    # code each code-block
    blocks = {}  # (c, r, b) → list of (bx, by, segments, lengths, zero bit-planes, passes)
    for c, bands in enumerate(comps):
        for (r, b), arr in bands.items():
            mb = expn[b] + guard - 1
            out = []
            bh, bw = arr.shape
            for by in range(0, max(bh, 1), 1 << cbh):
                for bx in range(0, max(bw, 1), 1 << cbw):
                    q = arr[by : by + (1 << cbh), bx : bx + (1 << cbw)]
                    if q.size == 0:
                        continue
                    top = int(np.abs(q).max()).bit_length()
                    numbps = max(top - roishift, 0) if roishift else top
                    planes_coded = numbps + roishift
                    segs, lens = encode_codeblock(q, b, style, planes_coded - 1)
                    out.append(dict(segs=segs, lens=lens, zbp=mb - numbps, passes=len(lens)))
            blocks[(c, r, b)] = (out, -(-bw // (1 << cbw)) if bw else 0, -(-bh // (1 << cbh)) if bh else 0)
    # spread each block's passes over the layers
    for out, _, _ in blocks.values():
        for blk in out:
            n = blk["passes"]
            blk["cut"] = [round(n * (l + 1) / layers) for l in range(layers)]
            blk["first"] = next((l for l in range(layers) if blk["cut"][l] > 0), layers)
    # the packets, each once, in the progression (and POC) order: one precinct a resolution
    progs = poc or [(0, 0, layers, levels + 1, nc, ORDERS[order])]
    seen, packets = set(), []
    for rs, cs, le, re, ce, o in progs:
        keys = {0: lambda: [(l, r, c) for l in range(le) for r in range(rs, re) for c in range(cs, ce)],
                1: lambda: [(l, r, c) for r in range(rs, re) for l in range(le) for c in range(cs, ce)],
                2: lambda: [(l, r, c) for r in range(rs, re) for c in range(cs, ce) for l in range(le)],
                3: lambda: [(l, r, c) for c in range(cs, ce) for r in range(rs, re) for l in range(le)],
                4: lambda: [(l, r, c) for c in range(cs, ce) for r in range(rs, re) for l in range(le)]}[o]()
        for key in keys:
            if key not in seen:
                seen.add(key)
                packets.append(key)
    trees, lenbits, done = {}, {}, {}
    for (c, r, b), (out, cw, ch) in blocks.items():
        if out:
            trees[(c, r, b)] = (_TagTree(cw, ch, [blk["first"] for blk in out]),
                                _TagTree(cw, ch, [blk["zbp"] for blk in out]))
        for i in range(len(out)):
            lenbits[(c, r, b, i)] = 3
            done[(c, r, b, i)] = 0
    body, heads = bytearray(), bytearray()
    for seq, (l, r, c) in enumerate(packets):
        bw = _BitWriter()
        data = bytearray()
        band_ids = [0] if r == 0 else [1, 2, 3]
        contrib = []
        for b in band_ids:
            out, _, _ = blocks[(c, r, b)]
            for i, blk in enumerate(out):
                start, end = done[(c, r, b, i)], blk["cut"][l]
                contrib.append((b, i, blk, start, end))
        if not any(e > s for _, _, _, s, e in contrib):
            bw.bit(0)
        else:
            bw.bit(1)
            for b, i, blk, start, end in contrib:
                incl, zbp = trees[(c, r, b)]
                if blk["first"] >= l and start == 0:  # not included before
                    incl.encode(bw, i, l + 1)
                    if end == start:
                        continue
                    t = 0
                    while True:
                        zbp.encode(bw, i, t + 1)
                        if t >= blk["zbp"]:
                            break
                        t += 1
                else:
                    bw.bit(1 if end > start else 0)
                    if end == start:
                        continue
                n = end - start
                if n == 1:
                    bw.bit(0)
                elif n == 2:
                    bw.bits(0b10, 2)
                elif n <= 5:
                    bw.bits(0b1100 | (n - 3), 4)
                elif n <= 36:
                    bw.bits(0b111100000 | (n - 6), 9)
                else:
                    bw.bits((0b111111111 << 7) | (n - 37), 16)
                # the segments these passes fall in, and their bytes
                pieces = []
                p = start
                seg_end = 0
                for seg, sp in blk["segs"]:
                    seg_first, seg_end = seg_end, seg_end + sp
                    if seg_end <= p or seg_first >= end:
                        continue
                    take = min(end, seg_end) - p
                    first_byte = blk["lens"][p - 1] if p else 0
                    pieces.append((take, blk["lens"][p + take - 1] - first_byte))
                    p += take
                key = (c, r, b, i)
                need = max(max(ln.bit_length(), 1) - (t.bit_length() - 1) for t, ln in pieces)
                inc = max(0, need - lenbits[key])
                bw.bits((1 << (inc + 1)) - 2, inc + 1)
                lenbits[key] += inc
                for take, ln in pieces:
                    bw.bits(ln, lenbits[key] + take.bit_length() - 1)
                first_byte = blk["lens"][start - 1] if start else 0
                data += b"".join(s for s, _ in blk["segs"])[first_byte : blk["lens"][end - 1]]
                done[key] = end
        head = bw.flush() + (b"\xff\x92" if eph else b"")
        if headers:
            heads += head
        else:
            body += (b"\xff\x91\x00\x04" + struct.pack(">H", seq % 65536) if sop else b"") + head
            body += data
            continue
        body += (b"\xff\x91\x00\x04" + struct.pack(">H", seq % 65536) if sop else b"") + data
    # the codestream
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + b"\x07\x01\x01" * nc
    cod = struct.pack(">BBHBBBBBB", (2 if sop else 0) | (4 if eph else 0), ORDERS[order], layers, 0, levels,
                      cbw - 2, cbh - 2, style, 1)
    qcd = bytes([guard << 5]) + bytes((expn[0 if i == 0 else (i - 1) % 3 + 1]) << 3 for i in range(3 * levels + 1))

    def marker(code, payload):
        return struct.pack(">HH", code, len(payload) + 2) + payload

    main = b"\xff\x4f" + marker(0xFF51, siz) + marker(0xFF52, cod) + marker(0xFF5C, qcd)
    if roi:
        for c in range(nc):
            main += marker(0xFF5E, bytes([c, 0, roishift]))
    if poc:
        main += marker(0xFF5F, b"".join(struct.pack(">BBHBBB", *p) for p in poc))
    tile_head = b""
    if headers == "ppm":
        main += marker(0xFF60, b"\x00" + struct.pack(">I", len(heads)) + bytes(heads))
    elif headers == "ppt":
        tile_head = marker(0xFF61, b"\x00" + bytes(heads))
    psot = 12 + len(tile_head) + 2 + len(body)
    sot = b"\xff\x90" + struct.pack(">HHIBB", 10, 0, psot, 0, 1)
    return main + sot + tile_head + b"\xff\x93" + bytes(body) + b"\xff\xd9"
