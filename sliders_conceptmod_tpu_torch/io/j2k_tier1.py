"""JPEG 2000 tier-1 decoding (ITU-T T.800 Annexes C and D) as OpenJPEG
2.5's ``t1.c`` and ``mqc.c`` decode it, for ``io/jpeg2000.py``.

A code-block is sequential within itself: each of its MQ decisions depends
on the coder's state and on its neighbours' significance. So the
code-blocks of a tile run in lockstep as numpy lanes: every lane steps
through the same passes (cleanup, significance propagation, magnitude
refinement, ...) and the same stripe-scan positions together, each with its
own bit-plane, its own MQ registers and contexts, and a mask for the lanes
that have a decision to decode at that position. Each coefficient keeps one
packed word: its significant horizontal, vertical and diagonal neighbours,
their sign sums, and its own significance, visited and refined bits (and
one for positions outside a smaller block), updated when a neighbour
becomes significant, so a context is one gather and a table lookup.

Code-block styles: selective arithmetic-coding bypass (raw segments from
the fifth bit-plane on, OpenJPEG's test of the segment's first pass),
context reset after each pass, termination on each pass (one segment per
pass), vertically causal contexts (a stripe's last row does not see the
row below), predictable termination (nothing to do when decoding) and
segmentation symbols (four UNIFORM decisions after each cleanup pass).

The value of a coefficient keeps one bit below its lowest decoded plane,
as OpenJPEG keeps it: significance sets ``±(1.5 · 2^p)`` in units of that
half bit, each refinement moves it by half the plane's step. The caller
applies the ROI shift, then halves (reversible) or scales (irreversible).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# MQ coder probability states (T.800 Table C.2)
_QE = np.array([0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
                0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
                0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
                0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601], np.int64)
_NMPS = np.array([1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                  28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46], np.int64)
_NLPS = np.array([1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23,
                  24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46], np.int64)
_SWITCH = np.array([1, 0, 0, 0, 0, 0, 1] + [0] * 7 + [1] + [0] * 32, np.int64)
# OpenJPEG's 94 states: state · 2 + MPS, the exchanges and switches folded in
_QE2 = np.repeat(_QE, 2)
_MPS2 = np.tile([0, 1], 47)
_NMPS2 = (2 * np.repeat(_NMPS, 2) + _MPS2).astype(np.int64)
_NLPS2 = (2 * np.repeat(_NLPS, 2) + (_MPS2 ^ np.repeat(_SWITCH, 2))).astype(np.int64)
# the shifts that bring A (below 0x8000) back to 0x8000 or above
_RENORM = np.zeros(1 << 16, np.int64)
_RENORM[1:0x8000] = 15 - np.floor(np.log2(np.arange(1, 0x8000))).astype(np.int64)

CTX_MAG, CTX_AGG, CTX_UNI = 14, 17, 18  # the zero-coding contexts are 0–8, sign coding 9–13

# code-block style bits (COD/COC SPcod)
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


# the packed word of each coefficient
_D, _V, _H, _SV, _SH = 0, 3, 5, 7, 10  # field shifts: d count, v count, h count, v sign sum + 2, h sign sum + 2
SIG, PI, MU, OUT = 1 << 13, 1 << 14, 1 << 15, 1 << 16
_NB = 0x7F  # the three neighbour counts
_BLANK = (2 << _SV) | (2 << _SH)


def _zc_table() -> np.ndarray:
    """Zero-coding context by (band, neighbour counts): OpenJPEG's
    ``t1_init_ctxno_zc`` as its lookup table files it (band 1, HL, the
    horizontally high-pass one, swaps h and v; 3 is the diagonal band)."""
    t = np.zeros((4, 128), np.int64)
    for o in range(4):
        for idx in range(128):
            d, v, h = idx & 7, (idx >> _V) & 3, (idx >> _H) & 3
            if d > 4 or v > 2 or h > 2:
                continue
            hh, vv = (v, h) if o == 1 else (h, v)
            if o == 3:
                hv = hh + vv
                n = ((0, 1, 2)[min(hv, 2)] if d == 0 else (3, 4, 5)[min(hv, 2)] if d == 1
                     else (6 if hv == 0 else 7) if d == 2 else 8)
            elif hh == 0:
                n = (0 if d == 0 else 1 if d == 1 else 2) if vv == 0 else 3 if vv == 1 else 4
            elif hh == 1:
                n = (5 if d == 0 else 6) if vv == 0 else 7
            else:
                n = 8
            t[o, idx] = n
    return t


def _sc_tables():
    """Sign coding (T.800 Table D.3) by the packed sign sums: the context
    and the bit the decision is XORed with."""
    ctx = np.zeros(64, np.int64)
    xor = np.zeros(64, np.int64)
    by_hv = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
             (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}
    for idx in range(64):
        sv, sh = (idx & 7) - 2, (idx >> 3) - 2
        ctx[idx], xor[idx] = by_hv[(max(-1, min(1, sh)), max(-1, min(1, sv)))]
    return ctx, xor


_ZC = _zc_table()
_SC_CTX, _SC_XOR = _sc_tables()


class _Lanes:
    """The state of every lane: coefficients, their packed words, MQ
    registers and contexts."""

    def __init__(self, blocks: Sequence[dict]):
        n = len(blocks)
        self.n = n
        hl = np.array([b["h"] for b in blocks], np.int64)
        wl = np.array([b["w"] for b in blocks], np.int64)
        self.H, self.W = int(hl.max()), int(wl.max())
        f = np.full((n, self.H + 2, self.W + 2), OUT | _BLANK, np.int64)  # sign sums offset everywhere: no borrows
        for i, b in enumerate(blocks):
            f[i, 1 : b["h"] + 1, 1 : b["w"] + 1] = _BLANK
        self.f = f
        self.flat = f.reshape(-1)
        self.stride = self.W + 2
        self.base = np.arange(n, dtype=np.int64) * (self.H + 2) * (self.W + 2)
        self.val = np.zeros((n, self.H + 2, self.W + 2), np.int64)
        self.orient = np.array([b["orient"] for b in blocks], np.int64)
        self.A = np.zeros(n, np.int64)
        self.C = np.zeros(n, np.int64)
        self.CT = np.zeros(n, np.int64)
        self.BP = np.zeros(n, np.int64)
        self.state = np.zeros((n, 19), np.int64)  # the 94-state index of each context
        self.raw = np.zeros(n, bool)
        # each segment's bytes then an artificial FF FF marker, as opj_mqc_init_dec writes it
        datas, starts = [], []
        for b in blocks:
            buf, st = bytearray(), []
            for seg, _ in b["segments"]:
                st.append(len(buf))
                buf += seg + b"\xff\xff"
            datas.append(buf)
            starts.append(st)
        width = max(len(d) for d in datas) + 2
        self.data = np.full((n, width), 0xFF, np.int64)
        for i, d in enumerate(datas):
            self.data[i, : len(d)] = np.frombuffer(bytes(d), np.uint8)
        self.seg_starts = starts
        # What opj_mqc_bytein adds to C, and the CT it sets, depends on the
        # bytes alone: each segment's sequence is laid out once, the last
        # entry (the marker, which it never passes) repeated at need.
        self.seq_add = np.zeros((n, width + 2), np.int64)
        self.seq_ct = np.zeros((n, width + 2), np.int64)
        self.seq_first: List[List[int]] = []
        self.seq_last: List[List[int]] = []
        for i, d in enumerate(datas):
            firsts, lasts = [], []
            at = 0
            for bp in starts[i]:
                firsts.append(at)
                while True:
                    b0, b1 = d[bp], d[bp + 1]
                    if b0 == 0xFF and b1 > 0x8F:
                        self.seq_add[i, at], self.seq_ct[i, at] = 0xFF00, 8
                        break
                    self.seq_add[i, at], self.seq_ct[i, at] = (b1 << 9, 7) if b0 == 0xFF else (b1 << 8, 8)
                    bp += 1
                    at += 1
                lasts.append(at)
                at += 1
            self.seq_first.append(firsts)
            self.seq_last.append(lasts)
        self.K = np.zeros(n, np.int64)  # the next bytein's entry
        self.K_last = np.zeros(n, np.int64)  # the current segment's marker entry
        s = self.stride
        self.nb_all = np.array([-1, 1, s, s - 1, s + 1, -s, -s - 1, -s + 1], np.int64)

    def reset_contexts(self, ix: np.ndarray) -> None:
        self.state[ix] = 0
        self.state[ix, CTX_UNI] = 2 * 46
        self.state[ix, CTX_AGG] = 2 * 3
        self.state[ix, 0] = 2 * 4

    def init_mq(self, i: int, seg: int) -> None:
        """``opj_mqc_init_dec`` for lane ``i``'s segment ``seg``."""
        self.C[i] = int(self.data[i, self.seg_starts[i][seg]]) << 16
        self.K[i], self.K_last[i] = self.seq_first[i][seg], self.seq_last[i][seg]
        ix = np.array([i])
        self._bytein(ix)
        self.C[i] = (self.C[i] << 7) & 0xFFFFFFFF
        self.CT[i] -= 7
        self.A[i] = 0x8000

    def init_raw(self, i: int, seg: int) -> None:
        self.BP[i] = self.seg_starts[i][seg]
        self.C[i] = 0
        self.CT[i] = 0

    def _bytein(self, ix: np.ndarray) -> None:
        k = self.K[ix]
        self.C[ix] += self.seq_add[ix, k]
        self.CT[ix] = self.seq_ct[ix, k]
        self.K[ix] = np.minimum(k + 1, self.K_last[ix])

    def decode(self, ix: np.ndarray, cx) -> np.ndarray:
        """One MQ decision for each lane in ``ix``, each in its context ``cx``
        (T.800 C.3.2, as OpenJPEG's ``opj_mqc_decode_macro``)."""
        st = self.state[ix, cx]
        qe = _QE2[st]
        a = self.A[ix] - qe
        c = self.C[ix]
        lps = (c >> 16) < qe
        c = np.where(lps, c, c - (qe << 16))
        renorm = lps | (a < 0x8000)
        # the LPS path exchanges when a < qe (the MPS); the MPS path needing renormalisation the reverse
        lose = renorm & (lps ^ (a < qe))
        d = _MPS2[st] ^ lose
        self.state[ix, cx] = np.where(renorm, np.where(lose, _NLPS2[st], _NMPS2[st]), st)
        a = np.where(lps, qe, a)
        n = _RENORM[a]
        self.A[ix] = a << n
        ct = self.CT[ix]
        short = np.flatnonzero(n > ct)
        if short.size:  # a byte in when CT reaches 0 (at most twice in one renormalisation)
            n = n.copy()
            n[short] = 0
            j = ix[short]
            cs, ns, cts = c[short], _RENORM[a[short]], ct[short]
            while True:
                cs = (cs << cts) & 0xFFFFFFFF
                ns = ns - cts
                kk = self.K[j]
                cs = cs + self.seq_add[j, kk]
                cts = self.seq_ct[j, kk]
                self.K[j] = np.minimum(kk + 1, self.K_last[j])
                if not (ns > cts).any():
                    break
                more = ns > cts
                done = ~more
                if done.any():
                    c[short[done]] = (cs[done] << ns[done]) & 0xFFFFFFFF
                    ct[short[done]] = cts[done] - ns[done]
                short, j, cs, ns, cts = short[more], j[more], cs[more], ns[more], cts[more]
            c[short] = (cs << ns) & 0xFFFFFFFF
            ct[short] = cts - ns
        c = (c << n) & 0xFFFFFFFF
        self.CT[ix] = ct - n
        self.C[ix] = c
        return d

    def raw_bit(self, ix: np.ndarray) -> np.ndarray:
        """``opj_mqc_raw_decode`` for each lane in ``ix``: bits most
        significant first, seven after a 0xFF byte, 1s at a marker."""
        need = self.CT[ix] == 0
        if need.any():
            j = ix[need]
            bp = self.BP[j]
            byte = self.data[j, bp]
            after_ff = self.C[j] == 0xFF
            hold = after_ff & (byte > 0x8F)
            self.C[j] = np.where(hold, 0xFF, byte)
            self.BP[j] = bp + ~hold
            self.CT[j] = np.where(hold, 8, np.where(after_ff, 7, 8))
        self.CT[ix] -= 1
        return (self.C[ix] >> self.CT[ix]) & 1

    def significant(self, ix: np.ndarray, pos: int, negative: np.ndarray, vsc_first_row: bool, mag) -> None:
        """Mark flat position ``pos`` significant in lanes ``ix`` (value
        ``±mag``) and feed its neighbours' counts and sign sums."""
        at = self.base[ix] + pos
        self.flat[at] |= SIG
        self.val.reshape(-1)[at] = np.where(negative == 1, -mag, mag)
        c = 1 - 2 * negative
        dh = (1 << _H) + (c << _SH)
        dv = (1 << _V) + (c << _SV)
        nbs = self.nb_all[:5] if vsc_first_row else self.nb_all
        delta = np.empty((ix.size, nbs.size), np.int64)
        delta[:, :2] = dh[:, None]
        delta[:, 2] = dv
        delta[:, 3:5] = 1 << _D
        if not vsc_first_row:
            delta[:, 5] = dv
            delta[:, 6:8] = 1 << _D
        self.flat[at[:, None] + nbs[None, :]] += delta


def decode_codeblocks(blocks: Sequence[dict]) -> List[np.ndarray]:
    """Each block (``w``, ``h``, ``orient`` 0–3, ``numbps``, ``roishift``,
    ``style`` bits, ``segments`` [(bytes, passes)]) → its coefficients
    ``[h, w]`` int64 with OpenJPEG's extra half bit. All blocks share one
    style; the caller groups them."""
    if not blocks:
        return []
    style = blocks[0]["style"]
    lanes = _Lanes(blocks)
    n = len(blocks)
    start = np.array([b["roishift"] + b["numbps"] for b in blocks], np.int64)
    numbps = np.array([b["numbps"] for b in blocks], np.int64)
    # the pass at which each segment starts, per lane
    seg_first = []
    total = np.zeros(n, np.int64)
    for i, b in enumerate(blocks):
        firsts, k = [], 0
        for _, p in b["segments"]:
            firsts.append(k)
            k += p
        seg_first.append(firsts)
        total[i] = k if start[i] < 31 else 0
    lanes.reset_contexts(np.arange(n))
    vsc = bool(style & VSC)
    lazy = bool(style & LAZY)
    seg_no = np.zeros(n, np.int64)
    for k in range(int(total.max())):
        passtype = (k + 2) % 3
        bpno = start - (k + 2) // 3
        active = (k < total) & (bpno >= 1)
        if not active.any():
            break
        # segment starts at this pass: MQ or raw, as opj_t1_decode_cblk picks it
        for i in np.nonzero(active)[0]:
            s = seg_no[i]
            if s < len(seg_first[i]) and seg_first[i][s] == k:
                raw = lazy and bpno[i] <= numbps[i] - 4 and passtype < 2
                (lanes.init_raw if raw else lanes.init_mq)(i, s)
                lanes.raw[i] = raw
                seg_no[i] = s + 1
        act = np.nonzero(active)[0]
        one = np.zeros(n, np.int64)
        one[act] = 1 << bpno[act]
        if passtype == 0:
            _sigpass(lanes, act, one, vsc, lazy)
        elif passtype == 1:
            _refpass(lanes, act, one, lazy)
        else:
            _clnpass(lanes, act, one, vsc, bool(style & SEGSYM))
        if style & RESET:
            mq = act[~lanes.raw[act]]
            if mq.size:
                lanes.reset_contexts(mq)
    return [lanes.val[i, 1 : b["h"] + 1, 1 : b["w"] + 1].copy() for i, b in enumerate(blocks)]


def _stripe_scan(lanes: _Lanes):
    """Stripe-scan order: (flat position, row in stripe)."""
    s = lanes.stride
    for y0 in range(0, lanes.H, 4):
        for x in range(lanes.W):
            for r in range(min(4, lanes.H - y0)):
                yield (y0 + r + 1) * s + x + 1, r


def _split(lanes: _Lanes, ix: np.ndarray, lazy: bool):
    """The lanes in an MQ segment and those in a raw one."""
    if not lazy:
        return ix, ix[:0]
    raw = lanes.raw[ix]
    return ix[~raw], ix[raw]


def _decode_sign(lanes: _Lanes, ix, words, raw: bool):
    if raw:
        return lanes.raw_bit(ix)
    k = (words >> _SV) & 63
    return lanes.decode(ix, _SC_CTX[k]) ^ _SC_XOR[k]


def _sigpass(lanes: _Lanes, act: np.ndarray, one: np.ndarray, vsc: bool, lazy: bool) -> None:
    flat, base = lanes.flat, lanes.base[act]
    for pos, r in _stripe_scan(lanes):
        w = flat[base + pos]
        cand = np.flatnonzero(((w & (SIG | PI | OUT)) == 0) & ((w & _NB) != 0))
        if not cand.size:
            continue
        ix, w = act[cand], w[cand]
        for j, raw in zip(_split(lanes, ix, lazy), (False, True)):
            if not j.size:
                continue
            wj = w if j.size == ix.size else w[np.isin(ix, j)]
            v = lanes.raw_bit(j) if raw else lanes.decode(j, _ZC[lanes.orient[j], wj & _NB])
            hit = v == 1
            if hit.any():
                h = j[hit]
                neg = _decode_sign(lanes, h, wj[hit], raw)
                lanes.significant(h, pos, neg, vsc and r == 0, one[h] | (one[h] >> 1))
            flat[lanes.base[j] + pos] |= PI


def _refpass(lanes: _Lanes, act: np.ndarray, one: np.ndarray, lazy: bool) -> None:
    """Refinement does not change what is significant or visited: the
    lanes to refine at each position, and their contexts but for the
    refined bit set as the pass goes, are read once."""
    flat = lanes.flat
    vflat = lanes.val.reshape(-1)
    order = np.array([pos for pos, _ in _stripe_scan(lanes)], np.int64)
    words = flat[lanes.base[act][:, None] + order[None, :]]
    steps, lanes_at = np.nonzero(((words & (SIG | PI)) == SIG).T)  # by scan step, then lane
    if not steps.size:
        return
    cuts = np.flatnonzero(np.diff(steps)) + 1
    ctx_all = np.where(words & MU, CTX_MAG + 2, CTX_MAG + ((words & _NB) != 0))
    for ts, g in zip(np.split(steps, cuts), np.split(lanes_at, cuts)):
        t = ts[0]
        pos = order[t]
        ix = act[g]
        for j, raw in zip(_split(lanes, ix, lazy), (False, True)):
            if not j.size:
                continue
            if raw:
                v = lanes.raw_bit(j)
            else:
                v = lanes.decode(j, ctx_all[g if j.size == ix.size else g[np.isin(ix, j)], t])
            at = lanes.base[j] + pos
            cur = vflat[at]
            half = one[j] >> 1
            vflat[at] = cur + np.where((v ^ (cur < 0)) == 1, half, -half)
            flat[at] |= MU


def _clnpass(lanes: _Lanes, act: np.ndarray, one: np.ndarray, vsc: bool, segsym: bool) -> None:
    flat, base = lanes.flat, lanes.base[act]
    s = lanes.stride
    quiet_mask = SIG | PI | OUT | _NB
    for y0 in range(0, lanes.H, 4):
        rows = min(4, lanes.H - y0)
        for x in range(lanes.W):
            top = (y0 + 1) * s + x + 1
            col = top + s * np.arange(rows)
            words = flat[base[:, None] + col[None, :]]
            todo = np.ones((act.size, rows), bool)  # rows still to code in each lane
            if rows == 4:
                # run-length mode: four insignificant, unvisited coefficients without significant neighbours
                quiet = ((words & quiet_mask) == 0).all(axis=1)
                if quiet.any():
                    q = np.nonzero(quiet)[0]
                    agg = act[q]
                    bit = lanes.decode(agg, CTX_AGG)
                    todo[q] = False
                    go = bit == 1
                    if go.any():
                        g, lane = q[go], agg[go]
                        run = lanes.decode(lane, CTX_UNI) << 1
                        run |= lanes.decode(lane, CTX_UNI)
                        wr = words[g, run]
                        neg = _decode_sign(lanes, lane, wr, False)
                        for r in range(4):
                            at = run == r
                            if at.any():
                                h = lane[at]
                                lanes.significant(h, top + r * s, neg[at], vsc and r == 0, one[h] | (one[h] >> 1))
                        todo[g] = np.arange(4)[None, :] > run[:, None]
            for r in range(rows):
                pos = top + r * s
                live = todo[:, r]
                if not live.any():
                    continue
                w = flat[base[live] + pos]
                cand = (w & (SIG | PI | OUT)) == 0
                if not cand.any():
                    continue
                j = act[live][cand]
                w = w[cand]
                v = lanes.decode(j, _ZC[lanes.orient[j], w & _NB])
                hit = v == 1
                if hit.any():
                    h = j[hit]
                    neg = _decode_sign(lanes, h, w[hit], False)
                    lanes.significant(h, pos, neg, vsc and r == 0, one[h] | (one[h] >> 1))
    lanes.f[act] &= ~PI
    if segsym:
        for _ in range(4):
            lanes.decode(act, CTX_UNI)
