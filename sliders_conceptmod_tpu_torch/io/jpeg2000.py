"""JPEG 2000 decoding in numpy and plain Python, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``Jpeg2KImagePlugin`` over OpenJPEG 2.5 (the GPU machine has no PIL).

* The container: a JP2 file's boxes (``jp2h`` with ``ihdr``, ``colr``,
  ``pclr``; ``jp2c``), or a bare codestream (``FF4F FF51``). The mode is
  Pillow's: from ``ihdr`` (or SIZ), CMYK where ``colr`` says so, P/PA where
  a palette of at most 8 bits follows grey. Pillow decodes tile by tile,
  so OpenJPEG applies neither palette nor channel definitions: a palette
  image's indices go through Pillow's palette.
* The codestream's markers: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT and
  tile-parts (SOT/SOD); TLM, PLM, PLT, COM and CRG are skipped. Parameters
  apply in order, a COD to every component, as OpenJPEG reads them.
* Tier-2 (``t2.c``, ``pi.c``): the five progression orders and POC
  changes over OpenJPEG's packet iterator, precincts, tag trees for
  inclusion and zero bit-planes, pass counts, length indicators and
  segments (one a pass with termination on each pass; 10, 2, 1, 2, ...
  passes with bypass), SOP and EPH markers, packet headers in PPM/PPT.
* Tier-1: ``io/j2k_tier1.py``. ROI: maxshift.
* Reconstruction (``tcd.c``): reversible coefficients halved with C's
  truncation; irreversible ones scaled in float32 by half the band's step,
  ``(1 + μ/2048) · 2^(prec − ε)`` rounded to float32; the inverse wavelet
  transform (``io/j2k_dwt.py``); RCT in integers or ICT in float32; the DC
  shift after ``lrintf`` (halves to even), clamped to the sample range.
* Pillow's unpacking (``Jpeg2KDecode.c``): each component read back as the
  unsigned word OpenJPEG stored it in (1, 2 or 4 bytes by precision), its
  sign offset added, shifted to 8 bits (16 for ``I;16``) with rounding when
  shifting down, and cut to the output's width; sYCC through Pillow's
  YCbCr → RGB; CMYK through ``cmyk2rgb``.

Components with sampling other than 1 × 1, colour spaces Pillow has no
unpacker for and Part 2 features are refused citing ROADMAP item 14, or as
Pillow refuses them.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from sliders_conceptmod_tpu_torch.io import j2k_dwt, j2k_tier1
from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, cmyk2rgb, error, refuse

_JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
# OpenJPEG's colour spaces
UNSPECIFIED, SRGB, GRAY, SYCC, CMYK, UNKNOWN = "unspecified", "srgb", "gray", "sycc", "cmyk", "unknown"
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 12: CMYK}


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"\xff\x4f\xff\x51" or prefix[:12] == _JP2_SIGNATURE


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------


def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of each box in ``data[pos:end]``."""
    while pos + 8 <= end:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            length = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif length == 0:
            length = end - pos
        if length < head:
            return
        yield kind, pos + head, min(pos + length, end)
        pos += length


def _jp2(data: bytes):
    """Pillow's ``_parse_jp2_header`` and OpenJPEG's colour space:
    (mode, palette or None, colour space, codestream)."""
    header = None
    codestream = None
    for kind, a, b in _boxes(data, 0, len(data)):
        if kind == b"jp2h" and header is None:
            header = (a, b)
        elif kind == b"jp2c" and codestream is None:
            codestream = data[a:b]
    if header is None:
        raise NotThisFormat("JPEG 2000: no jp2h box")
    mode = nc = None
    palette = None
    enumcs = 0
    saw_colr = False
    for kind, a, b in _boxes(data, *header):
        if kind == b"ihdr":
            _, _, nc, bpc = struct.unpack_from(">IIHB", data, a)
            mode = ("I;16" if (bpc & 0x7F) > 8 else "L") if nc == 1 else {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        elif kind == b"colr" and not saw_colr:  # OpenJPEG reads the first colour specification only
            saw_colr = True
            meth = data[a]
            if meth == 1:
                enumcs = struct.unpack_from(">I", data, a + 3)[0]
                if nc == 4 and enumcs == 12:
                    mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack_from(">HB", data, a)
            depths = data[a + 3 : a + 3 + npc]
            if max(depths) <= 8:
                if npc != 3:
                    raise refuse("JPEG 2000", f"a palette of {npc} columns")
                entries = np.frombuffer(data[a + 3 + npc : a + 3 + npc + ne * npc], np.uint8).reshape(ne, npc)
                # ImagePalette.getcolor: each new colour takes the next slot, a repeated one none
                colours: Dict[tuple, int] = {}
                for e in map(tuple, entries.tolist()):
                    colours.setdefault(e, len(colours))
                if len(colours) > 256:
                    raise error("JPEG 2000", "a palette of more than 256 colours (Pillow refuses it too)")
                palette = np.array(list(colours) or [(0, 0, 0)], np.uint8)
                mode = "P" if mode == "L" else "PA"
    if mode is None:
        raise NotThisFormat("JPEG 2000: malformed JP2 header")
    if codestream is None or codestream[:4] != b"\xff\x4f\xff\x51":
        raise error("JPEG 2000", "no codestream")
    return mode, palette, _ENUMCS.get(enumcs, UNKNOWN), codestream


# ---------------------------------------------------------------------------
# the codestream's markers
# ---------------------------------------------------------------------------


class _Comp:
    """Per tile-component coding parameters (COD/COC, QCD/QCC, RGN)."""

    def __init__(self):
        self.levels = 5
        self.xcb = self.ycb = 6
        self.style = 0
        self.reversible = True
        self.precincts: Optional[List[Tuple[int, int]]] = None
        self.quant_style = 0
        self.guard = 2
        self.steps: List[Tuple[int, int]] = []
        self.roishift = 0

    def copy(self) -> "_Comp":
        c = _Comp()
        c.__dict__.update({k: (list(v) if isinstance(v, list) else v) for k, v in self.__dict__.items()})
        return c


class _Coding:
    """COD's tile-wide part and every component's parameters."""

    def __init__(self, ncomp: int):
        self.sop = self.eph = False
        self.order = 0
        self.layers = 1
        self.mct = 0
        self.comps = [_Comp() for _ in range(ncomp)]
        self.poc: List[Tuple[int, int, int, int, int, int]] = []

    def copy(self) -> "_Coding":
        c = _Coding(0)
        c.__dict__.update(self.__dict__)
        c.comps = [x.copy() for x in self.comps]
        c.poc = list(self.poc)
        return c


def _spcod(seg: bytes, pos: int, comp: _Comp, with_precincts: bool) -> None:
    comp.levels = seg[pos]
    comp.xcb, comp.ycb = seg[pos + 1] + 2, seg[pos + 2] + 2
    comp.style = seg[pos + 3]
    comp.reversible = seg[pos + 4] == 1
    if comp.levels > 32 or comp.xcb + comp.ycb > 12:
        raise error("JPEG 2000", "bad coding style parameters")
    if with_precincts:
        pp = seg[pos + 5 : pos + 6 + comp.levels]
        if len(pp) < comp.levels + 1:
            raise error("JPEG 2000", "a truncated COD/COC")
        comp.precincts = [(b & 15, b >> 4) for b in pp]
    else:
        comp.precincts = None


def _quant(seg: bytes, pos: int, comp: _Comp) -> None:
    sq = seg[pos]
    comp.guard, comp.quant_style = sq >> 5, sq & 31
    body = seg[pos + 1 :]
    if comp.quant_style == 0:
        comp.steps = [(b >> 3, 0) for b in body]
    elif comp.quant_style in (1, 2):
        vals = struct.unpack(f">{len(body) // 2}H", body[: len(body) // 2 * 2])
        comp.steps = [(v >> 11, v & 0x7FF) for v in vals]
    else:
        raise error("JPEG 2000", f"quantization style {comp.quant_style}")


def _apply_marker(marker: int, seg: bytes, coding: _Coding, ncomp: int) -> None:
    """COD, COC, QCD, QCC, RGN or POC, applied to ``coding`` as OpenJPEG reads them."""
    cbytes = 1 if ncomp <= 256 else 2

    def comp_index(pos):
        return (seg[pos] if cbytes == 1 else struct.unpack_from(">H", seg, pos)[0]), pos + cbytes

    if marker == 0xFF52:  # COD
        scod = seg[0]
        coding.sop, coding.eph = bool(scod & 2), bool(scod & 4)
        coding.order, coding.layers, coding.mct = seg[1], struct.unpack_from(">H", seg, 2)[0], seg[4]
        for c in coding.comps:
            _spcod(seg, 5, c, bool(scod & 1))
    elif marker == 0xFF53:  # COC
        ci, pos = comp_index(0)
        if ci < ncomp:
            _spcod(seg, pos + 1, coding.comps[ci], bool(seg[pos] & 1))
    elif marker == 0xFF5C:  # QCD
        for c in coding.comps:
            _quant(seg, 0, c)
    elif marker == 0xFF5D:  # QCC
        ci, pos = comp_index(0)
        if ci < ncomp:
            _quant(seg, pos, coding.comps[ci])
    elif marker == 0xFF5E:  # RGN
        ci, pos = comp_index(0)
        if seg[pos] != 0:
            raise refuse("JPEG 2000", f"ROI style {seg[pos]}")
        if ci < ncomp:
            coding.comps[ci].roishift = seg[pos + 1]
    elif marker == 0xFF5F:  # POC
        step = 5 + 2 * cbytes
        for p in range(0, len(seg) - step + 1, step):
            rs = seg[p]
            cs, q = comp_index(p + 1)
            lye = struct.unpack_from(">H", seg, q)[0]
            re = seg[q + 2]
            ce, q = comp_index(q + 3)
            coding.poc.append((rs, cs, lye, re, ce or 256, seg[q]))


def _step(comp: _Comp, resno: int, bandno: int) -> Tuple[int, int]:
    """(ε, μ) of a band: the table's, or derived from the LL's (style 1)."""
    k = 0 if resno == 0 else 3 * (resno - 1) + bandno + 1
    if comp.quant_style == 1:
        e0, m0 = comp.steps[0]
        return (max(e0 - (k - 1) // 3, 0) if k else e0), m0
    if k >= len(comp.steps):
        raise error("JPEG 2000", "a quantization table shorter than the subbands")
    return comp.steps[k]


# ---------------------------------------------------------------------------
# tier-2
# ---------------------------------------------------------------------------


class _Bio:
    """``opj_bio``: packet header bits, most significant first, seven bits
    after a 0xFF byte."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7
            if self.pos < self.end:
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct = 0


class _TagTree:
    """``opj_tgt``: values 999 until decoded, ``low`` the bound known."""

    def __init__(self, w: int, h: int):
        levels = []
        while True:
            levels.append((w, h))
            if w * h <= 1:
                break
            w, h = _ceildiv(w, 2), _ceildiv(h, 2)
        offsets = [0]
        for lw, lh in levels:
            offsets.append(offsets[-1] + lw * lh)
        n = offsets[-1]
        self.parent = [-1] * n
        for li in range(len(levels) - 1):
            lw, lh = levels[li]
            nw = levels[li + 1][0]
            for y in range(lh):
                for x in range(lw):
                    self.parent[offsets[li] + y * lw + x] = offsets[li + 1] + (y // 2) * nw + x // 2
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: _Bio, leaf: int, threshold: int) -> bool:
        path = []
        node = leaf
        while node >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
        return self.value[leaf] < threshold


class _Block:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lenbits", "segs")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.lenbits = 3
        self.segs: List[list] = []  # [maxpasses, passes, bytearray]


class _Band:
    def __init__(self, bandno: int, x0: int, y0: int, x1: int, y1: int, numbps: int, step: float):
        self.bandno, self.x0, self.y0, self.x1, self.y1 = bandno, x0, y0, x1, y1
        self.numbps, self.step = numbps, step
        self.precincts: List[Tuple[int, int, List[_Block], _TagTree, _TagTree]] = []

    @property
    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0


class _Resolution:
    def __init__(self, x0, y0, x1, y1, pdx, pdy):
        self.x0, self.y0, self.x1, self.y1, self.pdx, self.pdy = x0, y0, x1, y1, pdx, pdy
        self.pw = 0 if x0 == x1 else (_ceildiv(x1, 1 << pdx) << pdx) - (x0 >> pdx << pdx) >> pdx
        self.ph = 0 if y0 == y1 else (_ceildiv(y1, 1 << pdy) << pdy) - (y0 >> pdy << pdy) >> pdy
        self.bands: List[_Band] = []


def _tile_component(comp: _Comp, prec: int, dx: int, dy: int, tx0, ty0, tx1, ty1):
    """OpenJPEG's ``opj_tcd_init_tile`` for one component: resolutions,
    bands, precincts and code-blocks."""
    x0, y0, x1, y1 = _ceildiv(tx0, dx), _ceildiv(ty0, dy), _ceildiv(tx1, dx), _ceildiv(ty1, dy)
    nl = comp.levels
    res_list = []
    for r in range(nl + 1):
        s = 1 << (nl - r)
        pdx, pdy = comp.precincts[r] if comp.precincts else (15, 15)
        res = _Resolution(_ceildiv(x0, s), _ceildiv(y0, s), _ceildiv(x1, s), _ceildiv(y1, s), pdx, pdy)
        tl_px = res.x0 >> pdx << pdx
        tl_py = res.y0 >> pdy << pdy
        if r == 0:
            cbg_x0, cbg_y0, cbgw, cbgh, bands = tl_px, tl_py, pdx, pdy, [0]
        else:
            cbg_x0, cbg_y0, cbgw, cbgh, bands = _ceildiv(tl_px, 2), _ceildiv(tl_py, 2), pdx - 1, pdy - 1, [1, 2, 3]
        cbw, cbh = min(comp.xcb, cbgw), min(comp.ycb, cbgh)
        for bandno in bands:
            if bandno == 0:
                bx0, by0, bx1, by1 = res.x0, res.y0, res.x1, res.y1
            else:
                nb = nl - r + 1
                ox, oy = bandno & 1, bandno >> 1
                h = 1 << (nb - 1)
                bx0, by0 = _ceildiv(x0 - h * ox, 1 << nb), _ceildiv(y0 - h * oy, 1 << nb)
                bx1, by1 = _ceildiv(x1 - h * ox, 1 << nb), _ceildiv(y1 - h * oy, 1 << nb)
            expn, mant = _step(comp, r, bandno - 1 if bandno else 0)
            step = float(np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn)))
            band = _Band(bandno, bx0, by0, bx1, by1, expn + comp.guard - 1, step)
            for p in range(res.pw * res.ph):
                px0 = cbg_x0 + (p % res.pw) * (1 << cbgw)
                py0 = cbg_y0 + (p // res.pw) * (1 << cbgh)
                prx0, pry0 = max(px0, bx0), max(py0, by0)
                prx1, pry1 = min(px0 + (1 << cbgw), bx1), min(py0 + (1 << cbgh), by1)
                if prx1 <= prx0 or pry1 <= pry0:
                    band.precincts.append((0, 0, [], _TagTree(0, 0), _TagTree(0, 0)))
                    continue
                cx0, cy0 = prx0 >> cbw << cbw, pry0 >> cbh << cbh
                cw = (_ceildiv(prx1, 1 << cbw) << cbw) - cx0 >> cbw
                ch = (_ceildiv(pry1, 1 << cbh) << cbh) - cy0 >> cbh
                blocks = []
                for k in range(cw * ch):
                    bx = cx0 + (k % cw) * (1 << cbw)
                    by = cy0 + (k // cw) * (1 << cbh)
                    blocks.append(_Block(max(bx, prx0), max(by, pry0), min(bx + (1 << cbw), prx1),
                                         min(by + (1 << cbh), pry1)))
                band.precincts.append((cw, ch, blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
            res.bands.append(band)
        res_list.append(res)
    return (x0, y0, x1, y1), res_list


def _num_passes(bio: _Bio) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _new_seg(style: int, first: bool, prev_max: int) -> list:
    if style & j2k_tier1.TERMALL:
        m = 1
    elif style & j2k_tier1.LAZY:
        m = 10 if first else (2 if prev_max in (1, 10) else 1)
    else:
        m = 109
    return [m, 0, bytearray()]


def _read_packet(data: bytes, pos: int, end: int, header, res: _Resolution, precno: int, layer: int,
                 coding: _Coding, style: int) -> int:
    """One packet (``opj_t2_read_packet_header`` and ``_data``): returns
    the position after it. ``header``: None for headers in the packet
    stream, else [bytes, position] of PPM/PPT headers."""
    if coding.sop and pos + 6 <= end and data[pos] == 0xFF and data[pos + 1] == 0x91:
        pos += 6
    if header is None:
        hdata, hpos, hend = data, pos, end
    else:
        hdata, hpos, hend = header[0], header[1], len(header[0])
    bio = _Bio(hdata, hpos, hend)
    included: List[Tuple[_Block, List[Tuple[list, int, int]]]] = []
    if bio.bit():
        for band in res.bands:
            if band.empty:
                continue
            cw, ch, blocks, incl, imsb = band.precincts[precno]
            for k, blk in enumerate(blocks):
                if not blk.segs:
                    inc = incl.decode(bio, k, layer + 1)
                else:
                    inc = bio.bit()
                if not inc:
                    continue
                if not blk.segs:
                    i = 0
                    while not imsb.decode(bio, k, i):
                        i += 1
                    blk.numbps = band.numbps + 1 - i
                    blk.lenbits = 3
                npass = _num_passes(bio)
                while bio.bit():
                    blk.lenbits += 1
                if not blk.segs:
                    seg = _new_seg(style, True, 0)
                    pending = [seg]
                else:
                    seg = blk.segs[-1]
                    pending = []
                    if seg[1] == seg[0]:
                        seg = _new_seg(style, False, seg[0])
                        pending = [seg]
                parts = []
                n = npass
                while True:
                    take = min(seg[0] - seg[1], n)
                    bits = blk.lenbits + (take.bit_length() - 1)
                    if bits > 32:
                        raise error("JPEG 2000", "a code-block length of more than 32 bits")
                    parts.append((seg, take, bio.read(bits)))
                    n -= take
                    if n <= 0:
                        break
                    seg = _new_seg(style, False, seg[0])
                    pending.append(seg)
                blk.segs.extend(pending)
                included.append((blk, parts))
        bio.align()
    else:
        bio.align()
    hpos = bio.pos
    if coding.eph and hpos + 2 <= hend and hdata[hpos] == 0xFF and hdata[hpos + 1] == 0x92:
        hpos += 2
    if header is None:
        pos = hpos
    else:
        header[1] = hpos
    for blk, parts in included:
        for seg, take, length in parts:
            if pos + length > end:
                raise error("JPEG 2000", "a packet runs past its tile's data")
            seg[2] += data[pos : pos + length]
            seg[1] += take
            pos += length
    return pos


def _packets(coding: _Coding, comps: List[_Comp], tcs: list, dx: List[int], dy: List[int], tile_box):
    """OpenJPEG's packet iterator: (layer, resolution, component,
    precinct) in progression order, each once; the POC's progressions in
    turn where the tile has one."""
    tx0, ty0, tx1, ty1 = tile_box
    ncomp = len(comps)
    max_res = max(c.levels + 1 for c in comps)
    progs = [(0, 0, coding.layers, max_res, ncomp, coding.order)] if not coding.poc else [
        (rs, cs, min(lye, coding.layers), min(re, max_res), min(ce, ncomp), o) for rs, cs, lye, re, ce, o in coding.poc]
    seen = set()

    def emit(key):
        if key in seen:
            return False
        seen.add(key)
        return True

    def steps(compnos):
        sdx = sdy = None
        for c in compnos:
            for r in range(comps[c].levels + 1):
                res = tcs[c][1][r]
                lv = comps[c].levels - r
                a, b = dx[c] << (res.pdx + lv), dy[c] << (res.pdy + lv)
                sdx = a if sdx is None else min(sdx, a)
                sdy = b if sdy is None else min(sdy, b)
        return sdx, sdy

    def precinct_at(c, r, x, y):
        comp = comps[c]
        if r > comp.levels:
            return None
        res = tcs[c][1][r]
        lv = comp.levels - r
        cdx, cdy = dx[c] << lv, dy[c] << lv
        trx0, try0 = _ceildiv(tx0, cdx), _ceildiv(ty0, cdy)
        trx1, try1 = _ceildiv(tx1, cdx), _ceildiv(ty1, cdy)
        rpx, rpy = res.pdx + lv, res.pdy + lv
        if not (y % (dy[c] << rpy) == 0 or (y == ty0 and (try0 << lv) % (1 << rpy))):
            return None
        if not (x % (dx[c] << rpx) == 0 or (x == tx0 and (trx0 << lv) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceildiv(x, cdx) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_ceildiv(y, cdy) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def grid(sdx, sdy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += sdx - x % sdx
            y += sdy - y % sdy

    for rs, cs, le, re, ce, order in progs:
        comp_range = range(cs, ce)
        if order in (0, 1):  # LRCP, RLCP
            outer = [(l, r) for l in range(le) for r in range(rs, re)] if order == 0 else \
                [(l, r) for r in range(rs, re) for l in range(le)]
            for l, r in outer:
                for c in comp_range:
                    if r > comps[c].levels:
                        continue
                    res = tcs[c][1][r]
                    for p in range(res.pw * res.ph):
                        if emit((l, r, c, p)):
                            yield l, r, c, p
        elif order == 2:  # RPCL
            sdx, sdy = steps(range(ncomp))
            for r in range(rs, re):
                for x, y in grid(sdx, sdy):
                    for c in comp_range:
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(le):
                            if emit((l, r, c, p)):
                                yield l, r, c, p
        elif order == 3:  # PCRL
            sdx, sdy = steps(range(ncomp))
            for x, y in grid(sdx, sdy):
                for c in comp_range:
                    for r in range(rs, min(re, comps[c].levels + 1)):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(le):
                            if emit((l, r, c, p)):
                                yield l, r, c, p
        elif order == 4:  # CPRL
            for c in comp_range:
                sdx, sdy = steps([c])
                for x, y in grid(sdx, sdy):
                    for r in range(rs, min(re, comps[c].levels + 1)):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(le):
                            if emit((l, r, c, p)):
                                yield l, r, c, p
        else:
            raise error("JPEG 2000", f"progression order {order}")


# ---------------------------------------------------------------------------
# the codestream
# ---------------------------------------------------------------------------


def _decode_codestream(cs: bytes):
    """A codestream → (components as int64 ``[h, w]`` over the image area,
    their precisions and signedness)."""
    if cs[:4] != b"\xff\x4f\xff\x51":
        raise error("JPEG 2000", "no SOC/SIZ")
    lsiz = struct.unpack_from(">H", cs, 4)[0]
    siz = cs[6 : 4 + lsiz]
    _, xsiz, ysiz, xo, yo, xt, yt, xto, yto, nc = struct.unpack_from(">HIIIIIIIIH", siz, 0)
    if nc == 0 or xt == 0 or yt == 0 or xsiz <= xo or ysiz <= yo:
        raise error("JPEG 2000", "a bad SIZ marker")
    prec, sgnd, dx, dy = [], [], [], []
    for i in range(nc):
        s, rx, ry = siz[36 + 3 * i : 39 + 3 * i]
        prec.append((s & 0x7F) + 1)
        sgnd.append(bool(s & 0x80))
        dx.append(rx)
        dy.append(ry)
    if any(v != 1 for v in dx + dy):
        raise refuse("JPEG 2000", "a component sampled other than 1 × 1")
    if max(prec) > 31:
        raise error("JPEG 2000", "more than 31 bits a sample")
    main = _Coding(nc)
    ppm: List[bytes] = []
    pos = 4 + lsiz
    # main header
    while True:
        if pos + 4 > len(cs):
            raise error("JPEG 2000", "the codestream ends in its main header")
        marker, length = struct.unpack_from(">HH", cs, pos)
        if marker == 0xFF90:
            break
        seg = cs[pos + 4 : pos + 2 + length]
        if marker == 0xFF60:  # PPM
            ppm.append(seg[1:])
        elif marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
            _apply_marker(marker, seg, main, nc)
        elif marker in (0xFF50, 0xFF59, 0xFF74, 0xFF75, 0xFF77, 0xFF78):
            raise refuse("JPEG 2000", f"a Part 2 marker ({marker:04X})")
        pos += 2 + length
    ppm_chunks = []
    if ppm:
        buf = b"".join(ppm)
        p = 0
        while p + 4 <= len(buf):
            n = struct.unpack_from(">I", buf, p)[0]
            ppm_chunks.append(buf[p + 4 : p + 4 + n])
            p += 4 + n
    ntx, nty = _ceildiv(xsiz - xto, xt), _ceildiv(ysiz - yto, yt)
    tiles: Dict[int, dict] = {}
    tile_part_no = 0
    while pos + 2 <= len(cs):
        marker = struct.unpack_from(">H", cs, pos)[0]
        if marker == 0xFFD9:
            break
        if marker != 0xFF90:
            raise error("JPEG 2000", f"marker {marker:04X} where a tile-part should start")
        _, isot, psot, tpsot, _ = struct.unpack_from(">HHIBB", cs, pos + 2)
        start = pos
        end = len(cs) if psot == 0 else min(start + psot, len(cs))
        tile = tiles.setdefault(isot, {"coding": None, "markers": [], "data": bytearray(), "ppt": [],
                                       "ppm": bytearray()})
        p = pos + 12
        while p + 2 <= end:
            m = struct.unpack_from(">H", cs, p)[0]
            if m == 0xFF93:  # SOD
                p += 2
                break
            ln = struct.unpack_from(">H", cs, p + 2)[0]
            seg = cs[p + 4 : p + 2 + ln]
            if m == 0xFF61:  # PPT
                tile["ppt"].append((seg[0], seg[1:]))
            elif m in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
                tile["markers"].append((m, seg))
            p += 2 + ln
        tile["data"] += cs[p:end]
        if ppm_chunks:
            tile["ppm"] += ppm_chunks[tile_part_no] if tile_part_no < len(ppm_chunks) else b""
        tile_part_no += 1
        pos = end
    out = [np.zeros((ysiz - yo, xsiz - xo), np.int64) for _ in range(nc)]
    for t in sorted(tiles):
        info = tiles[t]
        coding = main.copy()
        for m, seg in info["markers"]:
            _apply_marker(m, seg, coding, nc)
        tx, ty = t % ntx, t // ntx
        if ty >= nty:
            raise error("JPEG 2000", "a tile index past the grid")
        box = (max(xto + tx * xt, xo), max(yto + ty * yt, yo), min(xto + (tx + 1) * xt, xsiz),
               min(yto + (ty + 1) * yt, ysiz))
        header = None
        if ppm:
            header = [bytes(info["ppm"]), 0]
        elif info["ppt"]:
            header = [b"".join(d for _, d in sorted(info["ppt"], key=lambda z: z[0])), 0]
        samples = _decode_tile(bytes(info["data"]), header, coding, box, prec, sgnd, dx, dy)
        for c in range(nc):
            out[c][box[1] - yo : box[3] - yo, box[0] - xo : box[2] - xo] = samples[c]
    return out, prec, sgnd


def _decode_tile(data: bytes, header, coding: _Coding, box, prec, sgnd, dx, dy) -> List[np.ndarray]:
    nc = len(prec)
    comps = coding.comps
    for c in comps:
        if not c.steps:
            raise error("JPEG 2000", "no quantization parameters")
        if c.style & ~63:
            raise refuse("JPEG 2000", f"code-block style {c.style:#x} (HT or Part 2)")
    tcs = [_tile_component(comps[c], prec[c], dx[c], dy[c], *box) for c in range(nc)]
    pos = 0
    for l, r, c, p in _packets(coding, comps, tcs, dx, dy, box):
        if pos >= len(data) and header is None:
            break
        pos = _read_packet(data, pos, len(data), header, tcs[c][1][r], p, l, coding, comps[c].style)
    # tier-1, all code-blocks of a style in one lockstep run
    jobs: Dict[int, list] = {}
    for c in range(nc):
        for r, res in enumerate(tcs[c][1]):
            for band in res.bands:
                for _, _, blocks, _, _ in band.precincts:
                    for blk in blocks:
                        if blk.x1 <= blk.x0 or blk.y1 <= blk.y0 or not blk.segs:
                            continue
                        jobs.setdefault(comps[c].style, []).append((c, r, band, blk))
    values = {}
    for style, items in jobs.items():
        spec = [dict(w=blk.x1 - blk.x0, h=blk.y1 - blk.y0, orient=band.bandno, numbps=blk.numbps,
                     roishift=comps[c].roishift, style=style,
                     segments=[(bytes(s[2]), s[1]) for s in blk.segs if s[1] > 0])
                for c, r, band, blk in items]
        for (c, r, band, blk), vals in zip(items, j2k_tier1.decode_codeblocks(spec)):
            values[id(blk)] = vals
    result = []
    planes = []
    for c in range(nc):
        (x0, y0, x1, y1), res_list = tcs[c]
        comp = comps[c]
        w, h = x1 - x0, y1 - y0
        tile = np.zeros((h, w), np.int64 if comp.reversible else np.float32)
        for r, res in enumerate(res_list):
            prev = res_list[r - 1] if r else None
            for band in res.bands:
                for _, _, blocks, _, _ in band.precincts:
                    for blk in blocks:
                        v = values.get(id(blk))
                        if v is None:
                            continue
                        if comp.roishift:
                            if comp.roishift >= 31:
                                v = np.zeros_like(v)
                            else:
                                mag = np.abs(v)
                                big = mag >= (1 << comp.roishift)
                                v = np.where(big, np.sign(v) * (mag >> comp.roishift), v)
                        ox = blk.x0 - band.x0 + ((prev.x1 - prev.x0) if band.bandno & 1 else 0)
                        oy = blk.y0 - band.y0 + ((prev.y1 - prev.y0) if band.bandno & 2 else 0)
                        if comp.reversible:
                            q = np.where(v < 0, -((-v) >> 1), v >> 1)
                        else:
                            q = v.astype(np.float32) * np.float32(0.5 * np.float32(band.step))
                        tile[oy : oy + q.shape[0], ox : ox + q.shape[1]] = q
        boxes = [(rr.x0, rr.y0, rr.x1, rr.y1) for rr in res_list]
        planes.append(j2k_dwt.inverse(tile, boxes, comp.reversible))
    if coding.mct:
        if coding.mct != 1:
            raise refuse("JPEG 2000", "a Part 2 multiple component transform")
        if nc >= 3 and planes[0].shape == planes[1].shape == planes[2].shape:
            y, u, v = planes[:3]
            if comps[0].reversible:
                g = y - ((u + v) >> 2)
                planes[:3] = [v + g, g, u + g]
            else:
                y, u, v = (p.astype(np.float32) for p in (y, u, v))
                r_ = y + v * np.float32(1.402)
                g_ = y - u * np.float32(0.34413) - v * np.float32(0.71414)
                b_ = y + u * np.float32(1.772)
                planes[:3] = [r_, g_, b_]
    for c in range(nc):
        lo, hi = (-(1 << (prec[c] - 1)), (1 << (prec[c] - 1)) - 1) if sgnd[c] else (0, (1 << prec[c]) - 1)
        shift = 0 if sgnd[c] else 1 << (prec[c] - 1)
        p = planes[c]
        if comps[c].reversible:
            q = np.clip(p.astype(np.int64) + shift, lo, hi)
        else:
            f = p.astype(np.float32)
            with np.errstate(invalid="ignore"):
                q = np.where(f > np.float32(2**31 - 1), hi, np.where(f < -2.0**31, lo, 0))
                inside = (f <= np.float32(2**31 - 1)) & (f >= -2.0**31)
                r = np.rint(np.where(inside, f, 0)).astype(np.int64)
            q = np.where(inside, np.clip(r + shift, lo, hi), q)
        result.append(q.astype(np.int64))
    return result


# ---------------------------------------------------------------------------
# Pillow's unpacking
# ---------------------------------------------------------------------------


def _to8(v: np.ndarray, prec: int, sgnd: bool, out_bits: int = 8) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` cut to ``out_bits``."""
    csiz = (prec + 7) >> 3
    if csiz == 3:
        csiz = 4
    word = v % (1 << (8 * csiz))
    shift = out_bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = offset + word
    x = x << shift if shift >= 0 else x >> -shift
    return x & ((1 << out_bits) - 1)


# (mode, colour space, components) of Pillow's unpackers
_UNPACKERS = {
    ("L", GRAY, 1), ("P", SRGB, 1), ("PA", SRGB, 2), ("I;16", GRAY, 1), ("LA", GRAY, 2),
    ("RGB", GRAY, 1), ("RGB", GRAY, 2), ("RGB", SRGB, 3), ("RGB", SYCC, 3), ("RGB", SRGB, 4), ("RGB", SYCC, 4),
    ("RGBA", GRAY, 1), ("RGBA", GRAY, 2), ("RGBA", SRGB, 3), ("RGBA", SYCC, 3), ("RGBA", SRGB, 4),
    ("RGBA", SYCC, 4), ("CMYK", CMYK, 4),
}


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """JPEG 2000 (JP2 or codestream) bytes → uint8 ``[H, W, 3]``."""
    if data[:4] == b"\xff\x4f\xff\x51":
        cs, palette, space = data, None, UNSPECIFIED
        try:
            lsiz = struct.unpack_from(">H", data, 4)[0]
            nc = struct.unpack_from(">H", data, 40)[0]
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
            if nc == 1:
                mode = "I;16" if (data[42] & 0x7F) + 1 > 8 else "L"
        except (struct.error, IndexError):
            raise NotThisFormat("JPEG 2000: a truncated SIZ marker") from None
        if mode is None or lsiz < 41:
            raise NotThisFormat("JPEG 2000: unable to determine the image mode")
    elif data[:12] == _JP2_SIGNATURE:
        try:
            mode, palette, space, cs = _jp2(data)
        except (struct.error, IndexError):
            raise NotThisFormat("JPEG 2000: a truncated JP2 header") from None
    else:
        raise NotThisFormat("not a JPEG 2000 file")
    comps, prec, sgnd = _decode_codestream(cs)
    nc = len(comps)
    if space in (UNSPECIFIED, UNKNOWN):  # Pillow picks by the component count (an ICC profile among them)
        space = GRAY if nc <= 2 else SRGB
    if (mode, space, nc) not in _UNPACKERS:
        raise error("JPEG 2000", f"mode {mode} with {nc} components in colour space {space} (Pillow has no "
                                 "unpacker for it and refuses it too)")
    if mode == "I;16":
        g = np.minimum(_to8(comps[0], prec[0], sgnd[0], 16), 255)
        return np.repeat(g.astype(np.uint8)[:, :, None], 3, axis=2)
    if mode in ("P", "PA"):
        idx = _to8(comps[0], prec[0], sgnd[0])
        pal = np.zeros((256, 3), np.uint8)
        pal[: min(len(palette), 256)] = palette[:256]
        return pal[idx]
    if nc <= 2:
        g = _to8(comps[0], prec[0], sgnd[0]).astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    chans = [_to8(comps[c], prec[c], sgnd[c]) for c in range(min(nc, 4))]
    if mode == "CMYK":
        return cmyk2rgb(np.stack(chans[:4], -1))
    rgb = np.stack(chans[:3], -1)
    if space == SYCC:
        rgb = _ycbcr_to_rgb(rgb)
    return rgb.astype(np.uint8)


def _ycc_table(c: float) -> np.ndarray:
    return np.trunc((np.arange(256) - 128) * c * 64 + 0.5).astype(np.int64)


# ConvertYCbCr.c's tables (6 fractional bits), reproduced from their coefficients
_R_CR, _G_CB, _G_CR, _B_CB = _ycc_table(1.402), _ycc_table(-0.34414), _ycc_table(-0.71414), _ycc_table(1.772)


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ``ImagingConvertYCbCr2RGB``."""
    y, cb, cr = (ycc[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6), y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255)
