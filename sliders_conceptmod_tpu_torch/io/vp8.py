"""WebP lossy (VP8 key frames, RFC 6386) decoding in numpy and plain Python,
to the RGB that libwebp's ``WebPDecode`` gives in ``MODE_RGBA`` (the GPU
machine has no PIL).

The YUV 4:2:0 planes are normative and bit-exact by the RFC:

* the boolean entropy decoder (section 7) over the first partition (frame
  header, per-macroblock modes) and 1, 2, 4 or 8 token partitions, one per
  macroblock row in turn;
* the frame header (sections 9.3–9.11): segments with their quantiser and
  filter levels (absolute or deltas), the filter type, level and
  sharpness, the reference and mode filter deltas, the quantiser indices
  and deltas, the coefficient probability updates and the skip flag's
  probability;
* intra modes (section 11): 16x16 luma (DC, V, H, TM), 4x4 B-modes with the
  above and left modes as context, 8x8 chroma; the edges outside the frame
  read 127 above and 129 to the left, as libwebp's ``ReconstructRow`` sets
  them (section 12);
* tokens (section 13) with their band and neighbour contexts, dequantised
  by the DC and AC tables (section 14.1), the inverse Walsh–Hadamard
  transform of the 16x16 mode's DC block and the inverse DCT (section 14.3–14.4);
* the normal and the simple loop filter (section 15), per macroblock in
  raster order: left edge, inner vertical edges, top edge, inner horizontal
  edges, the inner edges skipped where a 16x16 macroblock has no
  coefficient. Prediction reads the unfiltered reconstruction.

RGB is libwebp's choice: the "fancy" chroma upsampler of
``dsp/upsampling.c`` (a 9-3-3-1 filter in two rounding steps; the first
column, and the last of an even width, by the rows' 3-1 filter alone; the
first row, and the last of an even height, pair a chroma row with itself)
and the fixed-point conversion of ``dsp/yuv.h`` (14-bit products, 6
fractional bits).

Token decoding is sequential: it runs in plain Python. The inverse
transforms run on every block at once in numpy; prediction and the loop
filter run per macroblock and per edge on numpy rows.
"""

from __future__ import annotations

from typing import List

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import ITEM, error

# RFC 6386, section 13.5: default_coeff_probs [4 types][8 bands][3 contexts][11 nodes], row-major
_COEFF_PROBS_HEX = (
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ff"
    "e3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff808080808080"
    "8080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4"
    "80808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e"
    "8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080"
    "801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
)
# RFC 6386, section 13.4: coeff_update_probs, the same shape
_COEFF_UPDATE_HEX = (
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcff"
    "fffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffffffffffffffffffff"
    "fffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fe"
    "f9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfeffffffffffffff"
    "fffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
)
# RFC 6386, section 11.5: kf_bmode_probs [above][left][9], its modes in libwebp's order (B_DC, B_TM, B_VE,
# B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU), so that the 16x16 modes DC, TM, V, H share the first four indices
_BMODE_PROBS_HEX = (
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850"
    "c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301"
    "512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e"
    "10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f"
    "24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b450"
    "7e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"
)

_COEFF_PROBS = np.frombuffer(bytes.fromhex("".join(_COEFF_PROBS_HEX)), np.uint8).reshape(4, 8, 3, 11)
_COEFF_UPDATE = np.frombuffer(bytes.fromhex("".join(_COEFF_UPDATE_HEX)), np.uint8).reshape(4, 8, 3, 11)
_BMODE_PROBS = np.frombuffer(bytes.fromhex("".join(_BMODE_PROBS_HEX)), np.uint8).reshape(10, 10, 9).tolist()

# RFC 6386, section 14.1: dc_qlookup and ac_qlookup
_DC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157]
_AC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62,
    64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114,
    116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284]
assert len(_DC_TABLE) == len(_AC_TABLE) == 128

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # coefficient index → band (and a sentinel)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers: the 16x16 modes DC, TM, V, H are the B-modes of the same index
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# kYModesIntra4: the B-mode tree, node i's branches at 2i and 2i + 1, leaves as −mode
_BMODE_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU)
_NORM = [0] + [7 - (r.bit_length() - 1) if r < 128 else 0 for r in range(1, 256)]


class BoolDecoder:
    """RFC 6386 section 7's decoder. ``value`` keeps the 8 bits compared
    with the split at bits 48–55 and ``count`` more bits below them; past
    the end of its data it reads zeros."""

    __slots__ = ("buf", "pos", "value", "count", "range")

    def __init__(self, data: bytes):
        self.buf, self.pos = data, 0
        self.value, self.count, self.range = 0, -8, 255
        self._fill()

    def _fill(self) -> None:
        buf, pos, value, count = self.buf, self.pos, self.value, self.count
        while count < 40:
            if pos < len(buf):
                value |= buf[pos] << (40 - count)
                pos += 1
            count += 8
        self.pos, self.value, self.count = pos, value, count

    def bit(self, prob: int) -> int:
        if self.count < 0:
            self._fill()
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 48
        if self.value >= big:
            r = self.range - split
            self.value -= big
            b = 1
        else:
            r = split
            b = 0
        if r < 128:
            s = _NORM[r]
            r <<= s
            self.value <<= s
            self.count -= s
        self.range = r
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def flag_value(self, n: int, signed: bool = False) -> int:
        """A value behind an update flag (0 where the flag is clear)."""
        if not self.bit(128):
            return 0
        return self.signed(n) if signed else self.literal(n)

    def coeffs(self, bands: list, ctx: int, dc_q: int, ac_q: int, n: int, out: list, base: int) -> int:
        """``GetCoeffs``: tokens of one block from position ``n`` into
        ``out[base + raster index]``, dequantised; returns the index past the
        last token (0 for an empty block)."""
        bit = self.bit
        p = bands[n][ctx]
        while n < 16:
            if not bit(p[0]):
                return n  # end of block
            while not bit(p[1]):  # a zero
                n += 1
                if n == 16:
                    return 16
                p = bands[n][0]
            if not bit(p[2]):
                v = 1
                p = bands[n + 1][1]
            else:
                if not bit(p[3]):
                    v = 2 if not bit(p[4]) else 3 + bit(p[5])
                elif not bit(p[6]):
                    if not bit(p[7]):
                        v = 5 + bit(159)
                    else:
                        v = 7 + 2 * bit(165)
                        v += bit(145)
                else:
                    b1 = bit(p[8])
                    cat = 2 * b1 + bit(p[9 + b1])
                    v = 0
                    for q in _CAT_PROBS[cat]:
                        v += v + bit(q)
                    v += 3 + (8 << cat)
                p = bands[n + 1][2]
            if bit(128):
                v = -v
            out[base + ZIGZAG[n]] = v * (ac_q if n else dc_q)
            n += 1
        return 16


class _Header:
    pass


def _parse_header(br: BoolDecoder) -> _Header:
    h = _Header()
    br.bit(128)  # colour space (0: YUV; 1 is reserved)
    br.bit(128)  # clamping type: the decoder clamps either way
    h.use_segment = br.bit(128)
    h.update_map = 0
    h.absolute_delta = 0
    h.seg_quant = [0] * 4
    h.seg_filter = [0] * 4
    h.seg_probs = [255, 255, 255]
    if h.use_segment:
        h.update_map = br.bit(128)
        if br.bit(128):  # update the segment data
            h.absolute_delta = br.bit(128)
            h.seg_quant = [br.flag_value(7, True) for _ in range(4)]
            h.seg_filter = [br.flag_value(6, True) for _ in range(4)]
        if h.update_map:
            h.seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    h.simple = br.bit(128)
    h.level = br.literal(6)
    h.sharpness = br.literal(3)
    h.use_lf_delta = br.bit(128)
    h.ref_lf_delta = [0] * 4
    h.mode_lf_delta = [0] * 4
    if h.use_lf_delta and br.bit(128):
        for i in range(4):
            if br.bit(128):
                h.ref_lf_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                h.mode_lf_delta[i] = br.signed(6)
    h.num_parts = 1 << br.literal(2)
    return h


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else hi if v > hi else v


def _quant_matrices(br: BoolDecoder, h: _Header) -> list:
    """``VP8ParseQuant``: per segment (dc, ac) pairs for Y1, Y2 and UV."""
    base = br.literal(7)
    dy1_dc = br.flag_value(4, True)
    dy2_dc, dy2_ac = br.flag_value(4, True), br.flag_value(4, True)
    duv_dc, duv_ac = br.flag_value(4, True), br.flag_value(4, True)
    out = []
    for s in range(4):
        if h.use_segment:
            q = h.seg_quant[s] + (0 if h.absolute_delta else base)
        else:
            q = base
        y2_ac = _AC_TABLE[_clip(q + dy2_ac, 127)] * 101581 >> 16  # x · 155 / 100
        out.append(dict(
            y1=(_DC_TABLE[_clip(q + dy1_dc, 127)], _AC_TABLE[_clip(q, 127)]),
            y2=(_DC_TABLE[_clip(q + dy2_dc, 127)] * 2, max(y2_ac, 8)),
            uv=(_DC_TABLE[_clip(q + duv_dc, 117)], _AC_TABLE[_clip(q + duv_ac, 127)])))
        if not h.use_segment:
            return out * 4
    return out


def _filter_strengths(h: _Header) -> list:
    """``PrecomputeFilterStrengths``: [segment][is 4x4] → (limit, inner
    limit, hev threshold); a limit of 0 filters nothing."""
    out = []
    for s in range(4):
        base = h.level
        if h.use_segment:
            base = h.seg_filter[s] + (0 if h.absolute_delta else h.level)
        row = []
        for i4 in (0, 1):
            level = base
            if h.use_lf_delta:
                level += h.ref_lf_delta[0]
                if i4:
                    level += h.mode_lf_delta[0]
            level = _clip(level, 63)
            if level == 0:
                row.append((0, 0, 0))
                continue
            ilevel = level
            if h.sharpness > 0:
                ilevel >>= 2 if h.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - h.sharpness)
            ilevel = max(ilevel, 1)
            row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


def _parse_modes(br: BoolDecoder, h: _Header, mb_w: int, mb_h: int, use_skip: int, skip_p: int) -> list:
    """Per macroblock, from the first partition: (segment, skip, is 4x4,
    the 16 B-modes or the 16x16 mode, the chroma mode)."""
    top = [B_DC] * (4 * mb_w)
    out = []
    for _ in range(mb_h):
        left = [B_DC] * 4
        row = []
        for mx in range(mb_w):
            seg = 0
            if h.update_map:
                seg = br.bit(h.seg_probs[1]) if not br.bit(h.seg_probs[0]) else 2 + br.bit(h.seg_probs[2])
            skip = br.bit(skip_p) if use_skip else 0
            is_i4 = not br.bit(145)
            if not is_i4:
                if br.bit(156):
                    ymode = B_TM if br.bit(128) else B_HE
                else:
                    ymode = B_VE if br.bit(163) else B_DC
                modes = ymode
                top[4 * mx : 4 * mx + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                modes = [0] * 16
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        prob = _BMODE_PROBS[top[4 * mx + x]][ymode]
                        i = _BMODE_TREE[br.bit(prob[0])]
                        while i > 0:
                            i = _BMODE_TREE[2 * i + br.bit(prob[i])]
                        ymode = -i
                        top[4 * mx + x] = ymode
                        modes[4 * y + x] = ymode
                    left[y] = ymode
            if not br.bit(142):
                uvmode = B_DC
            elif not br.bit(114):
                uvmode = B_VE
            else:
                uvmode = B_TM if br.bit(183) else B_HE
            row.append((seg, skip, is_i4, modes, uvmode))
        out.append(row)
    return out


def _parse_tokens(parts: List[BoolDecoder], probs: list, modes: list, quant: list, mb_w: int, mb_h: int):
    """``ParseResiduals`` for every macroblock: dequantised coefficients
    ``[mb_h, mb_w, 24, 16]`` (16 luma blocks, 4 U, 4 V; raster order in a
    block, the 16x16 mode's DCs from the inverse WHT) and whether each
    macroblock has a coefficient (the filter's inner edges)."""
    bands = [[probs[t][BANDS[n]] for n in range(17)] for t in range(4)]
    coefs = np.zeros((mb_h, mb_w, 24, 16), np.int64)
    nonzero = np.zeros((mb_h, mb_w), bool)
    top_nz = [0] * mb_w  # bits 0-3 luma columns, 4-5 U, 6-7 V
    top_dc = [0] * mb_w
    for my in range(mb_h):
        br = parts[my % len(parts)]
        left_nz = left_dc = 0
        for mx in range(mb_w):
            seg, skip, is_i4, _, _ = modes[my][mx]
            q = quant[seg]
            if skip:
                top_nz[mx] = left_nz = 0
                if not is_i4:
                    top_dc[mx] = left_dc = 0
                continue
            out = [0] * 384
            nz_y = nz_uv = 0
            if not is_i4:
                dc = [0] * 16
                nz = br.coeffs(bands[1], top_dc[mx] + left_dc, q["y2"][0], q["y2"][1], 0, dc, 0)
                top_dc[mx] = left_dc = int(nz > 0)
                for i, v in enumerate(_inverse_wht(dc)):
                    out[16 * i] = v
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            tnz, lnz = top_nz[mx] & 15, left_nz & 15
            dq_dc, dq_ac = q["y1"]
            for y in range(4):
                l = lnz & 1
                for x in range(4):
                    base = 64 * y + 16 * x
                    nz = br.coeffs(ac, l + (tnz & 1), dq_dc, dq_ac, first, out, base)
                    l = int(nz > first)
                    tnz = (tnz >> 1) | (l << 7)
                    nz_y |= nz > 1 or out[base] != 0
                tnz >>= 4
                lnz = (lnz >> 1) | (l << 7)
            out_t, out_l = tnz, lnz >> 4
            dq_dc, dq_ac = q["uv"]
            for ch in (0, 2):
                tnz, lnz = top_nz[mx] >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    l = lnz & 1
                    for x in range(2):
                        base = 256 + 32 * ch + 32 * y + 16 * x
                        nz = br.coeffs(bands[2], l + (tnz & 1), dq_dc, dq_ac, 0, out, base)
                        l = int(nz > 0)
                        tnz = (tnz >> 1) | (l << 3)
                        nz_uv |= nz > 1 or out[base] != 0
                    tnz >>= 2
                    lnz = (lnz >> 1) | (l << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mx], left_nz = out_t, out_l
            coefs[my, mx] = np.array(out, np.int64).reshape(24, 16)
            nonzero[my, mx] = bool(nz_y or nz_uv)
    return coefs, nonzero


def _inverse_wht(dc: list) -> list:
    """``TransformWHT``: the 16 luma DCs of a 16x16 macroblock, block order."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3] = (
            (a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3)
    return out


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def inverse_dct(c: np.ndarray) -> np.ndarray:
    """``TransformOne`` on coefficients ``[..., 16]`` (raster order) → the
    residuals ``[..., 4, 4]`` (the ``>> 3`` of its stores)."""
    c = c.reshape(c.shape[:-1] + (4, 4))
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]  # vertical pass, per column
    a, b = i0 + i2, i0 - i2
    cc, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=-2)
    j0, j1, j2, j3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]  # horizontal pass, per row
    dc = j0 + 4
    a, b = dc + j2, dc - j2
    cc, d = _mul2(j1) - _mul1(j3), _mul1(j1) + _mul2(j3)
    return np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _predict4(mode: int, top: list, left: list, tl: int) -> list:
    """A 4x4 B-mode's prediction, rows of 4; ``top`` holds 8 samples (the
    block's and the 4 to its right), ``left`` 4."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4] * 4
    if mode == B_TM:
        return [[min(max(left[y] + top[x] - tl, 0), 255) for x in range(4)] for y in range(4)]
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row] * 4
    if mode == B_HE:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    d = [[0] * 4 for _ in range(4)]  # d[y][x]

    def put(v, *xy):
        for x, y in xy:
            d[y][x] = v

    if mode == B_RD:
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == B_LD:
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == B_VR:
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == B_VL:
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == B_HU:
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    elif mode == B_HD:
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:
        raise error("WebP lossy (VP8)", f"B-mode {mode}")
    return d


def _predict_block(mode: int, top: np.ndarray, left: np.ndarray, tl: int, size: int, mx: int, my: int) -> np.ndarray:
    """16x16 luma or 8x8 chroma prediction; DC drops the edges outside the
    frame (``CheckMode``)."""
    if mode == B_DC:
        shift = 4 if size == 16 else 3
        if mx and my:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif my:  # no left
            v = (int(top.sum()) + (size >> 1)) >> shift
        elif mx:  # no top
            v = (int(left.sum()) + (size >> 1)) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == B_TM:
        return np.clip(left[:, None] + top[None, :] - tl, 0, 255)
    if mode == B_VE:
        return np.broadcast_to(top[None, :], (size, size))
    if mode == B_HE:
        return np.broadcast_to(left[:, None], (size, size))
    raise error("WebP lossy (VP8)", f"16x16 mode {mode}")


def _reconstruct(modes: list, resid: np.ndarray, mb_w: int, mb_h: int):
    """Prediction plus residual, macroblock by macroblock, into the
    unfiltered planes (whole macroblocks)."""
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.int64)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.int64)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.int64)
    for my in range(mb_h):
        for mx in range(mb_w):
            _, _, is_i4, ymodes, uvmode = modes[my][mx]
            r = resid[my, mx]  # [24, 4, 4]
            y0, x0 = 16 * my, 16 * mx
            top = Y[y0 - 1, x0 : x0 + 16] if my else np.full(16, 127, np.int64)
            left = Y[y0 : y0 + 16, x0 - 1] if mx else np.full(16, 129, np.int64)
            tl = int(Y[y0 - 1, x0 - 1]) if mx and my else 127 if my == 0 else 129
            if is_i4:
                if my == 0:
                    tr = [127] * 4
                elif mx < mb_w - 1:
                    tr = Y[y0 - 1, x0 + 16 : x0 + 20].tolist()
                else:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                ws = np.zeros((17, 21), np.int64)  # libwebp's work area: the edges, the block, 4 top-right columns
                ws[0, 0] = tl
                ws[0, 1:17] = top
                ws[1:, 0] = left
                for k in range(4):
                    ws[4 * k, 17:21] = tr
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    ry, rx = 1 + 4 * by, 1 + 4 * bx
                    pred = _predict4(ymodes[n], ws[ry - 1, rx : rx + 8].tolist(), ws[ry : ry + 4, rx - 1].tolist(),
                                     int(ws[ry - 1, rx - 1]))
                    ws[ry : ry + 4, rx : rx + 4] = np.clip(np.array(pred) + r[n], 0, 255)
                Y[y0 : y0 + 16, x0 : x0 + 16] = ws[1:, 1:17]
            else:
                pred = _predict_block(ymodes, top, left, tl, 16, mx, my)
                res = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                Y[y0 : y0 + 16, x0 : x0 + 16] = np.clip(pred + res, 0, 255)
            c0, d0 = 8 * my, 8 * mx
            for plane, off in ((U, 16), (V, 20)):
                top = plane[c0 - 1, d0 : d0 + 8] if my else np.full(8, 127, np.int64)
                left = plane[c0 : c0 + 8, d0 - 1] if mx else np.full(8, 129, np.int64)
                tl = int(plane[c0 - 1, d0 - 1]) if mx and my else 127 if my == 0 else 129
                pred = _predict_block(uvmode, top, left, tl, 8, mx, my)
                res = r[off : off + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[c0 : c0 + 8, d0 : d0 + 8] = np.clip(pred + res, 0, 255)
    return Y, U, V


# ---------------------------------------------------------------------------
# loop filter
# ---------------------------------------------------------------------------


def _filter_edge(seg: np.ndarray, thresh: int, ithresh: int, hev_t: int, kind: str) -> None:
    """Filter one edge in place: ``seg`` is ``[n, 8]`` int, the samples
    p3 p2 p1 p0 | q0 q1 q2 q3 across it, one row per line along the edge.
    ``kind``: "simple", "mb" (``FilterLoop26``) or "inner" (``FilterLoop24``)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, k].copy() for k in range(8))
    t2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind == "simple":
        filter2 = need
        other = np.zeros_like(need)
    else:
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh) & (np.abs(p1 - p0) <= ithresh)
                 & (np.abs(q3 - q2) <= ithresh) & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        filter2, other = need & hev, need & ~hev
    if filter2.any():  # DoFilter2
        a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        seg[filter2, 3] = np.clip(p0 + a2, 0, 255)[filter2]
        seg[filter2, 4] = np.clip(q0 - a1, 0, 255)[filter2]
    if other.any() and kind == "inner":  # DoFilter4
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        seg[other, 2] = np.clip(p1 + a3, 0, 255)[other]
        seg[other, 3] = np.clip(p0 + a2, 0, 255)[other]
        seg[other, 4] = np.clip(q0 - a1, 0, 255)[other]
        seg[other, 5] = np.clip(q1 - a3, 0, 255)[other]
    elif other.any():  # DoFilter6
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        seg[other, 1] = np.clip(p2 + a3, 0, 255)[other]
        seg[other, 2] = np.clip(p1 + a2, 0, 255)[other]
        seg[other, 3] = np.clip(p0 + a1, 0, 255)[other]
        seg[other, 4] = np.clip(q0 - a1, 0, 255)[other]
        seg[other, 5] = np.clip(q1 - a2, 0, 255)[other]
        seg[other, 6] = np.clip(q2 - a3, 0, 255)[other]


def _filter_vertical_edge(plane: np.ndarray, y0: int, x: int, n: int, *args) -> None:
    """The edge left of column ``x``, rows ``y0 .. y0 + n`` (horizontal filtering)."""
    seg = plane[y0 : y0 + n, x - 4 : x + 4].copy()
    _filter_edge(seg, *args)
    plane[y0 : y0 + n, x - 4 : x + 4] = seg


def _filter_horizontal_edge(plane: np.ndarray, y: int, x0: int, n: int, *args) -> None:
    """The edge above row ``y``, columns ``x0 .. x0 + n``."""
    seg = plane[y - 4 : y + 4, x0 : x0 + n].T.copy()
    _filter_edge(seg, *args)
    plane[y - 4 : y + 4, x0 : x0 + n] = seg.T


def _loop_filter(Y, U, V, simple: bool, strengths: list, modes: list, nonzero: np.ndarray) -> None:
    """``DoFilter`` for every macroblock in raster order, in place."""
    mb_h, mb_w = nonzero.shape
    for my in range(mb_h):
        for mx in range(mb_w):
            seg, skip, is_i4, _, _ = modes[my][mx]
            limit, ilevel, hev_t = strengths[seg][int(is_i4)]
            if limit == 0:
                continue
            inner = is_i4 or bool(nonzero[my, mx])
            y0, x0, c0, d0 = 16 * my, 16 * mx, 8 * my, 8 * mx
            if simple:
                if mx:
                    _filter_vertical_edge(Y, y0, x0, 16, limit + 4, 0, 0, "simple")
                if inner:
                    for k in (4, 8, 12):
                        _filter_vertical_edge(Y, y0, x0 + k, 16, limit, 0, 0, "simple")
                if my:
                    _filter_horizontal_edge(Y, y0, x0, 16, limit + 4, 0, 0, "simple")
                if inner:
                    for k in (4, 8, 12):
                        _filter_horizontal_edge(Y, y0 + k, x0, 16, limit, 0, 0, "simple")
                continue
            if mx:
                _filter_vertical_edge(Y, y0, x0, 16, limit + 4, ilevel, hev_t, "mb")
                for P in (U, V):
                    _filter_vertical_edge(P, c0, d0, 8, limit + 4, ilevel, hev_t, "mb")
            if inner:
                for k in (4, 8, 12):
                    _filter_vertical_edge(Y, y0, x0 + k, 16, limit, ilevel, hev_t, "inner")
                for P in (U, V):
                    _filter_vertical_edge(P, c0, d0 + 4, 8, limit, ilevel, hev_t, "inner")
            if my:
                _filter_horizontal_edge(Y, y0, x0, 16, limit + 4, ilevel, hev_t, "mb")
                for P in (U, V):
                    _filter_horizontal_edge(P, c0, d0, 8, limit + 4, ilevel, hev_t, "mb")
            if inner:
                for k in (4, 8, 12):
                    _filter_horizontal_edge(Y, y0 + k, x0, 16, limit, ilevel, hev_t, "inner")
                for P in (U, V):
                    _filter_horizontal_edge(P, c0 + 4, d0, 8, limit, ilevel, hev_t, "inner")


# ---------------------------------------------------------------------------
# frame
# ---------------------------------------------------------------------------


def decode_vp8_yuv(data: bytes):
    """A VP8 key frame (the ``VP8 `` chunk's payload) → its Y ``[H, W]``, U
    and V ``[(H + 1) // 2, (W + 1) // 2]`` planes, uint8."""
    if len(data) < 10:
        raise error("WebP lossy (VP8)", "the frame is truncated")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise error("WebP lossy (VP8)", "not a key frame")
    if (bits >> 1) & 7 > 3:
        raise error("WebP lossy (VP8)", f"profile {(bits >> 1) & 7} ({ITEM})")
    part0_size = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise error("WebP lossy (VP8)", "no start code")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    if width == 0 or height == 0:
        raise error("WebP lossy (VP8)", "an empty frame")
    if 10 + part0_size > len(data):
        raise error("WebP lossy (VP8)", "the first partition is truncated")
    br = BoolDecoder(data[10 : 10 + part0_size])
    h = _parse_header(br)
    pos = 10 + part0_size
    sizes_at, pos = pos, pos + 3 * (h.num_parts - 1)
    parts = []
    for p in range(h.num_parts):
        if p < h.num_parts - 1:
            size = int.from_bytes(data[sizes_at + 3 * p : sizes_at + 3 * p + 3], "little")
        else:
            size = len(data) - pos
        if size < 0 or pos + size > len(data):
            raise error("WebP lossy (VP8)", "a token partition is truncated")
        parts.append(BoolDecoder(data[pos : pos + size]))
        pos += size
    quant = _quant_matrices(br, h)
    br.bit(128)  # refresh the entropy probabilities: a still image has one frame
    probs = _COEFF_PROBS.copy()
    for idx in np.ndindex(probs.shape):
        if br.bit(int(_COEFF_UPDATE[idx])):
            probs[idx] = br.literal(8)
    probs = probs.tolist()
    use_skip = br.bit(128)
    skip_p = br.literal(8) if use_skip else 0
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    modes = _parse_modes(br, h, mb_w, mb_h, use_skip, skip_p)
    coefs, nonzero = _parse_tokens(parts, probs, modes, quant, mb_w, mb_h)
    Y, U, V = _reconstruct(modes, inverse_dct(coefs), mb_w, mb_h)
    if h.level:
        _loop_filter(Y, U, V, bool(h.simple), _filter_strengths(h), modes, nonzero)
    cw, ch = (width + 1) >> 1, (height + 1) >> 1
    return (Y[:height, :width].astype(np.uint8), U[:ch, :cw].astype(np.uint8), V[:ch, :cw].astype(np.uint8))


# ---------------------------------------------------------------------------
# RGB, as libwebp's WebPDecode gives it
# ---------------------------------------------------------------------------


def _fancy_upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """libwebp's fancy upsampling (``UpsampleRgbaLinePair``) of a chroma
    plane to ``[height, width]``. An output sample takes its nearer chroma
    row N and column n and the farther ones F and f (the edge row or column
    where the farther one is missing): ``(((N_n + 3 N_f + 3 F_n + F_f + 8)
    >> 3) + N_n) >> 1``, the 9-3-3-1 filter in two rounding steps. The
    first column, and the last of an even width, take the rows' 3-1 filter
    alone: ``(3 N_n + F_n + 2) >> 2``."""
    c = c.astype(np.int64)
    ch, cw = c.shape
    r = np.arange(height)
    near_r = np.where(r & 1, (r - 1) >> 1, r >> 1)
    far_r = np.where(r & 1, (r + 1) >> 1, (r >> 1) - 1)
    near_r, far_r = np.minimum(near_r, ch - 1), np.clip(far_r, 0, ch - 1)
    x = np.arange(width)
    near_c = x >> 1
    far_c = np.clip(np.where(x & 1, near_c + 1, near_c - 1), 0, cw - 1)
    N = c[near_r]  # [height, cw]
    F = c[far_r]
    nn, nf, fn, ff = N[:, near_c], N[:, far_c], F[:, near_c], F[:, far_c]
    out = (((nn + 3 * nf + 3 * fn + ff + 8) >> 3) + nn) >> 1
    edge = (3 * nn + fn + 2) >> 2
    out[:, 0] = edge[:, 0]
    if width % 2 == 0:
        out[:, -1] = edge[:, -1]
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``VP8YuvToRgb`` (``dsp/yuv.h``): 14-bit fixed-point products, 6
    fractional bits, clipped to 0..255."""

    def mult_hi(a, k):
        return (a * k) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    y1 = mult_hi(y, 19077)
    r = clip8(y1 + mult_hi(v, 26149) - 14234)
    g = clip8(y1 - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(y1 + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame → uint8 RGB ``[H, W, 3]``, as libwebp's fancy
    upsampling and YUV conversion give it."""
    Y, U, V = decode_vp8_yuv(data)
    h, w = Y.shape
    return _yuv_to_rgb(Y.astype(np.int64), _fancy_upsample(U, h, w), _fancy_upsample(V, h, w))
