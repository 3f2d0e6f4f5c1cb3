"""Block-compressed textures (BC1–BC7) as Pillow 12's C ``bcn`` decoder
(``BcnDecode.c``) gives them, for ``io/dds.py`` and ``io/ftex.py`` (the GPU
machine has no PIL). Every 4 × 4 block is decoded whole and cut at the
image's right and bottom edges; blocks run in raster order.

* BC1: two RGB565 colours widened by bit replication, four colours where the
  first is the larger (thirds, rounded down), else three and transparent
  black. BC2 and BC3 take the colour block as four colours always; BC2 adds
  4-bit alpha (× 17), BC3 the interpolated alpha of BC4.
* BC4 (grey) and BC5 (red and green; blue 0): eight values where the first
  endpoint is the larger (sevenths), else six and 0 and 255. BC5's signed
  kind adds 128 to each endpoint before the same interpolation, and its
  blue is 128.
* BC6H, signed and unsigned: the fourteen modes' endpoint bits, the
  transformed (delta) endpoints, unquantization to 16 bits, 3- or 4-bit
  weights, the scale by 31/64 (31/32 signed) to a half float, then Pillow's
  cut to 8 bits: the float clamped to [0, 1] and multiplied by 255 in
  single precision, truncated. The reserved modes give black. Pillow's
  readings are kept: the weighted sum is not rounded, and a transformed
  endpoint is masked to its width but not sign-extended again (a 16-bit
  one is read as two's complement).
* BC7: the eight modes (subsets, partition, rotation and index selection
  bits, endpoint and shared P-bits, colour and alpha widths, primary and
  secondary indices), endpoints widened by bit replication and weights of
  64ths rounded; a block without a mode bit is opaque black.

The partition, anchor and weight tables are BC7's (BC6H uses the two-subset
ones); ``tests/test_torch_image_more_formats.py`` holds each of them, and
every mode, against Pillow's decoder on seeded random blocks.
"""

from __future__ import annotations

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import error

# BC7's two-subset partitions (bit i: the subset of pixel i), three-subset
# partitions (2 bits a pixel), and the anchor pixels of subset 1 (two
# subsets) and of subsets 1 and 2 (three subsets)
SI2 = (0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00,
       0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C,
       0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8,
       0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
       0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
SI3 = (0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0, 0x5A5A5050, 0xAA550000,
       0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054,
       0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914,
       0x69691400, 0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424,
       0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0,
       0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580,
       0xAA141414, 0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
       0x2A4A5254)
AI0 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
       15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
AI1 = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
       8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12,
       3, 3)
AI2 = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15,
       10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
       3, 15, 15, 8)
WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
           4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}

# BC7's modes: subsets, partition bits, rotation bits, index selection bits, colour bits, alpha bits, endpoint
# P-bits, shared P-bits, index bits, secondary index bits
BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0), (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
             (2, 6, 0, 0, 7, 0, 1, 0, 2, 0), (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))

# BC6H's modes: (regions, transformed, endpoint bits, delta bits r, g, b, field layout after the mode bits). A
# field is (endpoint value, first bit, bit count), stored from its lowest bit up; values 0–2 are endpoint w's
# r, g, b, 3–5 x's, 6–8 y's, 9–11 z's, and 12 the partition; a count of −n stores n bits from the highest down.
_W, _X, _Y, _Z, _D = 0, 3, 6, 9, 12
_R, _G, _B = 0, 1, 2


def _f(v, lo, n=1):
    return (v, lo, n)


_BC6_MODES = {
    0: (2, 1, 10, (5, 5, 5), [_f(_Y + _G, 4), _f(_Y + _B, 4), _f(_Z + _B, 4), _f(_W + _R, 0, 10), _f(_W + _G, 0, 10),
                              _f(_W + _B, 0, 10), _f(_X + _R, 0, 5), _f(_Z + _G, 4), _f(_Y + _G, 0, 4),
                              _f(_X + _G, 0, 5), _f(_Z + _B, 0), _f(_Z + _G, 0, 4), _f(_X + _B, 0, 5), _f(_Z + _B, 1),
                              _f(_Y + _B, 0, 4), _f(_Y + _R, 0, 5), _f(_Z + _B, 2), _f(_Z + _R, 0, 5), _f(_Z + _B, 3),
                              _f(_D, 0, 5)]),
    1: (2, 1, 7, (6, 6, 6), [_f(_Y + _G, 5), _f(_Z + _G, 4), _f(_Z + _G, 5), _f(_W + _R, 0, 7), _f(_Z + _B, 0),
                             _f(_Z + _B, 1), _f(_Y + _B, 4), _f(_W + _G, 0, 7), _f(_Y + _B, 5), _f(_Z + _B, 2),
                             _f(_Y + _G, 4), _f(_W + _B, 0, 7), _f(_Z + _B, 3), _f(_Z + _B, 5), _f(_Z + _B, 4),
                             _f(_X + _R, 0, 6), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 6), _f(_Z + _G, 0, 4),
                             _f(_X + _B, 0, 6), _f(_Y + _B, 0, 4), _f(_Y + _R, 0, 6), _f(_Z + _R, 0, 6), _f(_D, 0, 5)]),
    2: (2, 1, 11, (5, 4, 4), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 5),
                              _f(_W + _R, 10), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 4), _f(_W + _G, 10), _f(_Z + _B, 0),
                              _f(_Z + _G, 0, 4), _f(_X + _B, 0, 4), _f(_W + _B, 10), _f(_Z + _B, 1), _f(_Y + _B, 0, 4),
                              _f(_Y + _R, 0, 5), _f(_Z + _B, 2), _f(_Z + _R, 0, 5), _f(_Z + _B, 3), _f(_D, 0, 5)]),
    3: (2, 1, 11, (4, 5, 4), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 4),
                              _f(_W + _R, 10), _f(_Z + _G, 4), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 5), _f(_W + _G, 10),
                              _f(_Z + _G, 0, 4), _f(_X + _B, 0, 4), _f(_W + _B, 10), _f(_Z + _B, 1), _f(_Y + _B, 0, 4),
                              _f(_Y + _R, 0, 4), _f(_Z + _B, 0), _f(_Z + _B, 2), _f(_Z + _R, 0, 4), _f(_Y + _G, 4),
                              _f(_Z + _B, 3), _f(_D, 0, 5)]),
    4: (2, 1, 11, (4, 4, 5), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 4),
                              _f(_W + _R, 10), _f(_Y + _B, 4), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 4), _f(_W + _G, 10),
                              _f(_Z + _B, 0), _f(_Z + _G, 0, 4), _f(_X + _B, 0, 5), _f(_W + _B, 10), _f(_Y + _B, 0, 4),
                              _f(_Y + _R, 0, 4), _f(_Z + _B, 1), _f(_Z + _B, 2), _f(_Z + _R, 0, 4), _f(_Z + _B, 4),
                              _f(_Z + _B, 3), _f(_D, 0, 5)]),
    5: (2, 1, 9, (5, 5, 5), [_f(_W + _R, 0, 9), _f(_Y + _B, 4), _f(_W + _G, 0, 9), _f(_Y + _G, 4), _f(_W + _B, 0, 9),
                             _f(_Z + _B, 4), _f(_X + _R, 0, 5), _f(_Z + _G, 4), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 5),
                             _f(_Z + _B, 0), _f(_Z + _G, 0, 4), _f(_X + _B, 0, 5), _f(_Z + _B, 1), _f(_Y + _B, 0, 4),
                             _f(_Y + _R, 0, 5), _f(_Z + _B, 2), _f(_Z + _R, 0, 5), _f(_Z + _B, 3), _f(_D, 0, 5)]),
    6: (2, 1, 8, (6, 5, 5), [_f(_W + _R, 0, 8), _f(_Z + _G, 4), _f(_Y + _B, 4), _f(_W + _G, 0, 8), _f(_Z + _B, 2),
                             _f(_Y + _G, 4), _f(_W + _B, 0, 8), _f(_Z + _B, 3), _f(_Z + _B, 4), _f(_X + _R, 0, 6),
                             _f(_Y + _G, 0, 4), _f(_X + _G, 0, 5), _f(_Z + _B, 0), _f(_Z + _G, 0, 4),
                             _f(_X + _B, 0, 5), _f(_Z + _B, 1), _f(_Y + _B, 0, 4), _f(_Y + _R, 0, 6), _f(_Z + _R, 0, 6),
                             _f(_D, 0, 5)]),
    7: (2, 1, 8, (5, 6, 5), [_f(_W + _R, 0, 8), _f(_Z + _B, 0), _f(_Y + _B, 4), _f(_W + _G, 0, 8), _f(_Y + _G, 5),
                             _f(_Y + _G, 4), _f(_W + _B, 0, 8), _f(_Z + _G, 5), _f(_Z + _B, 4), _f(_X + _R, 0, 5),
                             _f(_Z + _G, 4), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 6), _f(_Z + _G, 0, 4),
                             _f(_X + _B, 0, 5), _f(_Z + _B, 1), _f(_Y + _B, 0, 4), _f(_Y + _R, 0, 5), _f(_Z + _B, 2),
                             _f(_Z + _R, 0, 5), _f(_Z + _B, 3), _f(_D, 0, 5)]),
    8: (2, 1, 8, (5, 5, 6), [_f(_W + _R, 0, 8), _f(_Z + _B, 1), _f(_Y + _B, 4), _f(_W + _G, 0, 8), _f(_Y + _B, 5),
                             _f(_Y + _G, 4), _f(_W + _B, 0, 8), _f(_Z + _B, 5), _f(_Z + _B, 4), _f(_X + _R, 0, 5),
                             _f(_Z + _G, 4), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 5), _f(_Z + _B, 0), _f(_Z + _G, 0, 4),
                             _f(_X + _B, 0, 6), _f(_Y + _B, 0, 4), _f(_Y + _R, 0, 5), _f(_Z + _B, 2),
                             _f(_Z + _R, 0, 5), _f(_Z + _B, 3), _f(_D, 0, 5)]),
    9: (2, 0, 6, (6, 6, 6), [_f(_W + _R, 0, 6), _f(_Z + _G, 4), _f(_Z + _B, 0), _f(_Z + _B, 1), _f(_Y + _B, 4),
                             _f(_W + _G, 0, 6), _f(_Y + _G, 5), _f(_Y + _B, 5), _f(_Z + _B, 2), _f(_Y + _G, 4),
                             _f(_W + _B, 0, 6), _f(_Z + _G, 5), _f(_Z + _B, 3), _f(_Z + _B, 5), _f(_Z + _B, 4),
                             _f(_X + _R, 0, 6), _f(_Y + _G, 0, 4), _f(_X + _G, 0, 6), _f(_Z + _G, 0, 4),
                             _f(_X + _B, 0, 6), _f(_Y + _B, 0, 4), _f(_Y + _R, 0, 6), _f(_Z + _R, 0, 6), _f(_D, 0, 5)]),
    10: (1, 0, 10, (10, 10, 10), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 10),
                                  _f(_X + _G, 0, 10), _f(_X + _B, 0, 10)]),
    11: (1, 1, 11, (9, 9, 9), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 9),
                               _f(_W + _R, 10), _f(_X + _G, 0, 9), _f(_W + _G, 10), _f(_X + _B, 0, 9),
                               _f(_W + _B, 10)]),
    12: (1, 1, 12, (8, 8, 8), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 8),
                               _f(_W + _R, 11, -2), _f(_X + _G, 0, 8), _f(_W + _G, 11, -2), _f(_X + _B, 0, 8),
                               _f(_W + _B, 11, -2)]),
    13: (1, 1, 16, (4, 4, 4), [_f(_W + _R, 0, 10), _f(_W + _G, 0, 10), _f(_W + _B, 0, 10), _f(_X + _R, 0, 4),
                               _f(_W + _R, 15, -6), _f(_X + _G, 0, 4), _f(_W + _G, 15, -6), _f(_X + _B, 0, 4),
                               _f(_W + _B, 15, -6)]),
}


def _assemble(blocks: np.ndarray, width: int, height: int) -> np.ndarray:
    """``[n, 16, c]`` blocks in raster order → ``[height, width, c]``: blocks
    past the image's last are not read, those short of it leave black."""
    bw, bh = -(-width // 4), -(-height // 4)
    c = blocks.shape[2]
    full = np.zeros((bw * bh, 16, c), np.uint8)
    full[: min(len(blocks), bw * bh)] = blocks[: bw * bh]
    img = full.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, c)
    return img[:height, :width]


def _bc1_colours(raw: np.ndarray, four: bool) -> np.ndarray:
    """8-byte colour blocks ``[n, 8]`` → ``[n, 16, 4]`` RGBA."""
    c0 = raw[:, 0].astype(np.int64) | raw[:, 1].astype(np.int64) << 8
    c1 = raw[:, 2].astype(np.int64) | raw[:, 3].astype(np.int64) << 8
    lut = raw[:, 4:8].astype(np.int64)
    lut = lut[:, 0] | lut[:, 1] << 8 | lut[:, 2] << 16 | lut[:, 3] << 24

    def rgb565(x):
        r = (x & 0xF800) >> 8
        g = (x & 0x7E0) >> 3
        b = (x & 0x1F) << 3
        return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)

    p0, p1 = rgb565(c0), rgb565(c1)
    opaque = (c0 > c1)[:, None] | four
    p2 = np.where(opaque, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(opaque, (p0 + 2 * p1) // 3, 0)
    a = np.full((len(raw), 1), 255)
    table = np.stack([np.concatenate([p0, a], -1), np.concatenate([p1, a], -1), np.concatenate([p2, a], -1),
                      np.concatenate([p3, np.where(opaque, a, 0)], -1)], 1)  # [n, 4 colours, RGBA]
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(table, idx[:, :, None], 1).astype(np.uint8)


def bc3_alpha(raw: np.ndarray, signed: bool = False) -> np.ndarray:
    """8-byte BC4 blocks ``[n, 8]`` → ``[n, 16]`` values."""
    a0, a1 = raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64)
    if signed:
        a0, a1 = (a0 ^ 0x80), (a1 ^ 0x80)  # int8 + 128
    eight = a0 > a1
    k = np.arange(1, 7)
    inter8 = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    inter6 = ((5 - k[:4]) * a0[:, None] + k[:4] * a1[:, None]) // 5
    inter6 = np.concatenate([inter6, np.zeros((len(raw), 1), np.int64), np.full((len(raw), 1), 255)], 1)
    table = np.concatenate([a0[:, None], a1[:, None], np.where(eight[:, None], inter8, inter6)], 1) & 0xFF
    words = raw[:, 2:8].astype(np.int64)
    lut = sum(words[:, i] << (8 * i) for i in range(6))
    idx = (lut[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(table, idx, 1).astype(np.uint8)


def _get_bits(v: int, at: int, n: int) -> int:
    return (v >> at) & ((1 << n) - 1)


def _bc7_block(v: int) -> list:
    if not v & 0xFF:
        return [(0, 0, 0, 255)] * 16
    mode = (v & -v).bit_length() - 1
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = BC7_MODES[mode]
    bit = mode + 1
    partition = _get_bits(v, bit, pb)
    rotation = _get_bits(v, bit + pb, rb)
    index_sel = _get_bits(v, bit + pb + rb, isb)
    bit += pb + rb + isb
    numep = 2 * ns
    ep = [[0, 0, 0, 255] for _ in range(numep)]
    for ch in range(3):
        for i in range(numep):
            ep[i][ch] = _get_bits(v, bit, cb)
            bit += cb
    if ab:
        for i in range(numep):
            ep[i][3] = _get_bits(v, bit, ab)
            bit += ab
    chans = 4 if ab else 3
    if epb:
        cb, ab = cb + 1, ab + 1 if ab else 0
        for i in range(numep):
            p = _get_bits(v, bit, 1)
            bit += 1
            for ch in range(chans):
                ep[i][ch] = ep[i][ch] << 1 | p
    if spb:
        cb, ab = cb + 1, ab + 1 if ab else 0
        for i in range(0, numep, 2):
            p = _get_bits(v, bit, 1)
            bit += 1
            for e in (ep[i], ep[i + 1]):
                for ch in range(chans):
                    e[ch] = e[ch] << 1 | p
    for e in ep:
        for ch in range(chans):
            bits = cb if ch < 3 else ab
            x = (e[ch] << (8 - bits)) & 0xFF
            e[ch] = x | (x >> bits)
    cw = WEIGHTS[ib]
    aw = WEIGHTS[ib2 if ab and ib2 else ib]
    cibit = bit
    aibit = cibit + 16 * ib - ns
    out = []
    for i in range(16):
        if ns == 2:
            s = (SI2[partition] >> i) & 1
        elif ns == 3:
            s = (SI3[partition] >> (2 * i)) & 3
        else:
            s = 0
        n = ib
        if i == 0 or (ns == 2 and i == AI0[partition]) or (ns == 3 and i in (AI1[partition], AI2[partition])):
            n -= 1
        i0 = _get_bits(v, cibit, n)
        cibit += n
        if ab and ib2:
            n2 = ib2 - 1 if i == 0 else ib2
            i1 = _get_bits(v, aibit, n2)
            aibit += n2
            s0, s1 = (aw[i1], cw[i0]) if index_sel else (cw[i0], aw[i1])
        else:
            s0 = s1 = cw[i0]
        e0, e1 = ep[2 * s], ep[2 * s + 1]
        px = [((64 - s0) * e0[c] + s0 * e1[c] + 32) >> 6 for c in range(3)]
        px.append(((64 - s1) * e0[3] + s1 * e1[3] + 32) >> 6)
        if rotation:
            px[rotation - 1], px[3] = px[3], px[rotation - 1]
        out.append(tuple(px))
    return out


def _sign_extend(x: int, bits: int) -> int:
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def _bc6_unquantize(x: int, bits: int, signed: bool) -> int:
    if not signed:
        if bits >= 15:
            return x
        if x == 0:
            return 0
        if x == (1 << bits) - 1:
            return 0xFFFF
        return ((x << 16) + 0x8000) >> bits
    if bits >= 16:
        return _sign_extend(x, 16)
    neg = x < 0
    x = -x if neg else x
    if x == 0:
        q = 0
    elif x >= (1 << (bits - 1)) - 1:
        q = 0x7FFF
    else:
        q = ((x << 15) + 0x4000) >> (bits - 1)
    return -q if neg else q


def _bc6_halves(v: int, signed: bool):
    """One BC6H block → 16 (r, g, b) half floats as uint16, or None for a
    reserved mode."""
    m = v & 0x1F
    if m & 3 in (0, 1):
        mode, bit = m & 3, 2
    elif m & 3 == 2:
        mode, bit = 2 + (m >> 2), 5
    else:
        mode, bit = 10 + (m >> 2), 5
    if mode >= 14:
        return None
    regions, transformed, epb, dbits, fields = _BC6_MODES[mode]
    e = [0] * 13
    for val, lo, n in fields:
        if n > 0:
            e[val] |= _get_bits(v, bit, n) << lo
            bit += n
        else:
            for k in range(-n):
                e[val] |= _get_bits(v, bit, 1) << (lo - k)
                bit += 1
    numep = 12 if regions == 2 else 6
    ends = e[:numep]
    if signed:
        ends[:3] = [_sign_extend(x, epb) for x in ends[:3]]
    if signed or transformed:
        for i in range(3, numep):
            ends[i] = _sign_extend(ends[i], dbits[i % 3] if transformed else epb)
    if transformed:  # Pillow masks the sums to the endpoint width and does not sign-extend them again
        for i in range(3, numep):
            ends[i] = (ends[i] + ends[i % 3]) & ((1 << epb) - 1)
    unq = [_bc6_unquantize(x, epb, signed) for x in ends]
    ib = 3 if regions == 2 else 4
    weights = WEIGHTS[ib]
    partition = e[_D]
    ibit = 82 if regions == 2 else 65
    out = []
    for i in range(16):
        s = (SI2[partition] >> i) & 1 if regions == 2 else 0
        n = ib - 1 if i == 0 or (regions == 2 and i == AI0[partition]) else ib
        w = weights[_get_bits(v, ibit, n)]
        ibit += n
        px = []
        for c in range(3):
            x = (unq[6 * s + c] * (64 - w) + unq[6 * s + 3 + c] * w) >> 6  # (Pillow does not round)
            if not signed:
                h = (x * 31) >> 6
            elif x < 0:
                h = 0x8000 | ((-x * 31) >> 5)
            else:
                h = (x * 31) >> 5
            px.append(h)
        out.append(px)
    return out


def _bc6(words: list, signed: bool) -> np.ndarray:
    """BC6H blocks → ``[n, 16, 3]``: each half float clamped to [0, 1] and
    multiplied by 255 in single precision, truncated."""
    halves = np.zeros((len(words), 16, 3), np.uint16)
    for k, v in enumerate(words):
        h = _bc6_halves(v, signed)
        if h is not None:
            halves[k] = h
    f = halves.view(np.float16).astype(np.float32)
    inside = np.clip(f, 0, 1) * np.float32(255)
    return np.where(f > 1, 255, inside.astype(np.int64)).astype(np.uint8)


def decode_bcn(data: bytes, width: int, height: int, n: int, pixel_format: str = "", fmt: str = "DDS") -> np.ndarray:
    """BCn ``n`` (1–7) blocks → uint8 ``[height, width, c]``: RGBA for BC1,
    BC2, BC3 and BC7, grey for BC4, RGB for BC5 and BC6H. ``pixel_format``
    "BC5S" and "BC6HS" pick the signed kinds. A stream shorter than the
    image raises (naming the file format ``fmt``), as Pillow's reader does
    on a truncated file."""
    size = 8 if n in (1, 4) else 16
    blocks = -(-width // 4) * -(-height // 4)
    if len(data) < blocks * size:
        raise error(fmt, "the image data is truncated (Pillow refuses it too)")
    raw = np.frombuffer(data[: blocks * size], np.uint8).reshape(blocks, size)
    if n == 1:
        out = _bc1_colours(raw, False)
    elif n == 2:
        out = _bc1_colours(raw[:, 8:], True)
        nib = raw[:, :8].astype(np.int64)
        a = np.stack([nib & 15, nib >> 4], -1).reshape(blocks, 16)
        out[:, :, 3] = a * 17
    elif n == 3:
        out = _bc1_colours(raw[:, 8:], True)
        out[:, :, 3] = bc3_alpha(raw[:, :8])
    elif n == 4:
        out = bc3_alpha(raw)[:, :, None]
    elif n == 5:
        signed = pixel_format == "BC5S"
        out = np.full((blocks, 16, 3), 128 if signed else 0, np.uint8)
        out[:, :, 0] = bc3_alpha(raw[:, :8], signed)
        out[:, :, 1] = bc3_alpha(raw[:, 8:], signed)
    else:
        words = [int.from_bytes(raw[k].tobytes(), "little") for k in range(blocks)]
        if n == 6:
            out = _bc6(words, pixel_format == "BC6HS")
        else:
            out = np.array([_bc7_block(v) for v in words], np.uint8).reshape(blocks, 16, 4)
    return _assemble(out, width, height)
