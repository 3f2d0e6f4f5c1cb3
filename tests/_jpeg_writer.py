"""A baseline JPEG writer for the decoder tests: any sampling factors per
component (Pillow writes only 4:4:4, 4:2:2 and 4:2:0), the standard
Huffman tables of ITU T.81 Annex K, and an optional JFIF or Adobe marker and
component ids. The tests take Pillow's decode of its files as the reference;
its own quality does not matter."""

import struct

import numpy as np

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


def write_jpeg(image: np.ndarray, sampling=((2, 2), (1, 1), (1, 1)), quality_scale: float = 0.5,
               ids=(1, 2, 3), jfif: bool = True, adobe_transform=None, ycc: bool = True, restart: int = 0) -> bytes:
    """``image`` uint8 ``[H, W, 3]`` (or ``[H, W]`` grey, one component) →
    baseline JPEG bytes. ``sampling`` gives each component's (h, v);
    ``ycc`` converts RGB to YCbCr first (leave it off for an RGB file)."""
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        img, sampling, ids = img[:, :, None], ((1, 1),), ids[:1]
    h_img, w_img, nc = img.shape
    if ycc and nc == 3:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        img = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                        0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    pad = np.pad(img, ((0, mcuy * 8 * vmax - h_img), (0, mcux * 8 * hmax - w_img), (0, 0)), mode="edge")
    qtabs = [np.clip(np.round(LUMA_Q * quality_scale), 1, 255), np.clip(np.round(CHROMA_Q * quality_scale), 1, 255)]
    C = _dct_matrix()
    blocks = []  # per component [by, bx, 64] zigzag-ordered quantised coefficients
    for ci in range(nc):
        h, v = sampling[ci]
        fy, fx = vmax // v, hmax // h
        plane = pad[:, :, ci].reshape(pad.shape[0] // fy, fy, pad.shape[1] // fx, fx).mean((1, 3)) - 128
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        b = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", C, b, C).reshape(bh, bw, 64)
        q = qtabs[min(ci, 1)]
        blocks.append(np.round(coef / q).astype(np.int64)[:, :, ZIGZAG])
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    segments, w = [], _BitWriter()
    pred = [0] * nc
    n_mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                w.flush()
                segments.append(bytes(w.out) + bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8]))
                w, pred = _BitWriter(), [0] * nc
            n_mcu += 1
            for ci in range(nc):
                h, v = sampling[ci] if nc > 1 else (1, 1)
                dc_codes, ac_codes = tables[min(ci, 1)]
                for y in range(v):
                    for x in range(h):
                        if nc > 1:
                            blk = blocks[ci][my * v + y, mx * h + x]
                        else:
                            blk = blocks[ci][my, mx]
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

    def marker(code, payload):
        return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload

    out = b"\xff\xd8"
    if jfif:
        out += marker(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe_transform]))
    for t, q in enumerate(qtabs[: min(nc, 2)]):
        out += marker(0xDB, bytes([t]) + bytes(q.astype(np.int64)[ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, h_img, w_img, nc)
    for ci in range(nc):
        h, v = sampling[ci]
        sof += bytes([ids[ci], (h << 4) | v, min(ci, 1)])
    out += marker(0xC0, sof)
    for tc, th, (counts, symbols) in ((0, 0, DC_LUMA), (1, 0, AC_LUMA), (0, 1, DC_CHROMA), (1, 1, AC_CHROMA)):
        if th < min(nc, 2):
            out += marker(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols))
    if restart:
        out += marker(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ids[ci], (min(ci, 1) << 4) | min(ci, 1)]) for ci in range(nc)) + b"\x00\x3f\x00"
    out += marker(0xDA, sos) + b"".join(segments)
    return out + b"\xff\xd9"
