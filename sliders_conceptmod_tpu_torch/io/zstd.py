"""Zstandard decoding (RFC 8878) in numpy and plain Python, for TIFF's ZSTD
compression (50000), as libtiff 4.7's ``tif_zstd.c`` reads a strip or tile
through libzstd under Pillow 12 (the GPU machine has no PIL and no
``zstandard``).

* One frame, the first, as libtiff reads a strip or tile: what follows it
  is not read, and a skippable frame (magic 0x184D2A50–5F) gives nothing.
  The frame header's window descriptor, dictionary ID (a frame that needs
  a dictionary is refused) and content size are read, and the content
  checksum (the low 32 bits of XXH64, seed 0) is verified when the frame
  has one.
* Raw, RLE and compressed blocks. A compressed block's literals: raw, RLE,
  Huffman-coded in one stream or four (the jump table's sizes), with a tree
  described by direct 4-bit weights or FSE-coded weights (two interleaved
  states), or treeless (the previous block's tree). Its sequences: literal
  length, offset and match length codes under FSE tables that are
  predefined, RLE, described in the block (normalized counts, the table
  spread by RFC 8878 4.1.1) or repeated from the previous block; the
  repeat offsets (1, 4, 8 at the frame's start, shifted where a literal
  length is 0); matches copied byte by byte, so they may overlap
  themselves.

Any malformed stream raises ``ValueError``, as libzstd fails on it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import error

MAGIC = 0xFD2FB528

# RFC 8878 3.1.1.3.2.1.1: literal length and match length codes → (baseline, extra bits)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6), (128, 7), (256, 8),
    (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4), (99, 5), (131, 7),
    (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# RFC 8878 3.1.1.3.2.2: the predefined distributions and their accuracy logs
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
_MAX_AL = {"ll": 9, "of": 8, "ml": 9}
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}

_M64 = (1 << 64) - 1
_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                           0x27D4EB2F165667C5)


def _bad(what: str) -> ValueError:
    return error("ZSTD", f"{what} (libzstd refuses it)")


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64

    def round_(acc, lane):
        return (rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64

    n = len(data)
    pos = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data[: n // 32 * 32], "<u8").reshape(-1, 4).tolist()
        for stripe in lanes:
            v = [round_(v[i], stripe[i]) for i in range(4)]
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ round_(0, x)) * _P1 + _P4) & _M64
        pos = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h = (rotl(h ^ round_(0, int.from_bytes(data[pos : pos + 8], "little")), 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[pos : pos + 4], "little") * _P1 & _M64), 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h = (rotl(h ^ (data[pos] * _P5 & _M64), 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


class _Backward:
    """A bitstream read from its end towards its start (RFC 8878 4.1.1): the
    last byte's highest set bit marks the end; reads past the start give
    zeros. ``words[j]`` holds the 64 bits from byte ``j`` on, so a read costs
    the same anywhere in a long stream."""

    def __init__(self, data: bytes):
        if not data or not data[-1]:
            raise _bad("a bitstream without its end marker")
        a = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.uint64)
        words = np.zeros(len(data), np.uint64)
        for k in range(8):
            words |= a[k : k + len(data)] << np.uint64(8 * k)
        self.words = words.tolist()
        self.offset = len(data) * 8 - (8 - data[-1].bit_length()) - 1

    def read(self, n: int) -> int:
        self.offset -= n
        start = self.offset
        if start >= 0:
            return (self.words[start >> 3] >> (start & 7)) & ((1 << n) - 1)
        if n + start <= 0:
            return 0
        return ((self.words[0] & ((1 << (n + start)) - 1)) << -start) & ((1 << n) - 1)


class _Fse:
    """An FSE decoding table: per state (symbol, bits, baseline)."""

    def __init__(self, counts: List[int], al: int):
        size = 1 << al
        symbol = [0] * size
        high = size - 1
        for s, c in enumerate(counts):
            if c == -1:
                symbol[high] = s
                high -= 1
        pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise _bad("an FSE distribution that does not fill its table")
        nxt = [1 if c == -1 else c for c in counts]
        self.symbol, self.bits, self.base = symbol, [0] * size, [0] * size
        for u in range(size):
            s = symbol[u]
            x = nxt[s]
            nxt[s] += 1
            nb = al - (x.bit_length() - 1)
            self.bits[u], self.base[u] = nb, (x << nb) - size
        self.al = al

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        t = cls.__new__(cls)
        t.symbol, t.bits, t.base, t.al = [symbol], [0], [0], 0
        return t


def _read_distribution(data: bytes, pos: int, max_al: int, max_symbol: int) -> Tuple[List[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1): (counts, accuracy log, the
    position after it)."""
    bit = pos * 8
    value = int.from_bytes(data[pos : pos + 512], "little")  # more than any description needs

    def take(n):
        nonlocal bit
        v = (value >> (bit - pos * 8)) & ((1 << n) - 1)
        bit += n
        return v

    al = take(4) + 5
    if al > max_al:
        raise _bad(f"an FSE accuracy log of {al}")
    remaining, threshold, nbits = (1 << al) + 1, 1 << al, al + 1
    counts: List[int] = []
    while remaining > 1 and len(counts) <= max_symbol:
        top = 2 * threshold - 1 - remaining
        low = (value >> (bit - pos * 8)) & (threshold - 1)
        if low < top:
            v = low
            bit += nbits - 1
        else:
            v = take(nbits)
            if v >= threshold:
                v -= top
        count = v - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                repeat = take(2)
                counts += [0] * repeat
                if repeat != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise _bad("a malformed FSE distribution")
    return counts, al, pos + (bit - pos * 8 + 7) // 8


class _Huffman:
    """A literals Huffman table indexed by the next ``max_bits`` bits."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if not total:
            raise _bad("a Huffman tree without weights")
        max_bits = total.bit_length()
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise _bad("Huffman weights that do not complete a tree")
        weights = weights + [left.bit_length()]
        if max_bits > 11:
            raise _bad(f"a Huffman tree {max_bits} bits deep")
        size = 1 << max_bits
        self.symbol, self.bits = [0] * size, [0] * size
        start, pos = {}, 0
        for w in range(1, max_bits + 1):
            start[w] = pos
            pos += sum(1 for x in weights if x == w) << (w - 1)
        for s, w in enumerate(weights):
            if w:
                n = 1 << (w - 1)
                at = start[w]
                self.symbol[at : at + n] = [s] * n
                self.bits[at : at + n] = [max_bits + 1 - w] * n
                start[w] += n
        self.max_bits = max_bits

    def decode(self, stream: bytes, count: int) -> bytes:
        bits = _Backward(stream)
        mb, mask = self.max_bits, (1 << self.max_bits) - 1
        state = bits.read(mb)
        out = bytearray(count)
        symbol, nbits, read = self.symbol, self.bits, bits.read
        for i in range(count):
            out[i] = symbol[state]
            n = nbits[state]
            state = ((state << n) + read(n)) & mask
        if bits.offset != -mb:
            raise _bad("a Huffman stream not consumed exactly")
        return bytes(out)


def _huffman_tree(data: bytes, pos: int) -> Tuple[_Huffman, int]:
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = data[pos : pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise _bad("truncated Huffman weights")
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
        return _Huffman(weights), pos + (n + 1) // 2
    counts, al, at = _read_distribution(data, pos, 6, 255)
    table = _Fse(counts, al)
    bits = _Backward(data[at : pos + head])
    states = [bits.read(al), bits.read(al)]
    weights: List[int] = []
    k = 0
    while True:
        s = states[k]
        weights.append(table.symbol[s])
        states[k] = table.base[s] + bits.read(table.bits[s])
        if bits.offset < 0:
            weights.append(table.symbol[states[k ^ 1]])
            break
        k ^= 1
    return _Huffman(weights), pos + head


class _Frame:
    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]
        self.out = bytearray()


def _literals(data: bytes, pos: int, end: int, frame: _Frame) -> Tuple[bytes, int]:
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > end:
                raise _bad("raw literals past their block")
            return data[pos : pos + size], pos + size
        return bytes([data[pos]]) * size, pos + 1
    h = int.from_bytes(data[pos : pos + 5], "little")
    if fmt in (0, 1):
        size, csize, pos, streams = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF, pos + 3, 1 if fmt == 0 else 4
    elif fmt == 2:
        size, csize, pos, streams = (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF, pos + 4, 4
    else:
        size, csize, pos, streams = (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF, pos + 5, 4
    stop = pos + csize
    if stop > end:
        raise _bad("compressed literals past their block")
    if kind == 2:
        frame.huffman, pos = _huffman_tree(data, pos)
    elif frame.huffman is None:
        raise _bad("treeless literals without a previous tree")
    if streams == 1:
        return frame.huffman.decode(data[pos:stop], size), stop
    s1, s2, s3 = (int.from_bytes(data[pos + 2 * i : pos + 2 * i + 2], "little") for i in range(3))
    pos += 6
    part = (size + 3) // 4
    sizes = [s1, s2, s3, stop - pos - s1 - s2 - s3]
    if sizes[3] < 0:
        raise _bad("a jump table past its literals")
    out = []
    for i in range(4):
        n = part if i < 3 else size - 3 * part
        out.append(frame.huffman.decode(data[pos : pos + sizes[i]], n))
        pos += sizes[i]
    return b"".join(out), stop


def _table(data: bytes, pos: int, mode: int, kind: str, frame: _Frame) -> int:
    if mode == 0:
        counts, al = {"ll": LL_DEFAULT, "of": OF_DEFAULT, "ml": ML_DEFAULT}[kind]
        frame.tables[kind] = _Fse(counts, al)
    elif mode == 1:
        frame.tables[kind] = _Fse.rle(data[pos])
        pos += 1
    elif mode == 2:
        counts, al, pos = _read_distribution(data, pos, _MAX_AL[kind], _MAX_SYMBOL[kind])
        frame.tables[kind] = _Fse(counts, al)
    elif frame.tables[kind] is None:
        raise _bad("a repeated table without a previous one")
    return pos


def _block(data: bytes, pos: int, end: int, frame: _Frame) -> None:
    literals, pos = _literals(data, pos, end, frame)
    n = data[pos]
    if n == 0:
        frame.out += literals
        return
    if n < 128:
        pos += 1
    elif n < 255:
        n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise _bad("reserved bits in the symbol compression modes")
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _table(data, pos, (modes >> shift) & 3, kind, frame)
    ll_t, of_t, ml_t = frame.tables["ll"], frame.tables["of"], frame.tables["ml"]
    bits = _Backward(data[pos:end])
    sll, sof, sml = bits.read(ll_t.al), bits.read(of_t.al), bits.read(ml_t.al)
    out, reps = frame.out, frame.reps
    lit = 0
    for i in range(n):
        of_code, ml_code, ll_code = of_t.symbol[sof], ml_t.symbol[sml], ll_t.symbol[sll]
        if of_code > 31:
            raise _bad(f"offset code {of_code}")
        offset_value = (1 << of_code) + bits.read(of_code)
        base, extra = ML_CODES[ml_code]
        match = base + bits.read(extra)
        base, extra = LL_CODES[ll_code]
        length = base + bits.read(extra)
        if offset_value > 3:
            offset = offset_value - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = offset_value - 1 + (length == 0)
            if idx == 0:
                offset = reps[0]
            else:
                offset = reps[idx] if idx < 3 else reps[0] - 1
                if idx > 1:
                    reps[2] = reps[1]
                reps[1] = reps[0]
                reps[0] = offset
        if i < n - 1:
            sll = ll_t.base[sll] + bits.read(ll_t.bits[sll])
            sml = ml_t.base[sml] + bits.read(ml_t.bits[sml])
            sof = of_t.base[sof] + bits.read(of_t.bits[sof])
        if lit + length > len(literals):
            raise _bad("a sequence past its literals")
        out += literals[lit : lit + length]
        lit += length
        start = len(out) - offset
        if offset <= 0 or start < 0:
            raise _bad(f"an offset of {offset} before the data")
        if offset >= match:
            out += out[start : start + match]
        else:
            chunk = out[start:]
            out += (chunk * (match // offset + 1))[:match]
    if bits.offset != 0:
        raise _bad("a sequences bitstream not consumed exactly")
    out += literals[lit:]


def _frame(data: bytes, pos: int) -> bytes:
    desc = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
    if desc & 8:
        raise _bad("a reserved frame header bit")
    if not single:
        pos += 1  # window descriptor: the whole frame is kept, so any window is met
    dict_size = (0, 1, 2, 4)[dict_flag]
    if dict_size and int.from_bytes(data[pos : pos + dict_size], "little"):
        raise _bad("a frame that needs a dictionary")
    pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = int.from_bytes(data[pos : pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    frame = _Frame()
    while True:
        if pos + 3 > len(data):
            raise _bad("a truncated block header")
        head = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 0:
            if pos + size > len(data):
                raise _bad("a truncated raw block")
            frame.out += data[pos : pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                raise _bad("a truncated RLE block")
            frame.out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if pos + size > len(data):
                raise _bad("a truncated compressed block")
            _block(data, pos, pos + size, frame)
            pos += size
        else:
            raise _bad("a reserved block type")
        if last:
            break
    if fcs_size and len(frame.out) != content_size:
        raise _bad("a frame whose content differs from its stated size")
    if checksum:
        if int.from_bytes(data[pos : pos + 4], "little") != xxh64(bytes(frame.out)) & 0xFFFFFFFF:
            raise _bad("a frame whose checksum does not match")
    return bytes(frame.out)


def decode_zstd(data: bytes) -> bytes:
    """The first Zstandard frame of ``data`` → its content (nothing when it
    is a skippable frame), as libtiff reads one frame a strip."""
    data = bytes(data)
    magic = int.from_bytes(data[:4], "little")
    if magic & 0xFFFFFFF0 == 0x184D2A50:
        return b""
    if magic != MAGIC:
        raise _bad("data that is not a Zstandard frame")
    try:
        return _frame(data, 4)
    except IndexError:
        raise _bad("a truncated frame") from None
