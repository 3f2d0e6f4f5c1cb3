"""CCITT fax decoding for TIFF (compressions 2, 3 and 4), as libtiff 4.7's
``tif_fax3.c`` decodes a strip or tile under Pillow 12 (the GPU machine has
no PIL).

* Compression 2 (modified Huffman): each row's white and black runs coded by
  T.4's terminating and make-up codes (the extended make-up codes shared by
  both colours), every row starting on a byte.
* Compression 3 (T.4): each row after an end-of-line code (at least 11 zero
  bits and a one; fill bits before it are skipped, so ``T4Options`` bit 2
  needs nothing of its own). With ``T4Options`` bit 0 a tag bit follows the
  EOL: 1 for a row of runs, 0 for a row coded against the row above (T.4's
  two-dimensional modes). Uncompressed mode's extension code is refused
  where it occurs, as libtiff refuses it.
* Compression 4 (T.6): every row coded against the row above, the first
  against an all-white row; no EOLs.

The output is each row's bits packed most significant first, a white run's
bits 0 and a black run's 1, as libtiff fills them; the TIFF reader maps them
to pixels by the photometric interpretation. Fill order 2 is undone by the
caller before the data comes here. A code that is not in the tables, an
EOL inside a horizontal mode or a vertical mode left of a0 refuses the
strip; a row whose runs miss its width is cut or padded white, as libtiff's
``CLEANUP_RUNS`` does; data that ends early leaves the rest of the strip
white (libtiff refuses such a strip or leaves the rest of its buffer as it
was, so Pillow's pixels there are not defined).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import error

# T.4 Tables 2 and 3: run length → code, terminating (0–63) and make-up (64–1728) codes
WHITE_CODES = {
    0: "00110101", 1: "000111", 2: "0111", 3: "1000", 4: "1011", 5: "1100", 6: "1110", 7: "1111", 8: "10011",
    9: "10100", 10: "00111", 11: "01000", 12: "001000", 13: "000011", 14: "110100", 15: "110101", 16: "101010",
    17: "101011", 18: "0100111", 19: "0001100", 20: "0001000", 21: "0010111", 22: "0000011", 23: "0000100",
    24: "0101000", 25: "0101011", 26: "0010011", 27: "0100100", 28: "0011000", 29: "00000010", 30: "00000011",
    31: "00011010", 32: "00011011", 33: "00010010", 34: "00010011", 35: "00010100", 36: "00010101",
    37: "00010110", 38: "00010111", 39: "00101000", 40: "00101001", 41: "00101010", 42: "00101011",
    43: "00101100", 44: "00101101", 45: "00000100", 46: "00000101", 47: "00001010", 48: "00001011",
    49: "01010010", 50: "01010011", 51: "01010100", 52: "01010101", 53: "00100100", 54: "00100101",
    55: "01011000", 56: "01011001", 57: "01011010", 58: "01011011", 59: "01001010", 60: "01001011",
    61: "00110010", 62: "00110011", 63: "00110100",
    64: "11011", 128: "10010", 192: "010111", 256: "0110111", 320: "00110110", 384: "00110111", 448: "01100100",
    512: "01100101", 576: "01101000", 640: "01100111", 704: "011001100", 768: "011001101", 832: "011010010",
    896: "011010011", 960: "011010100", 1024: "011010101", 1088: "011010110", 1152: "011010111",
    1216: "011011000", 1280: "011011001", 1344: "011011010", 1408: "011011011", 1472: "010011000",
    1536: "010011001", 1600: "010011010", 1664: "011000", 1728: "010011011",
}
BLACK_CODES = {
    0: "0000110111", 1: "010", 2: "11", 3: "10", 4: "011", 5: "0011", 6: "0010", 7: "00011", 8: "000101",
    9: "000100", 10: "0000100", 11: "0000101", 12: "0000111", 13: "00000100", 14: "00000111", 15: "000011000",
    16: "0000010111", 17: "0000011000", 18: "0000001000", 19: "00001100111", 20: "00001101000",
    21: "00001101100", 22: "00000110111", 23: "00000101000", 24: "00000010111", 25: "00000011000",
    26: "000011001010", 27: "000011001011", 28: "000011001100", 29: "000011001101", 30: "000001101000",
    31: "000001101001", 32: "000001101010", 33: "000001101011", 34: "000011010010", 35: "000011010011",
    36: "000011010100", 37: "000011010101", 38: "000011010110", 39: "000011010111", 40: "000001101100",
    41: "000001101101", 42: "000011011010", 43: "000011011011", 44: "000001010100", 45: "000001010101",
    46: "000001010110", 47: "000001010111", 48: "000001100100", 49: "000001100101", 50: "000001010010",
    51: "000001010011", 52: "000000100100", 53: "000000110111", 54: "000000111000", 55: "000000100111",
    56: "000000101000", 57: "000001011000", 58: "000001011001", 59: "000000101011", 60: "000000101100",
    61: "000001011010", 62: "000001100110", 63: "000001100111",
    64: "0000001111", 128: "000011001000", 192: "000011001001", 256: "000001011011", 320: "000000110011",
    384: "000000110100", 448: "000000110101", 512: "0000001101100", 576: "0000001101101",
    640: "0000001001010", 704: "0000001001011", 768: "0000001001100", 832: "0000001001101",
    896: "0000001110010", 960: "0000001110011", 1024: "0000001110100", 1088: "0000001110101",
    1152: "0000001110110", 1216: "0000001110111", 1280: "0000001010010", 1344: "0000001010011",
    1408: "0000001010100", 1472: "0000001010101", 1536: "0000001011010", 1600: "0000001011011",
    1664: "0000001100100", 1728: "0000001100101",
}
# T.4 Table 3 (continued): the extended make-up codes of both colours
EXTENDED_CODES = {
    1792: "00000001000", 1856: "00000001100", 1920: "00000001101", 1984: "000000010010", 2048: "000000010011",
    2112: "000000010100", 2176: "000000010101", 2240: "000000010110", 2304: "000000010111",
    2368: "000000011100", 2432: "000000011101", 2496: "000000011110", 2560: "000000011111",
}
# T.4 Table 4: the two-dimensional modes (pass, horizontal, vertical a1 − b1 = −3 … 3)
PASS, HORIZ, EXT, EOL = "P", "H", "X", "E"
MODE_CODES = {PASS: "0001", HORIZ: "001", 0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
              -3: "0000010", EXT: "0000001"}

_PEEK = 13  # the longest run code
_EOL_RUN = -1
_BAD = -2


def _table(codes: Dict[int, str]) -> Tuple[List[int], List[int]]:
    """Run codes → (run, length) by the next ``_PEEK`` bits; 11 leading zero
    bits are an EOL, anything else unknown is marked bad."""
    run = [_BAD] * (1 << _PEEK)
    length = [0] * (1 << _PEEK)
    for value, code in {**codes, **EXTENDED_CODES}.items():
        n = len(code)
        base = int(code, 2) << (_PEEK - n)
        for k in range(1 << (_PEEK - n)):
            run[base + k], length[base + k] = value, n
    for k in range(1 << (_PEEK - 11)):  # 00000000000x…: an EOL, its bits left for the row's sync
        run[k], length[k] = _EOL_RUN, 0
    return run, length


def _mode_table() -> Tuple[list, List[int]]:
    """Mode codes → (mode, length) by the next 7 bits (every 7-bit value is
    a mode or the start of an EOL)."""
    mode: list = [EOL] * (1 << 7)
    length = [0] * (1 << 7)
    for value, code in MODE_CODES.items():
        n = len(code)
        base = int(code, 2) << (7 - n)
        for k in range(1 << (7 - n)):
            mode[base + k], length[base + k] = value, n
    return mode, length


_WHITE = _table(WHITE_CODES)
_BLACK = _table(BLACK_CODES)
_MODES = _mode_table()


class _Bits:
    """Most significant bit first; ``peek(n)`` reads past the end as zeros."""

    def __init__(self, data: bytes):
        bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
        self.nbits = bits.size
        padded = np.concatenate([bits, np.zeros(16, np.uint8)]).astype(np.int64)
        win = np.zeros(self.nbits + 1, np.int64)
        for k in range(16):
            win += padded[k : k + self.nbits + 1] << (15 - k)
        self.win = win.tolist()
        self.pos = 0

    def peek(self, n: int) -> int:
        return self.win[min(self.pos, self.nbits)] >> (16 - n)

    def eof(self) -> bool:
        return self.pos >= self.nbits


class _EndOfData(Exception):
    pass


def _bad(what: str) -> ValueError:
    return error("TIFF", f"CCITT data with {what} (libtiff refuses it)")


class _Row:
    """A row's runs as libtiff builds them (``thisrun``, ``a0``,
    ``RunLength``): white, black, white, … run lengths."""

    def __init__(self, width: int):
        self.runs: List[int] = []
        self.a0 = 0
        self.pending = 0
        self.width = width

    def setvalue(self, x: int) -> None:
        self.runs.append(self.pending + x)
        self.a0 += x
        self.pending = 0

    def run(self, bits: _Bits, table) -> bool:
        """One colour's run: make-up codes, then a terminating code; False at
        an EOL, which is left unread for the next row's sync."""
        runs, lengths = table
        while True:
            if bits.eof():
                raise _EndOfData
            k = bits.peek(_PEEK)
            value = runs[k]
            if value == _EOL_RUN:
                return False
            if value == _BAD:
                raise _bad("a run code that is not in T.4's tables")
            bits.pos += lengths[k]
            if value < 64:
                self.setvalue(value)
                return True
            self.a0 += value
            self.pending += value

    def cleanup(self) -> List[int]:
        """CLEANUP_RUNS: a pending length closed, a row too long or too short
        cut or padded white to the width."""
        if self.pending:
            self.setvalue(0)
        if self.a0 != self.width:
            while self.a0 > self.width and self.runs:
                self.a0 -= self.runs.pop()
            if self.a0 < self.width:
                self.a0 = max(self.a0, 0)
                if len(self.runs) & 1:
                    self.setvalue(0)
                self.setvalue(self.width - self.a0)
            elif self.a0 > self.width:
                self.setvalue(self.width)
                self.setvalue(0)
        return self.runs


def _row_1d(bits: _Bits, width: int) -> List[int]:
    """EXPAND1D: white and black runs until the width is reached."""
    row = _Row(width)
    while True:
        if not row.run(bits, _WHITE) or row.a0 >= width:
            break
        if not row.run(bits, _BLACK) or row.a0 >= width:
            break
        if row.runs[-1] == 0 and row.runs[-2] == 0:
            del row.runs[-2:]
    return row.cleanup()


def _row_2d(bits: _Bits, ref: List[int], width: int) -> List[int]:
    """EXPAND2D: a row coded against the runs of the row above, ``ref``,
    with b1 walked along them as libtiff walks it."""
    ref = ref + [0] * 8
    row = _Row(width)
    modes, lengths = _MODES
    b1, pb = ref[0], 1

    def check_b1():
        nonlocal b1, pb
        if row.runs:
            while b1 <= row.a0 and b1 < width:
                b1 += ref[pb] + ref[pb + 1]
                pb += 2

    while row.a0 < width:
        if bits.eof():
            raise _EndOfData
        k = bits.peek(7)
        mode = modes[k]
        if mode == EXT:
            raise _bad("uncompressed mode")
        if mode == EOL:
            row.runs.append(width - row.a0)
            row.a0 = width
            break
        bits.pos += lengths[k]
        if mode == PASS:
            check_b1()
            b1 += ref[pb]
            row.pending += b1 - row.a0
            row.a0 = b1
            b1 += ref[pb + 1]
            pb += 2
        elif mode == HORIZ:
            first, second = (_BLACK, _WHITE) if len(row.runs) & 1 else (_WHITE, _BLACK)
            if not row.run(bits, first) or not row.run(bits, second):
                raise _bad("an EOL inside a horizontal mode")
            check_b1()
        elif mode >= 0:
            check_b1()
            row.setvalue(b1 - row.a0 + mode)
            b1 += ref[pb]
            pb += 1
        else:
            check_b1()
            if b1 < row.a0 - mode:
                raise _bad("a vertical mode left of a0")
            row.setvalue(b1 - row.a0 + mode)
            pb -= 1
            b1 -= ref[pb]
        if len(ref) - pb < 4:
            ref += [0] * 8
    return row.cleanup()


def _pack(rows: List[List[int]], width: int) -> np.ndarray:
    """Runs → packed rows, odd runs black (1 bits)."""
    out = np.zeros((len(rows), width), np.uint8)
    for y, runs in enumerate(rows):
        x = 0
        for i, r in enumerate(runs):
            if i & 1 and r:
                out[y, x : x + r] = 1
            x += r
    return np.packbits(out, axis=1)


def _sync(bits: _Bits) -> None:
    """SYNC_EOL: skip to 11 zero bits, then past zeros to a one, and past it."""
    while bits.peek(11) != 0:
        bits.pos += 1
        if bits.eof():
            raise _EndOfData
    while bits.peek(1) == 0:
        bits.pos += 1
        if bits.eof():
            raise _EndOfData
    bits.pos += 1


def decode_ccitt(data: bytes, width: int, height: int, compression: int, t4options: int = 0) -> bytes:
    """A strip or tile of ``height`` rows → packed rows (1 = black)."""
    bits = _Bits(data)
    rows: List[List[int]] = []
    ref = [width, 0]  # an all-white row above the first
    try:
        while len(rows) < height:
            if compression == 2:
                row = _row_1d(bits, width)
                bits.pos = -(-bits.pos // 8) * 8
            elif compression == 3:
                _sync(bits)
                one_d = True
                if t4options & 1:
                    one_d = bits.peek(1) == 1
                    bits.pos += 1
                row = _row_1d(bits, width) if one_d else _row_2d(bits, ref, width)
            else:
                row = _row_2d(bits, ref, width)
            rows.append(row)
            ref = row + [0]  # the imaginary change libtiff appends for the next row
    except _EndOfData:
        pass
    rows += [[width]] * (height - len(rows))
    return _pack(rows, width).tobytes()
