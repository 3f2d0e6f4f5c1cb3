"""Netpbm decoding in numpy and plain Python, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``PpmImagePlugin`` (the GPU machine has no PIL).

* The magic: up to six characters before the first whitespace. ``P1``–``P6``
  (bitmap, grey and colour, plain text or binary), ``Pf`` (grey float,
  bottom-up, little-endian where its scale is negative) and Pillow's own
  ``P0CMYK``, ``PyCMYK``, ``PyRGBA`` and ``PyP``. Any other (``PF``, ``P7``)
  is not a Pillow PPM, and identification moves on.
* Header tokens end at whitespace; a ``#`` skips to the end of its line and
  the token goes on after it, as Pillow's ``_read_token`` reads it. One
  whitespace byte ends the last token before binary data.
* ``maxval``: 255 is read as is; 65535 on grey is 16-bit big-endian through
  mode ``I``; any other value scales each sample to
  ``round(v / maxval · 255)``, or on grey above 255 to
  ``round(v / maxval · 65535)`` in mode ``I``, which ``convert("RGB")``
  clips at 255 (Python's ``round``: halves to even).
* Plain formats as ``PpmPlainDecoder`` reads them: a ``#`` in the data
  removes up to its line end and glues what is on either side; bitmap
  digits need no whitespace between them (``0`` white, ``1`` black).
* Float samples → RGB: clipped to 0–255 and truncated (NaN → 0).
* ``PyP`` carries no palette: Pillow paints it black.
"""

from __future__ import annotations

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, cmyk2rgb, error

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
          b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_BLOCK = 1 << 20  # ImageFile.SAFEBLOCK: the plain decoder reads in blocks of this size


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read1(self) -> bytes:
        c = self.data[self.pos : self.pos + 1]
        self.pos += len(c)
        return c

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read1()
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise error("PPM", "the header ends early")
        if len(tok) > 10:
            raise error("PPM", f"a header token too long: {tok!r}")
        return tok


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_blocks(data: bytes):
    """``PpmPlainDecoder``'s blocks with its comments removed."""
    spans = False
    for at in range(0, len(data), _BLOCK):
        block = data[at : at + _BLOCK]
        if spans:
            end = _comment_end(block)
            if end == -1:
                continue
            block = block[end + 1 :]
        spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1 :]
            else:
                block, spans = block[:start], True
                break
        yield block


def _plain_bitmap(data: bytes, total: int) -> np.ndarray:
    out = b""
    for block in _plain_blocks(data):
        tokens = b"".join(block.split())
        if tokens.strip(b"01"):
            raise error("PPM", "a bitmap token other than 0 and 1")
        out = (out + tokens)[:total]
        if len(out) == total:
            break
    if len(out) < total:
        raise error("PPM", "not enough image data")
    return np.where(np.frombuffer(out, np.uint8) == ord("0"), 255, 0).astype(np.uint8)


def _plain_values(data: bytes, total: int, maxval: int, top: int) -> np.ndarray:
    out = []
    half = b""
    blocks = _plain_blocks(data)
    while len(out) < total:
        block = next(blocks, None)
        if block is None:
            if not half:
                break
            block = b" "
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise error("PPM", f"a data token too long: {half[:11]!r}")
        for tok in tokens:
            if len(tok) > 10:
                raise error("PPM", f"a data token too long: {tok[:11]!r}")
            v = int(tok)
            if v < 0 or v > maxval:
                raise error("PPM", f"a sample of {v} outside 0…{maxval}")
            out.append(round(v / maxval * top))
            if len(out) == total:
                break
    if len(out) < total:
        raise error("PPM", "not enough image data")
    return np.array(out, np.int64)


def decode_pnm(data: bytes) -> np.ndarray:
    """PBM/PGM/PPM (and Pillow's own variants) bytes → uint8 ``[H, W, 3]``."""
    r = _Reader(data)
    magic = b""
    for _ in range(6):
        c = r.read1()
        if not c or c in _WHITESPACE:
            break
        magic += c
    mode = _MODES.get(magic)
    if mode is None:
        raise NotThisFormat("not a PPM file")
    width, height = int(r.token()), int(r.token())
    if width <= 0 or height <= 0:
        raise NotThisFormat("PPM: an empty image")
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = 1
    if mode == "F":
        scale = float(r.token())
        if scale == 0.0 or not np.isfinite(scale):
            raise error("PPM", "scale must be finite and non-zero")
    elif mode != "1":
        maxval = int(r.token())
        if not 0 < maxval < 65536:
            raise error("PPM", "maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    body = data[r.pos :]
    bands = _BANDS[mode]
    total = width * height * bands
    if mode == "1":
        if plain:
            g = _plain_bitmap(body, width * height).reshape(height, width)
        else:
            stride = (width + 7) // 8
            if len(body) < stride * height:
                raise error("PPM", "the image data is truncated")
            bits = np.unpackbits(np.frombuffer(body[: stride * height], np.uint8).reshape(height, stride), axis=1)
            g = np.where(bits[:, :width] == 1, 0, 255).astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    if mode == "F":
        if len(body) < 4 * width * height:
            raise error("PPM", "the image data is truncated")
        v = np.frombuffer(body[: 4 * width * height], "<f4" if scale < 0 else ">f4").reshape(height, width)[::-1]
        with np.errstate(invalid="ignore"):
            g = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.where(v > 0, v, 0)), 0)).astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    top = 65535 if mode == "I" else 255
    if plain:
        s = _plain_values(body, total, maxval, top)
    elif maxval == 255 or (maxval == 65535 and mode == "I"):
        size = 2 if maxval == 65535 else 1
        if len(body) < total * size:
            raise error("PPM", "the image data is truncated")
        s = np.frombuffer(body[: total * size], ">u2" if size == 2 else np.uint8).astype(np.int64)
    else:
        size = 1 if maxval < 256 else 2
        n = min(len(body) // (size * bands), width * height) * bands
        if n < total:
            raise error("PPM", "not enough image data")
        v = np.frombuffer(body[: n * size], ">u2" if size == 2 else np.uint8).astype(np.float64)
        s = np.minimum(top, np.rint(v / maxval * top)).astype(np.int64)
    s = s.reshape(height, width, bands)
    if mode in ("L", "I"):
        return np.repeat(np.minimum(s, 255).astype(np.uint8), 3, axis=2)
    if mode == "P":
        return np.zeros((height, width, 3), np.uint8)
    if mode == "CMYK":
        return cmyk2rgb(s)
    return s[:, :, :3].astype(np.uint8)
