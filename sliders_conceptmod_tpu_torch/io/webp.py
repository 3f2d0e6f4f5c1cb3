"""WebP files: the RIFF container around a lossy (``io/vp8.py``) or
lossless (``io/vp8l.py``) bitstream, decoded to the RGB that
``PIL.Image.open(p).convert("RGB")`` gives (Pillow opens every WebP through
libwebp's ``WebPAnimDecoder`` in ``MODE_RGBA`` and drops the alpha).

* Simple files: one ``VP8 `` or ``VP8L`` chunk.
* Extended files (``VP8X``): ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks
  are skipped; an ``ALPH`` chunk is skipped too, as the RGB of a
  non-premultiplied RGBA decode does not depend on it.
* Animations (``ANIM``/``ANMF``): the first frame only, decoded into a
  canvas of the declared size that is zeroed first, at the frame's offset,
  as ``anim_decode.c`` does for its key frame; pixels outside the frame are
  black.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import ITEM, error
from sliders_conceptmod_tpu_torch.io.vp8 import decode_vp8
from sliders_conceptmod_tpu_torch.io.vp8l import argb_to_rgb, decode_vp8l


def _chunks(data: bytes, start: int, end: int) -> List[Tuple[bytes, bytes]]:
    """The (fourcc, payload) chunks in ``data[start:end]`` (payloads padded
    to even sizes)."""
    out = []
    pos = start
    while pos + 8 <= end:
        tag = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        if pos + 8 + size > end:
            raise error("WebP", f"the {tag!r} chunk is truncated")
        out.append((tag, data[pos + 8 : pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _decode_frame(chunks: List[Tuple[bytes, bytes]]) -> np.ndarray:
    """The RGB of the first ``VP8 ``/``VP8L`` bitstream among ``chunks``."""
    for tag, payload in chunks:
        if tag == b"VP8 ":
            return decode_vp8(payload)
        if tag == b"VP8L":
            return argb_to_rgb(decode_vp8l(payload))
    raise error("WebP", "no VP8 or VP8L bitstream")


def _u24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes → uint8 ``[H, W, 3]``."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise error("WebP", "not a RIFF WebP file")
    (riff_size,) = struct.unpack("<I", data[4:8])
    end = min(len(data), 8 + riff_size)
    chunks = _chunks(data, 12, end)
    if not chunks:
        raise error("WebP", "no chunk")
    first, payload = chunks[0]
    if first in (b"VP8 ", b"VP8L"):
        return _decode_frame(chunks[:1])
    if first != b"VP8X":
        raise error("WebP", f"a file that starts with a {first!r} chunk ({ITEM})")
    if len(payload) < 10:
        raise error("WebP", "the VP8X chunk is truncated")
    flags = payload[0]
    canvas_w, canvas_h = _u24(payload[4:7]) + 1, _u24(payload[7:10]) + 1
    if not flags & 0x02:  # a still image: its bitstream fills the canvas
        img = _decode_frame(chunks[1:])
        if img.shape[:2] != (canvas_h, canvas_w):
            raise error("WebP", f"an image of {img.shape[1]}x{img.shape[0]} on a canvas of {canvas_w}x{canvas_h}")
        return img
    anmf = next((p for t, p in chunks if t == b"ANMF"), None)
    if anmf is None:
        raise error("WebP", "an animation without frames")
    if len(anmf) < 16:
        raise error("WebP", "the ANMF chunk is truncated")
    x0, y0 = 2 * _u24(anmf[0:3]), 2 * _u24(anmf[3:6])
    fw, fh = _u24(anmf[6:9]) + 1, _u24(anmf[9:12]) + 1
    if x0 + fw > canvas_w or y0 + fh > canvas_h:
        raise error("WebP", "the first frame lies outside the canvas")
    img = _decode_frame(_chunks(anmf, 16, len(anmf)))
    if img.shape[:2] != (fh, fw):
        raise error("WebP", "the first frame's bitstream and its ANMF header disagree on its size")
    canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    canvas[y0 : y0 + fh, x0 : x0 + fw] = img
    return canvas
