"""GIF decoding (the first frame) in numpy and plain Python, as
``PIL.Image.open(p).convert("RGB")`` gives it with Pillow 12's
``GifImagePlugin`` (the GPU machine has no PIL).

* The logical screen, grown to hold the first frame where the frame
  reaches past it. Pixels outside the frame keep the image's first fill:
  the frame's transparent index where a graphic control extension before it
  sets one, index 0 otherwise.
* The palette: the frame's local one, else the global one. A palette that
  is the identity grey ramp (entry ``i`` = ``(i, i, i)``) is dropped, as
  Pillow drops it: the indices are then grey levels. So is a missing one.
  Indices past the end of a palette read black.
* LZW with the variable code size of the GIF spec (from the minimum code
  size + 1 to 12 bits, a clear code and an end code), and interlaced
  frames (rows 0, 8, …; 4, 12, …; 2, 6, …; 1, 3, …).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import error


def _sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The concatenated data sub-blocks from ``pos`` and the position after
    their terminator."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos : pos + n])
        pos += n
    return b"".join(out), pos


def lzw_decode(data: bytes, min_size: int, count: int) -> List[int]:
    """GIF LZW (least significant bit first) → up to ``count`` indices."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out: List[int] = []
    prefix: List[int] = []
    suffix: List[int] = []
    first: List[int] = []  # each code's first index, for the KwKwK case

    def reset():
        prefix[:] = [-1] * (end + 1)
        suffix[:] = list(range(end + 1))
        first[:] = list(range(end + 1))

    reset()
    size = min_size + 1
    prev = -1
    a = np.frombuffer(bytes(data) + b"\0" * 4, np.uint8).astype(np.int64)
    win = (a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16)).tolist()  # 24 bits from each byte on
    bitpos, nbits = 0, len(data) * 8
    while bitpos + size <= nbits and len(out) < count:
        code = (win[bitpos >> 3] >> (bitpos & 7)) & ((1 << size) - 1)
        bitpos += size
        if code == clear:
            reset()
            size, prev = min_size + 1, -1
            continue
        if code == end:
            break
        n = len(prefix)
        if code > n or (prev == -1 and code == n):
            raise error("GIF", "a code past the table")
        if prev != -1 and n < 4096:
            prefix.append(prev)
            suffix.append(first[code] if code < n else first[prev])  # code == n: KwKwK
            first.append(first[prev])
            if len(prefix) == (1 << size) and size < 12:
                size += 1
        seq = []
        c = code
        while c >= 0:
            seq.append(suffix[c])
            c = prefix[c]
        out.extend(reversed(seq))
        prev = code
    return out[:count]


def _interlaced_rows(h: int) -> List[int]:
    return (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + list(range(1, h, 2)))


def _palette(raw: bytes) -> Optional[np.ndarray]:
    """A palette as Pillow keeps it: None where it is the grey ramp."""
    p = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if np.array_equal(p, np.repeat(np.arange(len(p), dtype=np.uint8)[:, None], 3, axis=1)):
        return None
    return p


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes → uint8 ``[H, W, 3]`` of the first frame."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise error("GIF", "not a GIF file")
    width, height = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        global_palette = _palette(data[pos : pos + n])
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise error("GIF", "no image in the file")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension
            label = data[pos]
            block, after = _sub_blocks(data, pos + 1)
            if label == 0xF9 and data[pos + 1] >= 4:  # graphic control: its first sub-block
                gce = data[pos + 2 : pos + 2 + data[pos + 1]]
                if gce[0] & 1:
                    transparency = gce[3]
            pos = after
            continue
        if kind != 0x2C:
            raise error("GIF", f"an unknown block 0x{kind:02x}")
        x0, y0, fw, fh = (int.from_bytes(data[pos + 2 * i : pos + 2 * i + 2], "little") for i in range(4))
        fflags = data[pos + 8]
        pos += 9
        palette = global_palette
        if fflags & 0x80:
            n = 3 << ((fflags & 7) + 1)
            palette = _palette(data[pos : pos + n])
            pos += n
        min_size = data[pos]
        lzw, _ = _sub_blocks(data, pos + 1)
        break
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    img = np.full((height, width), transparency if transparency is not None else 0, np.uint8)
    if fw and fh:
        idx = lzw_decode(lzw, min_size, fw * fh)
        frame = img[y0 : y0 + fh, x0 : x0 + fw]
        rows = _interlaced_rows(fh) if fflags & 0x40 else list(range(fh))
        flat = np.array(idx, np.uint8)
        for k, r in enumerate(rows):
            row = flat[k * fw : (k + 1) * fw]
            frame[r, : len(row)] = row
            if len(row) < fw:
                break
    if palette is None:
        return np.repeat(img[:, :, None], 3, axis=2)
    full = np.zeros((256, 3), np.uint8)
    full[: len(palette)] = palette
    return full[img]
