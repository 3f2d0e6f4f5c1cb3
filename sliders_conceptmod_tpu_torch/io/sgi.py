"""SGI image decoding, as ``PIL.Image.open(p).convert("RGB")`` gives it with
Pillow 12's ``SgiImagePlugin`` and its C run-length decoder
``SgiRleDecode.c`` (the GPU machine has no PIL).

* Modes by (bytes a channel, dimension, channels): grey (1 or 2
  dimensions), RGB and RGBA (3 dimensions); 8 and 16 bits, a 16-bit sample
  taken by its high byte. Any other layout is refused as Pillow refuses it.
* Uncompressed: each channel a plane of rows from the bottom up.
* Run-length: the tables of row offsets and lengths (channel-major), each
  row expanded as the decoder expands it: a count byte (word) with its high
  bit set copies that many samples, else repeats the next sample; a zero
  count ends the row. The decoder's readings are kept: a row is read for at
  most its length's number of counts, a last count that is not zero ends
  the image there (the rows above stay black), a row shorter than the
  image keeps the previous row's samples beyond its end, and a run past the
  row, the file or a table entry past the file is refused as Pillow
  refuses it.
"""

from __future__ import annotations

import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io._common import NotThisFormat, error

_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1, (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4,
          (2, 3, 4): 4}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and struct.unpack_from(">H", prefix)[0] == 474


def _truncated() -> ValueError:
    return error("SGI", "the image data is truncated (Pillow refuses it too)")


def _expand_row(buf: bytearray, channel: int, bands: int, bpc: int, data: bytes, src: int, n: int, xsize: int,
                end: int) -> int:
    """``expandrow``/``expandrow2`` into ``buf`` (samples of ``bpc`` bytes,
    ``bands`` interleaved): 0 when the row ended, 1 when the image ends
    here; raises where the decoder reports an overrun. ``end`` is the index
    of the file's last byte."""
    x = 0
    dest = channel * bpc
    step = bands * bpc
    for left in range(n, 0, -1):
        if src + bpc - 1 > end:
            raise _truncated()
        pixel = data[src + bpc - 1]
        src += bpc
        if left == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            raise error("SGI", "a run past the end of its row (Pillow refuses it too)")
        x += count
        if pixel & 0x80:
            if src + bpc * count > end:
                raise _truncated()
            for _ in range(count):
                buf[dest : dest + bpc] = data[src : src + bpc]
                src += bpc
                dest += step
        else:
            if src + bpc - 1 > end or (bpc == 2 and src + 2 > end):
                raise _truncated()
            value = data[src : src + bpc]
            src += bpc
            for _ in range(count):
                buf[dest : dest + bpc] = value
                dest += step
    return 0


def decode_sgi(data: bytes) -> np.ndarray:
    """SGI bytes → uint8 ``[H, W, 3]``."""
    if not accept(data):
        raise NotThisFormat("not an SGI file")
    try:
        compression, bpc = data[2], data[3]
        dimension, xsize, ysize, zsize = struct.unpack_from(">4H", data, 4)
    except (IndexError, struct.error):
        raise NotThisFormat("SGI: the header is truncated") from None
    bands = _MODES.get((bpc, dimension, zsize))
    if bands is None:
        raise error("SGI", f"{bpc} bytes a sample, dimension {dimension}, {zsize} channels (Pillow refuses it too)")
    if compression == 0:
        page = xsize * ysize * bpc
        if len(data) < 512 + bands * page:
            raise _truncated()
        planes = np.frombuffer(data, np.uint8, bands * page, 512).reshape(bands, ysize, xsize, bpc)[..., 0]
        img = planes.transpose(1, 2, 0)[::-1]
    elif compression == 1:
        img = _rle_image(data, bpc, bands, xsize, ysize)
    else:
        raise error("SGI", f"compression {compression} (Pillow reads no data for it)")
    rgb = np.repeat(img[:, :, :1], 3, axis=2) if bands == 1 else img[:, :, :3]
    return np.ascontiguousarray(rgb)


def _rle_image(data: bytes, bpc: int, bands: int, xsize: int, ysize: int) -> np.ndarray:
    tablen = bands * ysize
    bufsize = len(data) - 512
    if bufsize < 8 * tablen:
        raise _truncated()
    starts = struct.unpack_from(f">{tablen}I", data, 512)
    lengths = struct.unpack_from(f">{tablen}I", data, 512 + 4 * tablen)
    img = np.zeros((ysize, xsize, bands), np.uint8)
    buf = bytearray(xsize * bands * 2)
    end = len(data) - 1
    for row in range(ysize):
        for channel in range(bands):
            start, length = starts[row + channel * ysize], lengths[row + channel * ysize]
            if start < 512 or start - 512 + length > bufsize:
                raise _truncated()
            if _expand_row(buf, channel, bands, bpc, data, start, length, xsize, end):
                return img[::-1]
        px = np.frombuffer(bytes(buf[: xsize * bands * bpc]), np.uint8).reshape(xsize, bands, bpc)
        img[row] = px[:, :, 0]
    return img[::-1]
