"""``load_rgb``: the port's ``PIL.Image.open(path).convert("RGB")`` (the GPU
machine has no PIL). The format comes from the file's bytes, not its name,
tried in the order of Pillow 12.1's ``Image.ID`` with each plugin's
``_accept`` test; where a format's header checks fail as Pillow's ``_open``
fails (``NotThisFormat``), the next format is tried, as
``Image._open_core`` does. The port decodes BMP and DIB (``io/bmp.py``),
BLP (``io/blp.py``), DDS (``io/dds.py``, its BC1–BC7 blocks by
``io/bcn.py``), FTEX (``io/ftex.py``), GIF (``io/gif.py``), ICNS
(``io/icns.py``), JPEG (``io/jpeg.py``), PBM/PGM/PPM (``io/pnm.py``), PCX
and DCX (``io/pcx.py``), PNG (``io/png.py``), ICO and CUR (``io/ico.py``),
JPEG 2000 (``io/jpeg2000.py``), SGI (``io/sgi.py``), TIFF (``io/tiff.py``,
its CCITT fax codes by ``io/ccitt.py`` and its ZSTD by ``io/zstd.py``), PSD
(``io/psd.py``), QOI (``io/qoi.py``), TGA (``io/tga.py``, tried last: it
has no signature) and WebP (``io/webp.py``). Every other format Pillow
reads is refused citing ROADMAP item 14; those Pillow cannot load here
either are refused saying so."""

from __future__ import annotations

import re
import struct

import numpy as np

from sliders_conceptmod_tpu_torch.io.blp import accept as accept_blp
from sliders_conceptmod_tpu_torch.io.blp import decode_blp
from sliders_conceptmod_tpu_torch.io.bmp import decode_bitmap, decode_bmp
from sliders_conceptmod_tpu_torch.io.dds import accept as accept_dds
from sliders_conceptmod_tpu_torch.io.dds import decode_dds
from sliders_conceptmod_tpu_torch.io.ftex import accept as accept_ftex
from sliders_conceptmod_tpu_torch.io.ftex import decode_ftex
from sliders_conceptmod_tpu_torch.io.gif import decode_gif
from sliders_conceptmod_tpu_torch.io.icns import accept as accept_icns
from sliders_conceptmod_tpu_torch.io.icns import decode_icns
from sliders_conceptmod_tpu_torch.io.ico import accept_cur, accept_ico, decode_cur, decode_ico
from sliders_conceptmod_tpu_torch.io._common import ITEM, NotThisFormat
from sliders_conceptmod_tpu_torch.io.jpeg import decode_jpeg
from sliders_conceptmod_tpu_torch.io.jpeg2000 import accept as accept_jpeg2000
from sliders_conceptmod_tpu_torch.io.jpeg2000 import decode_jpeg2000
from sliders_conceptmod_tpu_torch.io.pcx import accept_dcx, accept_pcx, decode_dcx, decode_pcx
from sliders_conceptmod_tpu_torch.io.png import png_rgb
from sliders_conceptmod_tpu_torch.io.pnm import accept as accept_pnm
from sliders_conceptmod_tpu_torch.io.pnm import decode_pnm
from sliders_conceptmod_tpu_torch.io.psd import accept as accept_psd
from sliders_conceptmod_tpu_torch.io.psd import decode_psd
from sliders_conceptmod_tpu_torch.io.qoi import accept as accept_qoi
from sliders_conceptmod_tpu_torch.io.qoi import decode_qoi
from sliders_conceptmod_tpu_torch.io.sgi import accept as accept_sgi
from sliders_conceptmod_tpu_torch.io.sgi import decode_sgi
from sliders_conceptmod_tpu_torch.io.tga import decode_tga
from sliders_conceptmod_tpu_torch.io.tiff import accept as accept_tiff
from sliders_conceptmod_tpu_torch.io.tiff import decode_tiff
from sliders_conceptmod_tpu_torch.io.webp import decode_webp

_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_NOT_HERE = "Pillow cannot load it here either"


def _u32(d: bytes, at: int = 0, bo: str = "<") -> int:
    return struct.unpack_from(bo + "I", d, at)[0] if len(d) >= at + 4 else -1


def _mpeg(d: bytes) -> bool:
    """MPEG's ``_accept`` and the non-zero size its ``_open`` needs."""
    return len(d) >= 7 and d[:4] == b"\0\0\1\xb3" and (d[4] << 4 | d[5] >> 4) > 0 and ((d[5] & 15) << 8 | d[6]) > 0


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt(d: bytes) -> bool:
    """IM Tools has no ``_accept``: its ``_open`` reads ``key value`` lines
    (a newline within the first 100 bytes) and identifies the file when they
    give a width, a height and ``pixel n8``; a number that does not parse
    fails the open (so the file is taken for IMT and refused)."""
    buffer, pos = d[:100], 100
    if b"\n" not in buffer:
        return False
    size, grey = [0, 0], False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = d[pos : pos + 1], pos + 1
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer, pos = buffer + d[pos : pos + 100], pos + 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k in (b"width", b"height"):
            try:
                size[k == b"height"] = int(v)
            except ValueError:
                return True
        elif k == b"pixel" and v == b"n8":
            grey = True
    return grey and size[0] > 0 and size[1] > 0


def _spider(d: bytes) -> bool:
    """SPIDER has no ``_accept``: its ``_open`` takes 27 floats (big-endian,
    else little-endian) for a header whose integer fields agree, of a 2D
    image (``iform`` 1) with consistent stack fields."""
    if len(d) < 108:
        return False

    def whole(f):
        return f == f and abs(f) != float("inf") and f == int(f)

    for order in ">", "<":
        h = (99,) + struct.unpack(order + "27f", d[:108])
        if not all(whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        if int(h[5]) not in (1, 3, -11, -12, -21, -22) or int(h[22]) != int(h[13]) * int(h[23]):
            continue
        if int(h[22]) == 0:
            continue
        if int(h[5]) != 1:
            return False
        try:
            stack, number = int(h[24]), int(h[27])
        except (ValueError, OverflowError):
            return True  # the open fails on them: refused
        return (stack >= 0 and number == 0) or (stack == 0 and number > 0)
    return False


def _gbr(d: bytes) -> bool:
    """GBR's ``_accept`` and the header checks of its ``_open``."""
    if len(d) < 20 or _u32(d, 0, ">") < 20 or _u32(d, 4, ">") not in (1, 2):
        return False
    w, h, depth = (_u32(d, k, ">") for k in (8, 12, 16))
    return w > 0 and h > 0 and depth in (1, 4) and (_u32(d, 4, ">") == 1 or d[20:24] == b"GIMP")


# Pillow 12.1's Image.ID: first the formats ``Image.preinit`` registers, then
# the rest in the order ``Image.init`` registers them. A format is
# (name, accept, decoder); a decoder of None is refused citing ROADMAP item
# 14, a string is the reason Pillow cannot load it here either.
_FORMATS = (
    ("BMP", lambda d: d[:2] == b"BM", decode_bmp),
    ("DIB", lambda d: _u32(d) in _DIB_HEADERS, lambda d: decode_bitmap(d, 0)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", decode_jpeg),
    ("PPM", accept_pnm, decode_pnm),
    ("PNG", lambda d: d[:8] == b"\x89PNG\r\n\x1a\n", png_rgb),
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), None),
    ("BLP", accept_blp, decode_blp),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), "Pillow has only a stub for it"),
    ("CUR", accept_cur, decode_cur),
    ("PCX", accept_pcx, decode_pcx),
    ("DCX", accept_dcx, decode_dcx),
    ("DDS", accept_dds, decode_dds),
    ("EPS", lambda d: d[:4] == b"%!PS" or _u32(d) == 0xC6D3D0C5, "Pillow needs Ghostscript for it"),
    ("FITS", lambda d: d[:6] == b"SIMPLE", None),
    ("FLI", lambda d: len(d) >= 16 and struct.unpack_from("<H", d, 4)[0] in (0xAF11, 0xAF12)
     and struct.unpack_from("<H", d, 14)[0] in (0, 3), None),
    ("FTEX", accept_ftex, decode_ftex),
    ("GBR", _gbr, None),
    ("GRIB", lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1, "Pillow has only a stub for it"),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", "Pillow has only a stub for it"),
    ("JPEG2000", accept_jpeg2000, decode_jpeg2000),
    ("ICNS", accept_icns, decode_icns),
    ("ICO", accept_ico, decode_ico),
    ("IM", lambda d: d[:11] == b"Image type:", None),
    ("IMT", _imt, None),
    ("IPTC", lambda d: d[:2] == b"\x1c\x02", None),
    ("MCIDAS", lambda d: d[:8] == b"\0\0\0\0\0\0\0\x04", None),
    ("MPEG", _mpeg, "Pillow reads only its size"),
    ("TIFF", accept_tiff, decode_tiff),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS"), None),
    ("PCD", lambda d: d[2048:2055] == b"PCD_IPI", None),
    ("PIXAR", lambda d: d[:4] == b"\200\350\0\0", None),
    ("PSD", accept_psd, decode_psd),
    ("QOI", accept_qoi, decode_qoi),
    ("SGI", accept_sgi, decode_sgi),
    ("SPIDER", _spider, None),
    ("SUN", lambda d: _u32(d, 0, ">") == 0x59A66A95, None),
    ("TGA", lambda d: True, decode_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP" and d[12:16] in (b"VP8 ", b"VP8X", b"VP8L"),
     decode_webp),
    ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\0\0" or d[:4] == b"\1\0\0\0", "Pillow has no WMF loader here"),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define"), None),
    ("XPM", lambda d: d[:9] == b"/* XPM */", None),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332", None),
)


def decode_rgb(data: bytes, name: str = "image") -> np.ndarray:
    """Image bytes → uint8 ``[H, W, 3]``: grey repeated, alpha dropped."""
    for fmt, accept, decoder in _FORMATS:
        if not accept(data):
            continue
        if decoder is None:
            raise ValueError(f"{name}: {fmt} is not supported ({ITEM}); save the image as PNG, JPEG or WebP")
        if isinstance(decoder, str):
            raise ValueError(f"{name}: {fmt} is not supported ({decoder}: {_NOT_HERE}; {ITEM})")
        try:
            return decoder(data)
        except NotThisFormat:
            continue
    raise ValueError(f"{name}: not an image format the port identifies ({ITEM} lists the formats Pillow reads "
                     "that the port refuses)")


def load_rgb(path: str) -> np.ndarray:
    """The file at ``path`` → uint8 ``[H, W, 3]``, as
    ``Image.open(path).convert("RGB")``; EXIF orientation is not applied."""
    with open(path, "rb") as f:
        return decode_rgb(f.read(), path)
