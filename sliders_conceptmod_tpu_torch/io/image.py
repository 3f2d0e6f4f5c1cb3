"""``load_rgb``: the port's ``PIL.Image.open(path).convert("RGB")`` (the GPU
machine has no PIL). The format comes from the file's signature, not its
name, as Pillow identifies it: PNG (``io/png.py``), JPEG (``io/jpeg.py``),
WebP (``io/webp.py`` over ``io/vp8.py`` and ``io/vp8l.py``), GIF
(``io/gif.py``), BMP (``io/bmp.py``) and TIFF (``io/tiff.py``). Any other
format is refused (ROADMAP.md queue 1, item 14)."""

from __future__ import annotations

import numpy as np

from sliders_conceptmod_tpu_torch.io.bmp import decode_bmp
from sliders_conceptmod_tpu_torch.io.gif import decode_gif
from sliders_conceptmod_tpu_torch.io.jpeg import ITEM, decode_jpeg
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.io.tiff import decode_tiff
from sliders_conceptmod_tpu_torch.io.webp import decode_webp

# (signature test, format) for the formats Pillow opens that the port refuses
_REFUSED = (
    (lambda d: d[:12] == b"\0\0\0\x0cjP  \r\n\x87\n" or d[:4] == b"\xff\x4f\xff\x51", "JPEG 2000"),
    (lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis"), "AVIF"),
    (lambda d: d[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P7", b"Pf", b"PF"), "PPM/PGM/PBM"),
    (lambda d: d[:4] == b"\0\0\1\0", "ICO"),
    (lambda d: d[:4] == b"8BPS", "PSD"),
)


def decode_rgb(data: bytes, name: str = "image") -> np.ndarray:
    """Image bytes → uint8 ``[H, W, 3]``: grey repeated, alpha dropped."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = decode_png(data)
        if img.ndim == 2:
            img = img[:, :, None]
        return np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] in (1, 2) else np.ascontiguousarray(img[:, :, :3])
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return decode_tiff(data)
    for test, fmt in _REFUSED:
        if test(data):
            raise ValueError(f"{name}: {fmt} is not supported ({ITEM}); save the image as PNG, JPEG or WebP")
    raise ValueError(f"{name}: not a PNG, JPEG, WebP, GIF, BMP or TIFF file (the port decodes those; {ITEM})")


def load_rgb(path: str) -> np.ndarray:
    """The file at ``path`` → uint8 ``[H, W, 3]``, as
    ``Image.open(path).convert("RGB")``; EXIF orientation is not applied."""
    with open(path, "rb") as f:
        return decode_rgb(f.read(), path)
