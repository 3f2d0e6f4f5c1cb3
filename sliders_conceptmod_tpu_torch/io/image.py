"""``load_rgb``: the port's ``PIL.Image.open(path).convert("RGB")`` (the GPU
machine has no PIL). The format comes from the file's signature, not its
name, as Pillow finds it: PNG through ``io/png.py``, JPEG through
``io/jpeg.py``. WebP is refused: lossy VP8 is a codec of its own (ROADMAP.md
queue 1, item 14), and so is any other format."""

from __future__ import annotations

import numpy as np

from sliders_conceptmod_tpu_torch.io.jpeg import ITEM, decode_jpeg
from sliders_conceptmod_tpu_torch.io.png import decode_png


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
        raise ValueError(f"{name}: WebP is not supported: lossy VP8 is a codec of its own ({ITEM}); "
                         "save the image as PNG or JPEG")
    raise ValueError(f"{name}: not a PNG or JPEG file (the port decodes those two; {ITEM})")


def load_rgb(path: str) -> np.ndarray:
    """The file at ``path`` → uint8 ``[H, W, 3]``, as
    ``Image.open(path).convert("RGB")``; EXIF orientation is not applied."""
    with open(path, "rb") as f:
        return decode_rgb(f.read(), path)
