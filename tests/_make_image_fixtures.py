"""Writes ``tests/data/image_decode/``: small JPEG and PNG files of the kinds
the port decodes (``io/jpeg.py``, ``io/png.py``), the four folders of a JPEG
image-pair bank (``bank/{minus2,minus1,plus1,plus2}``, scales −2, −1, 1, 2),
and ``digests.json``: the SHA-256 of Pillow's ``convert("RGB")`` of each file
with its shape, which ``chip_smoke.py`` holds the port's decode to on a
machine without Pillow. Pillow writes what it can (baseline and progressive
JPEG at 4:4:4, 4:2:2 and 4:2:0, grey, restart markers, an Adobe RGB file);
``_jpeg_writer`` and ``_png_writer`` write the rest.

    python tests/_make_image_fixtures.py
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jpeg_writer import write_jpeg  # noqa: E402
from _png_writer import write_png  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "image_decode")
BANK_FOLDERS = ("minus2", "minus1", "plus1", "plus2")


def pattern(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth colour pattern with noise: edges for the IDCT, gradients for
    the chroma upsampling."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f = rng.uniform(1, 4, (2, 3))
    base = np.stack([np.sin(2 * np.pi * f[0, c] * xx + c) * np.cos(2 * np.pi * f[1, c] * yy) for c in range(3)], -1)
    return np.clip(base * 70 + 128 + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_jpeg(img: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def files() -> dict:
    rng = np.random.default_rng(7)
    out = {
        "baseline_420_q90.jpg": pil_jpeg(pattern(48, 64, 1), quality=90, subsampling=2),
        "baseline_444_q95.jpg": pil_jpeg(pattern(53, 37, 2), quality=95, subsampling=0),
        "baseline_422_q50.jpg": pil_jpeg(pattern(37, 53, 3), quality=50, subsampling=1),
        "progressive_420_optimize.jpg": pil_jpeg(pattern(64, 64, 4), quality=85, progressive=True, optimize=True),
        "restart_420.jpg": pil_jpeg(pattern(40, 48, 5), quality=80, restart_marker_blocks=2),
        "grey.jpg": pil_jpeg(pattern(29, 37, 6), "L", quality=90),
        "adobe_rgb.jpg": pil_jpeg(pattern(24, 40, 8), quality=90, keep_rgb=True),
        "sampling_440.jpg": write_jpeg(pattern(36, 40, 9), sampling=((1, 2), (1, 1), (1, 1))),
        "palette_4bit_trns.png": write_png(rng.integers(0, 16, (21, 19)), 4, 3,
                                           palette=rng.integers(0, 256, (12, 3)), trns=b"\x00\x80"),
        "grey_2bit.png": write_png(rng.integers(0, 4, (13, 17)), 2, 0),
        "grey_16bit.png": write_png(rng.integers(0, 512, (15, 11)), 16, 0),
        "rgb_16bit.png": write_png(rng.integers(0, 65536, (12, 14, 3)), 16, 2),
        "adam7_rgba.png": write_png(np.concatenate([pattern(23, 29, 10), rng.integers(0, 256, (23, 29, 1))], -1),
                                    8, 6, interlace=True),
    }
    for i, folder in enumerate(BANK_FOLDERS):  # the same two images a brightness step apart per folder
        for j, kw in enumerate((dict(quality=90), dict(quality=90, progressive=True))):
            img = np.clip(pattern(96, 96, 20 + j).astype(int) + 30 * (i - 1.5), 0, 255).astype(np.uint8)
            out[f"bank/{folder}/{j:03d}.jpg"] = pil_jpeg(img, **kw)
    return out


def main() -> None:
    digests = {}
    for name, data in files().items():
        path = os.path.join(OUT, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        digests[name] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
