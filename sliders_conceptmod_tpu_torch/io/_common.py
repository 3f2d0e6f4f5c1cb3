"""What the image readers share: the ROADMAP item that lists the formats
the port refuses, the exception that sends identification on to the next
format, the two error messages every reader raises, and Pillow's CMYK → RGB
conversion."""

from __future__ import annotations

import numpy as np

ITEM = "ROADMAP.md queue 1, item 14"


class NotThisFormat(ValueError):
    """A file fails a format's header checks where Pillow's ``_open`` raises
    ``SyntaxError`` (or an error it turns into one): ``io/image.py`` goes on
    to the next format, as ``Image._open_core`` does."""


def error(fmt: str, what: str) -> ValueError:
    """A file of ``fmt`` the port cannot decode: ``what`` says why."""
    return ValueError(f"{fmt}: {what}")


def refuse(fmt: str, what: str) -> ValueError:
    """A kind of ``fmt`` that Pillow reads and the port does not yet."""
    return ValueError(f"{fmt}: {what} is not supported ({ITEM})")


def cmyk2rgb(cmyk: np.ndarray) -> np.ndarray:
    """``Convert.c::cmyk2rgb``: ``nk − MULDIV255(c, nk)`` with ``nk = 255 − k``."""
    cmyk = cmyk.astype(np.int64)
    nk = 255 - cmyk[..., 3:4]
    t = cmyk[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
