"""The port's WebP decoding (``io/vp8.py``, ``io/vp8l.py``, ``io/webp.py``)
against Pillow's ``Image.open(p).convert("RGB")`` (libwebp 1.6 through
``WebPAnimDecoder``), bit for bit.

Lossy files come from Pillow at qualities 1–100 and methods 0–6 on sizes
that are not multiples of 16, with alpha, and as animations; the simple
loop filter, 2–8 token partitions, the filter strength and sharpness and
the segment count come from libwebp's own encoder (``_webp_encoder``, the
library Pillow bundles), as Pillow's ``save`` does not expose them.
Lossless files sweep quality and method (which switch the transforms and
the colour cache on and off), palettes of 2, 4, 16 and 256 colours and
``exact=True``."""

import io
import itertools
import struct
import time

import numpy as np
import pytest
from PIL import Image

from _webp_encoder import encode_lossy
from sliders_conceptmod_tpu_torch.io import vp8, vp8l
from sliders_conceptmod_tpu_torch.io.image import decode_rgb
from sliders_conceptmod_tpu_torch.io.webp import decode_webp


def _pattern(h, w, seed, noise=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx * 7 + yy * 3) % 256], -1)
    return np.clip(base + rng.integers(-noise, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)


def _webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _assert_like_pil(data: bytes) -> None:
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = decode_webp(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _chunk(tag, payload):
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def _u24(v):
    return struct.pack("<I", v)[:3]


# ---------------------------------------------------------------------------
# lossy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first", range(1, 101, 10), ids=lambda q: f"q{q}-{q + 9}")
def test_lossy_qualities(first):
    """Every quality 1–100, each at a method and an odd size of its own."""
    for q in range(first, first + 10):
        h, w = 5 + (q * 7) % 43, 3 + (q * 11) % 41
        img = _pattern(h, w, q, noise=10 + q % 50)
        _assert_like_pil(_webp(img, quality=q, method=q % 7))


@pytest.mark.parametrize("method", range(7))
def test_lossy_methods_and_sizes(method):
    for (h, w), q in itertools.product([(1, 1), (16, 16), (17, 33), (40, 7), (3, 50)], [5, 60, 95]):
        _assert_like_pil(_webp(_pattern(h, w, h * w + q), quality=q, method=method))


@pytest.mark.parametrize("simple,partitions", list(itertools.product([False, True], range(4))))
def test_loop_filters_and_partitions(simple, partitions):
    """The simple and normal filters and 1–8 token partitions, from libwebp's
    encoder; the stream's header says which it carries."""
    for q, (h, w) in [(20, (48, 64)), (70, (33, 47)), (95, (19, 80))]:
        data = encode_lossy(_pattern(h, w, q + partitions), q, simple_filter=simple, partitions=partitions)
        _assert_like_pil(data)
    frame = data[20:]
    hdr = vp8._parse_header(vp8.BoolDecoder(frame[10 : 10 + ((frame[0] | frame[1] << 8 | frame[2] << 16) >> 5)]))
    assert (hdr.simple, hdr.num_parts) == (int(simple), 1 << partitions)


@pytest.mark.parametrize("sharpness", range(8))
def test_filter_sharpness_strength_and_segments(sharpness):
    img = _pattern(37, 45, sharpness, noise=60)
    for strength, segments in [(0, 1), (30, 2), (100, 4)]:
        for simple in (False, True):
            _assert_like_pil(encode_lossy(img, 40, simple_filter=simple, filter_strength=strength,
                                          sharpness=sharpness, segments=segments))


def test_lossy_with_alpha():
    """VP8X + ALPH + VP8: the alpha chunk is skipped, the RGB is libwebp's."""
    rng = np.random.default_rng(1)
    for h, w in [(37, 29), (1, 5), (64, 64)]:
        rgba = np.concatenate([_pattern(h, w, h), rng.integers(0, 256, (h, w, 1)).astype(np.uint8)], -1)
        rgba[: h // 2, :, 3] = 0
        for kw in [dict(quality=80), dict(quality=30, alpha_quality=20), dict(quality=90, method=6)]:
            _assert_like_pil(_webp(rgba, **kw))


def test_metadata_chunks_skipped():
    """VP8X files with ICCP, EXIF and XMP chunks around the bitstream."""
    img = _pattern(20, 30, 6)
    for kw in [dict(icc_profile=b"icc" * 30, exif=b"Exif\0\0" + bytes(20), xmp=b"<x/>"),
               dict(lossless=True, icc_profile=b"abc", xmp=b"<xmp/>")]:
        data = _webp(img, **kw)
        assert data[12:16] == b"VP8X" and b"ICCP" in data and b"XMP " in data
        _assert_like_pil(data)


def test_animations_first_frame():
    """Pillow's animations (lossy and lossless), and hand-built ones whose
    first frame is smaller than the canvas and offset into it (black
    around it, as WebPAnimDecoder zero-fills its key frame)."""
    frames = [Image.fromarray(_pattern(37, 29, s)) for s in range(3)]
    for kw in [dict(duration=40), dict(lossless=True), dict(quality=20, minimize_size=True)]:
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], **kw)
        _assert_like_pil(buf.getvalue())
    for lossless, (x, y) in itertools.product([False, True], [(0, 0), (3, 5), (8, 0)]):
        bitstream = _webp(_pattern(13, 11, 9), lossless=lossless)[12:]
        anmf = _u24(x) + _u24(y) + _u24(10) + _u24(12) + _u24(100) + b"\0" + bitstream
        body = (_chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + _u24(2 * x + 20) + _u24(2 * y + 15))
                + _chunk(b"ANIM", b"\xff\x80\x40\xff\0\0") + _chunk(b"ANMF", anmf))
        data = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
        _assert_like_pil(data)
        assert decode_webp(data)[0, -1].tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", range(7))
def test_lossless_quality_and_method(method):
    """Quality and method choose the transforms (predictor, cross-colour,
    subtract-green, palette) and the colour cache."""
    for q, (h, w) in [(0, (23, 31)), (25, (64, 5)), (50, (1, 1)), (75, (40, 33)), (100, (17, 60))]:
        _assert_like_pil(_webp(_pattern(h, w, q + method, noise=q // 3), lossless=True, quality=q, method=method))


@pytest.mark.parametrize("colours", [2, 3, 4, 16, 17, 256])
def test_lossless_palettes(colours):
    """Palettes of up to 16 colours bundle 8, 4 or 2 indices a pixel."""
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    for h, w in [(23, 31), (1, 17), (9, 1)]:
        img = palette[rng.integers(0, colours, (h, w))]
        for q in (0, 100):
            _assert_like_pil(_webp(img, lossless=True, quality=q))


def test_lossless_alpha_and_exact():
    rng = np.random.default_rng(2)
    rgba = np.concatenate([_pattern(29, 41, 5), rng.integers(0, 256, (29, 41, 1)).astype(np.uint8)], -1)
    rgba[5:15, :, 3] = 0
    for exact in (False, True):
        _assert_like_pil(_webp(rgba, lossless=True, exact=exact))
    smooth = np.repeat(np.repeat(_pattern(8, 8, 3), 6, 0), 6, 1)  # long runs: backward references
    _assert_like_pil(_webp(smooth, lossless=True, quality=100, method=6))


def test_lossless_meta_prefix_codes(monkeypatch):
    """Halves of different statistics make the encoder pick a prefix-code
    group per tile (the entropy image)."""
    used = []
    decode_pixels = vp8l._decode_pixels

    def spy(br, width, height, groups, meta, *rest):
        used.append(meta is not None and len(groups) > 1)
        return decode_pixels(br, width, height, groups, meta, *rest)

    monkeypatch.setattr(vp8l, "_decode_pixels", spy)
    rng = np.random.default_rng(0)
    for size, method in [(64, 4), (96, 6)]:
        img = np.zeros((size, size, 3), np.uint8)
        img[:, : size // 2] = rng.integers(0, 4, (size, size // 2, 3)) * 80
        img[:, size // 2 :] = rng.integers(100, 256, (size, size - size // 2, 3))
        used.clear()
        _assert_like_pil(_webp(img, lossless=True, quality=90, method=method))
        assert any(used)


# ---------------------------------------------------------------------------
# time, dispatch and refusals
# ---------------------------------------------------------------------------


def test_512px_decode_times():
    """512x512 lossy (quality 90) and lossless images decode bit-equal; their
    decode seconds on this host's CPU are printed (``pytest -s``)."""
    img = _pattern(512, 512, 9)
    for kind, data in [("lossy q90", _webp(img, quality=90)), ("lossless", _webp(img, lossless=True))]:
        t0 = time.perf_counter()
        got = decode_rgb(data)
        print(f"decode WebP {kind} 512x512 ({len(data)} bytes): {time.perf_counter() - t0:.3f} s")
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_yuv_planes_and_refusals():
    data = _webp(_pattern(20, 30, 4), quality=50)
    y, u, v = vp8.decode_vp8_yuv(data[20:])
    assert y.shape == (20, 30) and u.shape == v.shape == (10, 15)
    inter = bytearray(data)
    inter[20] |= 1  # the frame tag's key-frame bit: an inter frame
    with pytest.raises(ValueError, match="not a key frame"):
        decode_webp(bytes(inter))
    with pytest.raises(ValueError, match="WebP"):
        decode_webp(data[:12] + _chunk(b"ABCD", b"1234"))
    with pytest.raises(ValueError, match="truncated"):
        decode_webp(data[:40])
