"""The port's decoding of the JPEG kinds and formats beyond baseline JPEG,
PNG and WebP (``io/jpeg.py``, ``io/gif.py``, ``io/bmp.py``,
``io/tiff.py``, ``io/image.py``) against Pillow's
``Image.open(p).convert("RGB")``, bit for bit, and the formats left out,
refused citing ROADMAP item 14.

Pillow decodes arithmetic-coded JPEGs but cannot write them:
``_jpeg_writer.write_jpeg_arithmetic`` writes them (sequential and
progressive, restarts, DAC conditioning, grey, three and four components),
as ``write_jpeg_lossless`` writes lossless (SOF3) ones. Pillow writes CMYK
JPEGs; the writer writes YCCK. ``_image_writers`` writes the GIF, BMP and
TIFF variants Pillow does not."""

import io
import itertools
import struct

import numpy as np
import pytest
from PIL import Image

from _image_writers import write_bmp, write_gif, write_tiff
from _jpeg_writer import write_jpeg, write_jpeg_arithmetic, write_jpeg_lossless
from sliders_conceptmod_tpu_torch.io.image import decode_rgb


def _pattern(h, w, seed, c=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx * 7 + yy * 3) % 256,
                     (xx * 3 + yy * 11) % 256][:c], -1)
    return np.clip(base + rng.integers(-60, 61, (h, w, c)), 0, 255).astype(np.uint8)


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_like_pil(data: bytes) -> None:
    want = _pil_rgb(data)
    got = decode_rgb(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _pil_save(img, fmt, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, fmt, **kw)
    return buf.getvalue()


SIZES = [(37, 53), (8, 8), (1, 1), (17, 3), (16, 33)]
SAMPLINGS = [((2, 2), (1, 1), (1, 1)), ((1, 1),) * 3, ((1, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))]

# ---------------------------------------------------------------------------
# JPEG: arithmetic coding, CMYK/YCCK, lossless
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("progressive,restart", list(itertools.product([False, True], [0, 1, 3])))
def test_arithmetic_jpeg(progressive, restart):
    """SOF9/SOF10: the QM decoder, the DC and AC statistics and restarts."""
    for (h, w), sampling in itertools.product(SIZES, SAMPLINGS):
        _assert_like_pil(write_jpeg_arithmetic(_pattern(h, w, h + w), sampling, progressive=progressive,
                                               restart=restart))


@pytest.mark.parametrize("conditioning", [
    dict(dc=[(0, 1), (2, 5)], ac=[5, 20]), dict(dc=[(1, 3), (0, 0)], ac=[1, 63]), dict(dc=[(5, 15)], ac=[40]),
], ids=["dac_a", "dac_b", "dac_c"])
def test_arithmetic_conditioning(conditioning):
    """A DAC marker's DC bounds (L, U) and AC threshold K."""
    for progressive in (False, True):
        _assert_like_pil(write_jpeg_arithmetic(_pattern(37, 53, 4), progressive=progressive,
                                               conditioning=conditioning, quality_scale=0.3))


def test_arithmetic_grey_and_four_components():
    for progressive, restart in itertools.product([False, True], [0, 2]):
        _assert_like_pil(write_jpeg_arithmetic(_pattern(29, 31, 5)[:, :, 0], progressive=progressive, restart=restart))
        _assert_like_pil(write_jpeg_arithmetic(_pattern(29, 31, 6, 4), ((2, 2), (1, 1), (1, 1), (2, 2)),
                                               progressive=progressive, restart=restart, adobe_transform=2,
                                               jfif=False))


@pytest.mark.parametrize("quality", [30, 75, 95])
def test_pillow_cmyk_jpeg(quality):
    """Pillow's CMYK files: Adobe-inverted samples, then Pillow's CMYK → RGB."""
    for h, w in [(37, 53), (1, 1), (16, 9)]:
        buf = io.BytesIO()
        Image.fromarray(_pattern(h, w, quality, 4), "CMYK").save(buf, "JPEG", quality=quality)
        _assert_like_pil(buf.getvalue())
        _assert_like_pil(_pil_save(_pattern(h, w, quality + 1), "JPEG", "CMYK", quality=quality, progressive=True))


@pytest.mark.parametrize("adobe", [None, 0, 1, 2], ids=["no_adobe", "cmyk", "unknown_transform", "ycck"])
def test_cmyk_and_ycck_jpeg(adobe):
    """No Adobe marker or transform 0: CMYK; transform 2 (and an unknown
    one): YCCK, converted as jdcolor.c's ycck_cmyk_convert."""
    for sampling in [((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2)), ((2, 1), (1, 1), (1, 1), (1, 1))]:
        for h, w in [(37, 53), (9, 17)]:
            _assert_like_pil(write_jpeg(_pattern(h, w, 7, 4), sampling, ycc=adobe not in (None, 0),
                                        adobe_transform=adobe, jfif=False, ids=(1, 2, 3, 4)))


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpeg(predictor):
    """SOF3 (libjpeg-turbo 3 decodes it): each predictor, point transforms
    0 and 2, grey, RGB and four components."""
    for pt in (0, 2):
        _assert_like_pil(write_jpeg_lossless(_pattern(13, 17, predictor), predictor, pt))
    _assert_like_pil(write_jpeg_lossless(_pattern(9, 11, 1)[:, :, 0], predictor))
    _assert_like_pil(write_jpeg_lossless(_pattern(9, 11, 2, 4), predictor))


def test_lossless_jpeg_in_ycbcr_refused_as_pillow_refuses():
    """A lossless file marked YCbCr (JFIF, or Adobe transform 1) asks for a
    colour conversion libjpeg-turbo does not do in lossless mode."""
    data = write_jpeg_lossless(_pattern(13, 17, 1), 1)
    app0 = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    adobe1 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64\x00\x00\x00\x00\x01"
    for marked in (data[:2] + app0 + data[2:], data[:2] + adobe1 + data[2:]):
        with pytest.raises(OSError):
            _pil_rgb(marked)
        with pytest.raises(ValueError, match="Pillow refuses them too"):
            decode_rgb(marked)


def test_arithmetic_lossless_refused_as_pillow_refuses():
    """SOF11 with a lossless scan header (predictor 1): libjpeg-turbo has no
    arithmetic-coded lossless decoder, while any bytes decode as an
    arithmetic-coded sequential scan (SOF9), so the refusal is the frame's."""
    buf = io.BytesIO()
    Image.fromarray(_pattern(16, 16, 3)[:, :, 0]).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc0")
    sos = data.index(b"\xff\xda")
    at = sos + 5 + 2 * data[sos + 4]
    data[at : at + 3] = b"\x01\x00\x00"  # Ss = predictor 1, Se = 0, Ah = Al = 0
    for marker, refused in ((0xCB, True), (0xC9, False)):
        data[sof + 1] = marker
        if refused:
            with pytest.raises(OSError):
                _pil_rgb(bytes(data))
            with pytest.raises(ValueError, match="arithmetic-coded lossless JPEGs are not supported; Pillow"):
                decode_rgb(bytes(data))
        else:
            assert _pil_rgb(bytes(data)).shape == decode_rgb(bytes(data)).shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interlace,local", list(itertools.product([False, True], [False, True])))
def test_gif_frames(interlace, local):
    """Code sizes 2–8, palettes of 4 and 256 colours, the frame offset on a
    wider screen, a transparent index (the fill outside the frame)."""
    rng = np.random.default_rng(int(interlace) * 2 + int(local))
    for (h, w), min_size, offset, transparency, colours in itertools.product(
            [(13, 17), (1, 1), (40, 9)], [2, 8], [(0, 0), (3, 5)], [None, 1], [4, 256]):
        if colours > (1 << min_size):
            continue
        idx = rng.integers(0, colours, (h, w))
        idx[:, : w // 2] = idx[:, :1]
        palette = rng.integers(0, 256, (colours, 3))
        screen = (w + offset[0] + 2, h + offset[1]) if offset != (0, 0) else None
        _assert_like_pil(write_gif(idx, screen=screen, offset=offset, global_palette=None if local else palette,
                                   local_palette=palette if local else None, transparency=transparency,
                                   interlace=interlace, min_size=min_size))


def test_gif_palettes_and_screen():
    """Indices past a short palette (black), a grey-ramp palette and none
    (grey levels), a frame reaching past the screen (the screen grows), a
    large frame whose LZW table fills and clears, and Pillow's own files."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (9, 11))
    _assert_like_pil(write_gif(idx, global_palette=rng.integers(0, 256, (4, 3)), min_size=4))
    _assert_like_pil(write_gif(idx, global_palette=np.repeat(np.arange(16)[:, None], 3, 1), min_size=4))
    _assert_like_pil(write_gif(idx, min_size=4))
    _assert_like_pil(write_gif(idx, screen=(5, 5), offset=(2, 1), global_palette=rng.integers(0, 256, (16, 3)),
                               min_size=4))
    big = rng.integers(0, 256, (120, 150))
    big[::2] = 7
    _assert_like_pil(write_gif(big, global_palette=rng.integers(0, 256, (256, 3))))
    img = _pattern(37, 29, 1)
    for mode, kw in itertools.product(["RGB", "P", "L", "1"], [{}, {"interlace": True}]):
        _assert_like_pil(_pil_save(img, "GIF", mode, **kw))
    frames = [Image.fromarray(_pattern(20, 30, s)) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], transparency=0)
    _assert_like_pil(buf.getvalue())


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", [12, 40, 52, 56, 64, 108, 124])
def test_bmp_headers_and_depths(header):
    rng = np.random.default_rng(header)
    for bits in (1, 4, 8):
        palette = rng.integers(0, 256, (1 << bits, 3))
        idx = rng.integers(0, 1 << bits, (7, 13))
        _assert_like_pil(write_bmp(idx, bits, header, palette=palette))
        if header != 12:
            _assert_like_pil(write_bmp(idx, bits, header, palette=palette, top_down=True))
    if header == 12:
        return
    _assert_like_pil(write_bmp(rng.integers(0, 256, (7, 13, 3)), 24, header))
    _assert_like_pil(write_bmp(rng.integers(0, 65536, (7, 13)), 16, header, top_down=True))
    _assert_like_pil(write_bmp(rng.integers(0, 2**32, (7, 13)), 32, header))


@pytest.mark.parametrize("header", [40, 56, 124])
def test_bmp_bitfields(header):
    rng = np.random.default_rng(header)
    layouts = [(16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)), (32, (0xFF0000, 0xFF00, 0xFF, 0)),
               (24, (0xFF0000, 0xFF00, 0xFF))]
    if header >= 56:
        layouts += [(32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
                    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000))]
    for bits, masks in layouts:
        px = rng.integers(0, 256, (7, 13, 3)) if bits == 24 else rng.integers(0, 2**bits, (7, 13))
        _assert_like_pil(write_bmp(px, bits, header, compression=3, masks=masks))


@pytest.mark.parametrize("compression,bits", [(1, 8), (2, 4)], ids=["rle8", "rle4"])
def test_bmp_rle(compression, bits):
    """Encoded and absolute runs, ends of line and of bitmap, and a delta
    escape read as Pillow reads it."""
    rng = np.random.default_rng(bits)
    for (h, w), delta, header in itertools.product([(9, 23), (4, 3), (1, 40)], [False, True], [40, 124]):
        idx = rng.integers(0, 1 << bits, (h, w))
        idx[:, w // 4 : w // 2] = 3
        _assert_like_pil(write_bmp(idx, bits, header, palette=rng.integers(0, 256, (1 << bits, 3)),
                                   compression=compression, rle_delta=delta))


def test_bmp_palettes_and_pillow_files():
    """A palette shorter than the indices (black past it), grey ramps (Pillow
    drops the palette), and Pillow's own BMPs."""
    rng = np.random.default_rng(5)
    _assert_like_pil(write_bmp(rng.integers(0, 8, (7, 13)), 4, 40, palette=rng.integers(0, 256, (5, 3)), colors=5))
    _assert_like_pil(write_bmp(rng.integers(0, 256, (7, 13)), 8, 40, palette=np.repeat(np.arange(256)[:, None], 3, 1)))
    _assert_like_pil(write_bmp(rng.integers(0, 2, (7, 13)), 1, 40, palette=np.array([[0, 0, 0], [255, 255, 255]])))
    for mode in ("RGB", "P", "L", "1", "RGBA"):
        _assert_like_pil(_pil_save(_pattern(37, 29, 2), "BMP", mode))
    grey4 = write_bmp(rng.integers(0, 16, (7, 13)), 4, 40, palette=np.repeat(np.arange(16)[:, None], 3, 1))
    with pytest.raises(OSError):
        _pil_rgb(grey4)
    with pytest.raises(ValueError, match="Pillow refuses it too"):
        decode_rgb(grey4)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946], ids=["raw", "lzw", "deflate", "packbits", "adobe"])
def test_tiff_rgb(compression):
    """Both byte orders, strips of several rows and tiles, the predictor."""
    rng = np.random.default_rng(compression)
    layouts = [(None, None), (None, 3), ((16, 16), None)]  # (tile, rows per strip)
    for bo, predictor, (tile, rows) in itertools.product(["<", ">"], [1, 2], layouts):
        s = rng.integers(0, 256, (21, 37, 3))
        s[:, 10:20] = s[:, 10:11]
        _assert_like_pil(write_tiff(s, 8, 2, bo, compression, predictor, rows, tile))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_tiff_grey_and_palette(bits):
    """BlackIsZero, WhiteIsZero and palette samples of 1–8 bits, fill order
    2, LZW tiles."""
    rng = np.random.default_rng(bits)
    for photometric, fill, compression in itertools.product([0, 1, 3], [1, 2], [1, 5]):
        if fill == 2 and compression == 1 and ((photometric == 3 and bits < 8) or (photometric == 0 and bits == 8)):
            continue  # Pillow has no unpacker for these (test_tiff_refusals)
        s = rng.integers(0, 1 << bits, (11, 19, 1))
        cmap = rng.integers(0, 65536, (1 << bits, 3)) if photometric == 3 else None
        _assert_like_pil(write_tiff(s, bits, photometric, ">" if bits % 2 else "<", compression, fill_order=fill,
                                    colormap=cmap, tile=(16, 16) if compression == 5 else None))


def test_tiff_alpha_and_pillow_files():
    """Extra samples: none, unspecified, associated (divided out) and
    unassociated alpha; grey with alpha; and Pillow's own TIFFs."""
    rng = np.random.default_rng(4)
    for extra in [(), (0,), (1,), (2,)]:
        _assert_like_pil(write_tiff(rng.integers(0, 256, (11, 19, 4)), 8, 2, ">", 8, 2, extra_samples=extra))
    _assert_like_pil(write_tiff(rng.integers(0, 256, (11, 19, 2)), 8, 1, "<", 5, extra_samples=(2,)))
    _assert_like_pil(write_tiff(rng.integers(0, 4, (120, 200, 3)) * 60, 8, 2, "<", 5))  # the LZW table clears
    img = _pattern(37, 29, 1)
    for mode, compression in itertools.product(["RGB", "P", "L", "1", "RGBA", "LA"],
                                               ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"]):
        _assert_like_pil(_pil_save(img, "TIFF", mode, compression=compression))


def test_tiff_refusals():
    s = np.random.default_rng(6).integers(0, 2, (11, 19, 1))
    data = write_tiff(s, 1, 3, "<", 1, fill_order=2, colormap=np.zeros((2, 3), int))
    with pytest.raises(ValueError):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="Pillow"):
        decode_rgb(data)


# ---------------------------------------------------------------------------
# formats left out (ROADMAP item 14's remainder)
# ---------------------------------------------------------------------------


def _refused_files():
    img = _pattern(20, 24, 8)
    out = {
        "jpeg2000": _pil_save(img, "JPEG2000"),
        "avif": _pil_save(img, "AVIF"),
        "ppm": _pil_save(img, "PPM"),
        "pgm": _pil_save(img, "PPM", "L"),
        "ico": _pil_save(img, "ICO"),
        "tga": _pil_save(img, "TGA"),
        "psd": b"8BPS\0\1" + bytes(40),
        "jpeg_in_tiff": _pil_save(img, "TIFF", compression="jpeg"),
        "tiff_16bit": _pil_save(img[:, :, 0].astype(np.uint16) * 200, "TIFF"),
        "tiff_cmyk": _pil_save(img, "TIFF", "CMYK"),
        "bigtiff": b"II+\0\x08\0\0\0" + bytes(16),
    }
    return out


@pytest.mark.parametrize("kind", ["jpeg2000", "avif", "ppm", "pgm", "ico", "tga", "psd", "jpeg_in_tiff", "tiff_16bit",
                                  "tiff_cmyk", "bigtiff"])
def test_left_out_formats_refused(kind):
    with pytest.raises(ValueError, match="queue 1, item 14|ROADMAP item 14"):
        decode_rgb(_refused_files()[kind], kind)
