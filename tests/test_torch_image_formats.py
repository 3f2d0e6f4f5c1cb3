"""The port's decoding of the JPEG kinds and formats beyond baseline JPEG,
PNG and WebP (``io/jpeg.py``, ``io/gif.py``, ``io/bmp.py``,
``io/tiff.py``, ``io/jpeg2000.py``, ``io/pnm.py``, ``io/tga.py``,
``io/ico.py``, ``io/psd.py``, ``io/qoi.py``, ``io/image.py``) against
Pillow's ``Image.open(p).convert("RGB")``, bit for bit (the JPEG 2000 9/7
path included), the formats identified in Pillow's order, and the formats
left out, refused citing ROADMAP item 14 or as Pillow refuses them.

Pillow decodes arithmetic-coded JPEGs but cannot write them:
``_jpeg_writer.write_jpeg_arithmetic`` writes them (sequential and
progressive, restarts, DAC conditioning, grey, three and four components),
as ``write_jpeg_lossless`` writes lossless (SOF3) ones. Pillow writes CMYK
JPEGs; the writer writes YCCK. ``_image_writers`` writes the GIF, BMP,
TIFF, TGA, PSD, ICO/CUR and JP2-box variants Pillow does not."""

import io
import itertools
import struct

import numpy as np
import pytest
from PIL import Image

from _image_writers import (icon_dib, jp2_wrap, jpeg_tiff, write_bmp, write_gif, write_icon, write_psd, write_tga,
                            write_tiff)
from _j2k_writer import LAZY, PTERM, RESET, SEGSYM, TERMALL, VSC, write_j2k
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


def _assert_same_outcome(data: bytes) -> bool:
    """Pillow's decode, bit for bit, or a refusal where Pillow refuses the
    file (its decoders raise ``OSError`` or ``ValueError``)."""
    try:
        want = _pil_rgb(data)
    except (OSError, ValueError):
        with pytest.raises(ValueError):
            decode_rgb(data)
        return False
    got = decode_rgb(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return True


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
# formats left out (ROADMAP item 14's remainder), and those since decoded
# ---------------------------------------------------------------------------


def _refused_files():
    img = _pattern(20, 24, 8)
    rng = np.random.default_rng(8)
    out = {
        "jpeg2000": _pil_save(img, "JPEG2000"),
        "avif": _pil_save(img, "AVIF"),
        "ppm": _pil_save(img, "PPM"),
        "pgm": _pil_save(img, "PPM", "L"),
        "ico": _pil_save(img, "ICO"),
        "tga": _pil_save(img, "TGA"),
        "psd": write_psd(img.transpose(2, 0, 1), 3, compression=1),
        "jpeg_in_tiff": _pil_save(img, "TIFF", compression="jpeg"),
        "tiff_16bit": _pil_save(img[:, :, 0].astype(np.uint16) * 200, "TIFF"),
        "tiff_cmyk": _pil_save(img, "TIFF", "CMYK"),
        "bigtiff": write_tiff(img, 8, 2, "<", 5, bigtiff=True),
        "tiff_ccitt": _pil_save(img, "TIFF", "1", compression="group4"),
        "tiff_zstd": _pil_save(img, "TIFF", compression="zstd"),
        "tiff_webp": write_tiff(img, 8, 2, "<", 50001, pieces=[rng.integers(0, 256, 64).astype(np.uint8).tobytes()]),
        "tiff_lab": _pil_save(img, "TIFF", "LAB"),
        "imt": b"width 4\nheight 3\npixel n8\n\x0c" + bytes(range(12)),
        "spider": _pil_save(img[:, :, 0].astype(np.float32), "SPIDER"),
        "xbm": _pil_save(img, "XBM", "1"),
    }
    return out


# refused citing item 14, refused as Pillow refuses it; every other kind now decodes as Pillow decodes it (TIFF's
# CCITT and ZSTD since the slice of the formats Pillow writes)
_STILL_REFUSED = {"avif": "queue 1, item 14", "tiff_webp": "Pillow refuses it too", "tiff_lab": "queue 1, item 14",
                  "imt": "IMT is not supported .*queue 1, item 14",
                  "spider": "SPIDER is not supported .*queue 1, item 14",
                  "xbm": "XBM is not supported .*queue 1, item 14"}


@pytest.mark.parametrize("kind", ["jpeg2000", "avif", "ppm", "pgm", "ico", "tga", "psd", "jpeg_in_tiff", "tiff_16bit",
                                  "tiff_cmyk", "bigtiff", "tiff_ccitt", "tiff_zstd", "tiff_webp", "tiff_lab", "imt",
                                  "spider", "xbm"])
def test_left_out_formats_refused(kind):
    """The kinds ROADMAP item 14 leaves out: AVIF, Lab TIFF, IMT, SPIDER and
    XBM stay refused citing it (IMT and SPIDER in Pillow's place, not with
    the generic message), WebP-in-TIFF as Pillow refuses it (its libtiff is
    built without WebP); the rest, refused until the slices of the formats
    Pillow reads and writes beyond, decode bit-equal to Pillow."""
    data = _refused_files()[kind]
    if kind in _STILL_REFUSED:
        if kind == "tiff_webp":
            with pytest.raises(OSError):
                _pil_rgb(data)
        with pytest.raises(ValueError, match=_STILL_REFUSED[kind]):
            decode_rgb(data, kind)
    else:
        _assert_like_pil(data)


# ---------------------------------------------------------------------------
# identification in Pillow's order
# ---------------------------------------------------------------------------


def test_identification_follows_pillows_order():
    """An uncompressed true-colour TGA begins 00 00 02 00, CUR's signature:
    Pillow tries CUR first and lands on TGA because the cursor reader finds
    no entries; a DIB (a bitmap without its file header) is read by its
    header size; an unknown file is refused citing item 14, and a format
    Pillow identifies but cannot load here is refused saying so."""
    tga = _pil_save(_pattern(9, 11, 1), "TGA")
    assert tga[:4] == b"\0\0\2\0"
    assert Image.open(io.BytesIO(tga)).format == "TGA"
    _assert_like_pil(tga)
    dib = write_bmp(_pattern(7, 9, 2)[:, :, ::-1], 24, 40)[14:]
    assert Image.open(io.BytesIO(dib)).format == "DIB"
    _assert_like_pil(dib)
    with pytest.raises(ValueError, match="queue 1, item 14"):
        decode_rgb(b"not an image at all" * 4)
    eps = b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 10 10\n"
    with pytest.raises(ValueError, match="Ghostscript"):
        decode_rgb(eps)


# ---------------------------------------------------------------------------
# JPEG 2000
# ---------------------------------------------------------------------------

J2K_OPTIONS = {
    "tiles": dict(tile_size=(16, 16), num_resolutions=3),
    "tile_and_image_offsets": dict(tile_size=(16, 16), tile_offset=(3, 5), offset=(7, 9)),
    "codeblocks_4x4_precincts_16": dict(num_resolutions=3, codeblock_size=(4, 4), precinct_size=(16, 16)),
    "layers": dict(quality_mode="rates", quality_layers=[40, 20, 8]),
    "layers_db": dict(quality_mode="dB", quality_layers=[30, 45]),
    "codeblocks_8x16_plt": dict(codeblock_size=(8, 16), plt=True),
    "one_resolution": dict(num_resolutions=1),
}


@pytest.mark.parametrize("progression", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jpeg2000_progressions(progression, irreversible):
    """Each progression order over tiles and precincts, reversible and
    irreversible; the 9/7 path is bit-equal too (float32 in OpenJPEG's order
    of operations), so no tolerance is taken."""
    _assert_like_pil(_pil_save(_pattern(29, 35, 1), "JPEG2000", progression=progression, irreversible=irreversible,
                               tile_size=(16, 16), num_resolutions=3, precinct_size=(16, 16)))


@pytest.mark.parametrize("option", list(J2K_OPTIONS))
def test_jpeg2000_coding_options(option):
    for irreversible in (False, True):  # (OpenJPEG's encoder asserts on some sizes with offsets: 29 × 35 is safe)
        _assert_like_pil(_pil_save(_pattern(29, 35, 2), "JPEG2000", irreversible=irreversible, no_jp2=True,
                                   **J2K_OPTIONS[option]))


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "I;16", "CMYK", "signed"])
def test_jpeg2000_modes(mode):
    """Grey (codestream and JP2), grey with alpha, RGBA, 16-bit grey (mode
    I;16, clipped at 255), CMYK (``colr`` 12) and signed samples."""
    img = _pattern(19, 23, 3, 4)
    if mode == "I;16":
        im = Image.fromarray(img[:, :, 0].astype(np.uint16) * 41)
    else:
        im = Image.fromarray(img if mode in ("RGBA", "CMYK") else img[:, :, :3], "CMYK" if mode == "CMYK" else None)
        im = im.convert(mode) if mode in ("L", "LA") else im
    for irreversible, jp2 in itertools.product([False, True], [False, True]):
        buf = io.BytesIO()
        im.save(buf, "JPEG2000", irreversible=irreversible, no_jp2=not jp2, signed=mode == "signed")
        _assert_like_pil(buf.getvalue())


@pytest.mark.parametrize("style", ["bypass", "reset", "termall", "vsc", "pterm", "segsym", "all",
                                   "bypass_termall"])
def test_jpeg2000_codeblock_styles(style):
    """Every code-block style (``_j2k_writer``: Pillow writes none), at one
    and two layers: the bypass's raw segments, context resets, a segment a
    pass, vertically causal contexts, predictable termination and
    segmentation symbols."""
    bits = {"bypass": LAZY, "reset": RESET, "termall": TERMALL, "vsc": VSC, "pterm": PTERM, "segsym": SEGSYM,
            "all": 63, "bypass_termall": LAZY | TERMALL}[style]
    img = _pattern(19, 23, 12)[:, :, 0]
    for layers in (1, 2):
        _assert_like_pil(write_j2k([img], levels=1, style=bits, layers=layers))


def test_jpeg2000_packet_markers_and_roi():
    """Each progression order over three components and two layers, POC
    changes, SOP and EPH markers, packet headers in PPM and PPT markers,
    and a maxshift region of interest (``_j2k_writer``)."""
    comps = [_pattern(17, 21, 13 + k)[:, :, 0] for k in range(3)]
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        _assert_like_pil(write_j2k(comps, levels=2, layers=2, order=order))
    _assert_like_pil(write_j2k(comps, levels=2, layers=2, poc=[(0, 0, 2, 2, 3, 1), (2, 0, 2, 3, 3, 4)]))
    _assert_like_pil(write_j2k(comps, levels=1, layers=2, sop=True, eph=True))
    _assert_like_pil(write_j2k(comps, levels=1, layers=2, headers="ppm"))
    _assert_like_pil(write_j2k(comps, levels=1, layers=2, headers="ppt", sop=True, eph=True))
    _assert_like_pil(write_j2k([comps[0]], levels=1, roi=(10, (4, 12, 5, 15))))


def test_jpeg2000_colour_boxes():
    """JP2 boxes Pillow does not write: sYCC (Pillow's YCbCr → RGB), an ICC
    profile and an unknown enumeration (colour by component count), a
    palette (indices through Pillow's palette, repeated colours taking no
    slot), and a grey ``colr`` on three components, which Pillow refuses."""
    rng = np.random.default_rng(4)
    rgb = io.BytesIO()
    Image.fromarray(_pattern(13, 17, 4)).save(rgb, "JPEG2000", no_jp2=True, irreversible=True)
    rgb = rgb.getvalue()
    for kw in (dict(enumcs=18), dict(icc=bytes(128)), dict(enumcs=99)):
        _assert_like_pil(jp2_wrap(rgb, 3, 8, 13, 17, **kw))
    idx = io.BytesIO()
    Image.fromarray(rng.integers(0, 6, (13, 17)).astype(np.uint8)).save(idx, "JPEG2000", no_jp2=True)
    palette = np.array([[1, 2, 3], [4, 5, 6], [1, 2, 3], [7, 8, 9], [4, 5, 6], [0, 0, 0]])
    _assert_like_pil(jp2_wrap(idx.getvalue(), 1, 8, 13, 17, palette=palette))
    bad = jp2_wrap(rgb, 3, 8, 13, 17, enumcs=17)
    with pytest.raises(OSError):
        _pil_rgb(bad)
    with pytest.raises(ValueError, match="Pillow has no unpacker"):
        decode_rgb(bad)


# ---------------------------------------------------------------------------
# PBM / PGM / PPM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("magic", ["P1", "P2", "P3", "P4", "P5", "P6", "Pf", "P0CMYK", "PyRGBA", "PyP"])
def test_pnm(magic):
    """Plain and binary Netpbm with comments in the header and the data,
    maxvals below and above 255 (scaled as Pillow scales: 255, or 65535 in
    mode I clipped at 255), Pillow's own CMYK/RGBA/palette magics, and
    little- and big-endian floats."""
    rng = np.random.default_rng(len(magic) + ord(magic[1]))
    h, w = 5, 7
    if magic in ("P1", "P4"):
        bits = rng.integers(0, 2, (h, w))
        _assert_like_pil(b"P1\n# c\n%d %d\n" % (w, h) + "".join(map(str, bits.ravel())).encode()
                         if magic == "P1" else b"P4 %d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes())
        return
    if magic == "Pf":
        for scale in (b"-1.0", b"2.5"):
            v = rng.normal(100, 150, (h, w)).astype("<f4" if scale.startswith(b"-") else ">f4")
            _assert_like_pil(b"Pf\n%d %d\n%s\n" % (w, h, scale) + v.tobytes())
        return
    bands = {"P2": 1, "P3": 3, "P5": 1, "P6": 3, "P0CMYK": 4, "PyRGBA": 4, "PyP": 1}[magic]
    for maxval in (1, 7, 255, 256, 1000, 65535):
        v = rng.integers(0, maxval + 1, (h, w, bands))
        head = magic.encode() + b"\n# a comment\n%d %d\n%d\n" % (w, h, maxval)
        if magic in ("P2", "P3"):
            text = " ".join(map(str, v.ravel())).encode()
            _assert_like_pil(head + text.replace(b" ", b" # glue\n", 1))
        elif magic.startswith("P") and magic[1] in "56" or maxval == 255:
            _assert_like_pil(head + v.astype(">u2" if maxval > 255 else np.uint8).tobytes())


def test_pnm_refusals():
    for data in (b"P7\nWIDTH 1\n", b"PF\n1 1\n-1.0\n" + bytes(12)):  # PAM and colour floats: not Pillow PPMs
        with pytest.raises(Exception):
            _pil_rgb(data)
        with pytest.raises(ValueError):
            decode_rgb(data)
    for data in (b"P2 2 1 7 3 8", b"P5 2 1 70000\n", b"P6\n1 1\n255\nab"):
        with pytest.raises((OSError, ValueError)):
            _pil_rgb(data)
        with pytest.raises(ValueError):
            decode_rgb(data)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["palette24", "palette16", "rgb24", "rgba32", "rgb16", "grey8", "grey_alpha16",
                                  "bilevel"])
def test_tga(kind):
    """Image types 1/2/3 raw and 9/10/11 run-length coded (packets across
    rows where literal), each origin and mirroring, an ID field and a map
    starting past index 0."""
    rng = np.random.default_rng(len(kind))
    for (h, w), top, mirror, rle in itertools.product([(5, 7), (1, 1), (3, 40)], [False, True], [False, True],
                                                     [0, 8]):
        idx = rng.integers(0, 20, (h, w))
        idx[:, : w // 2] = 3
        px = rng.integers(0, 256, (h, w, 4))
        px[:, : w // 2] = px[:, :1]
        args = {"palette24": (idx, 1, 8, rng.integers(0, 256, (20, 3)), 24),
                "palette16": (idx, 1, 8, rng.integers(0, 65536, 20), 16),
                "rgb24": (px[..., :3], 2, 24), "rgba32": (px, 2, 32), "rgb16": (rng.integers(0, 65536, (h, w)), 2, 16),
                "grey8": (px[..., 0], 3, 8), "grey_alpha16": (px[..., :2], 3, 16),
                "bilevel": (px[..., 0] % 2, 3, 1)}[kind]
        if kind == "bilevel" and rle:
            continue
        data = write_tga(args[0], args[1] | rle, *args[2:], top=top, mirror=mirror, cross_rows=False,
                         id_field=b"id" if top else b"", map_start=2 if kind.startswith("palette") and mirror else 0)
        _assert_like_pil(data)
        if rle and kind in ("rgb16", "palette16"):  # literal packets across rows (a repeat across one is refused)
            _assert_same_outcome(write_tga(args[0], args[1] | rle, *args[2:], top=top, cross_rows=True))
    for mode, compression in itertools.product(["RGB", "RGBA", "L", "P", "LA", "1"], [None, "tga_rle"]):
        if (mode, compression) != ("1", "tga_rle"):  # Pillow cannot read that one back (test_tga_refusals)
            _assert_like_pil(_pil_save(_pattern(9, 11, 5, 4), "TGA", mode, compression=compression))


def test_tga_refusals():
    """A repeat packet across a row's end, a 32-bit colour map and Pillow's
    own run-length coded bilevel file: Pillow refuses them, and the port
    says so."""
    run = write_tga(np.full((3, 5, 3), 7), 10, 24, cross_rows=True)
    pal32 = write_tga(np.zeros((2, 2), int), 1, 8, np.zeros((2, 3), int), 32)
    rle1 = _pil_save(_pattern(9, 11, 5), "TGA", "1", compression="tga_rle")
    for data in (run, pal32, rle1):
        with pytest.raises((OSError, ValueError)):
            _pil_rgb(data)
        with pytest.raises(ValueError, match="Pillow"):
            decode_rgb(data)


# ---------------------------------------------------------------------------
# ICO / CUR, PSD, QOI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cursor", [False, True], ids=["ico", "cur"])
def test_ico_and_cur(cursor):
    """The entry Pillow picks (ICO: largest area, then lowest depth; CUR:
    the first, replaced by any larger in both dimensions), DIB entries of
    1–32 bits at half their stored height with their AND masks, and PNG
    entries; Pillow's own ICOs in PNG and BMP form."""
    rng = np.random.default_rng(int(cursor))

    def dib(h, w, bits):
        if bits <= 8:
            return icon_dib(rng.integers(0, 1 << bits, (h, w)), bits, rng.integers(0, 256, (1 << bits, 3)),
                            rng.integers(0, 2, (h, w)))
        px = rng.integers(0, 256, (h, w, 3)) if bits == 24 else rng.integers(0, 2**32, (h, w))
        return icon_dib(px, bits, mask=rng.integers(0, 2, (h, w)))

    for sizes in ([(16, 16, 8)], [(16, 16, 4), (32, 32, 1), (32, 32, 8), (24, 24, 32)], [(13, 7, 24), (7, 13, 32)],
                  [(32, 32, 32), (32, 32, 4)]):
        _assert_like_pil(write_icon([(dib(h, w, b), w, h, 0, b) for h, w, b in sizes], cursor))
        _assert_like_pil(write_icon([(dib(h, w, b), w, h, (1 << b) % 256 if b <= 8 else 0, 0) for h, w, b in sizes],
                                    cursor))
    if cursor:
        return
    rgba = np.concatenate([_pattern(40, 40, 6), rng.integers(0, 256, (40, 40, 1)).astype(np.uint8)], -1)
    for mode, fmt in itertools.product(["RGBA", "RGB", "P", "L"], ["png", "bmp"]):
        buf = io.BytesIO()
        Image.fromarray(rgba).convert(mode).save(buf, "ICO", sizes=[(16, 16), (32, 32), (40, 40)], bitmap_format=fmt)
        _assert_like_pil(buf.getvalue())


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
def test_psd(compression):
    """Bitmap, grey, duotone, multichannel, indexed (with and without its
    768-byte palette), RGB, RGBA and CMYK, extra channels, image resources;
    other depths and compressions refused as Pillow refuses them; Lab refused
    citing item 14."""
    rng = np.random.default_rng(compression)
    res = b"8BIM\x03\xed\x00\x00\x00\x00\x00\x10" + bytes(16)
    for (h, w), (mode, channels) in itertools.product([(5, 7), (3, 130)], [(3, 3), (3, 4), (3, 5), (4, 4), (4, 5),
                                                                          (1, 1), (8, 1), (7, 2), (2, 1)]):
        ch = rng.integers(0, 256, (channels, h, w))
        ch[:, :, : w // 2] = ch[:, :, :1]
        pal = rng.integers(0, 256, (256, 3)) if mode == 2 else None
        # extra channels shift Pillow's PackBits table: some such files it cannot read
        _assert_same_outcome(write_psd(ch, mode, 8, compression, pal, resources=res))
    _assert_like_pil(write_psd(rng.integers(0, 2, (1, 9, 13)), 0, 1, compression))
    _assert_like_pil(write_psd(rng.integers(0, 256, (1, 4, 5)), 2, 8, compression))  # no palette: black
    lab = write_psd(rng.integers(0, 256, (3, 4, 5)), 9, 8, compression)
    assert _pil_rgb(lab).shape == (4, 5, 3)
    with pytest.raises(ValueError, match="queue 1, item 14"):
        decode_rgb(lab)
    for data in (write_psd(rng.integers(0, 256, (3, 4, 5)), 3, 16, compression),
                 write_psd(rng.integers(0, 256, (3, 4, 5)), 3, 8, 2)):
        with pytest.raises(OSError):
            _pil_rgb(data)
        with pytest.raises(ValueError):
            decode_rgb(data)


def test_qoi():
    """Every QOI operation, from Pillow's encoder over RGB and RGBA images
    with runs, repeats and small differences."""
    rng = np.random.default_rng(9)
    img = _pattern(23, 29, 9, 4)
    img[5:9] = img[5:6]
    img[12:, ::3] = img[12:, :1]
    img[:, :, 3] = np.where(rng.random((23, 29)) < 0.3, 255, img[:, :, 3])
    for mode in ("RGB", "RGBA"):
        _assert_like_pil(_pil_save(img, "QOI", mode))
    _assert_like_pil(_pil_save(np.zeros((300, 2, 3), np.uint8), "QOI"))  # runs of 62 and more


# ---------------------------------------------------------------------------
# TIFF beyond the first reader: BigTIFF, 16/32-bit, planes, CMYK, JPEG, LZMA
# ---------------------------------------------------------------------------


def test_tiff_open_info_is_pillows():
    """The port's table of modes is Pillow 12.1's ``OPEN_INFO``."""
    from PIL.TiffImagePlugin import OPEN_INFO
    from sliders_conceptmod_tpu_torch.io.tiff import _open_info

    for key, want in OPEN_INFO.items():
        assert _open_info("<" if key[0] == b"II" else ">", *key[1:]) == want, key


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 34925], ids=["raw", "lzw", "deflate", "packbits", "lzma"])
def test_tiff_wide_samples_and_planes(compression):
    """Both byte orders, strips and tiles, classic and BigTIFF, planar
    configurations 1 and 2, the predictor: 16-bit RGB(A) and CMYK by their
    high bytes, associated alpha, 16/32-bit grey (clipped), signed and float
    samples (read byte-swapped where Pillow's big-endian rawmodes meet
    libtiff's native output), 4-bit grey."""
    rng = np.random.default_rng(compression)
    kinds = [(2, 16, 3, (), None), (2, 16, 4, (1,), None), (2, 8, 4, (1,), None), (1, 16, 1, (), None),
             (0, 16, 1, (), None), (1, 16, 1, (), 2), (1, 32, 1, (), 3), (1, 32, 1, (), 2), (5, 8, 4, (), None),
             (5, 16, 4, (), None), (1, 8, 2, (2,), None), (1, 4, 1, (), None)]
    decoded = 0
    for bo, predictor, layout, planar, big in itertools.product("<>", [1, 2], [(None, 5), ((16, 16), None)], [1, 2],
                                                                [False, True]):
        if big and bo == ">":
            continue
        tile, rows = layout
        for photo, bits, spp, extra, fmt in kinds:
            if predictor == 2 and (fmt == 3 or (bits < 8 and compression not in (1, 32773))):
                continue
            if bits == 16:
                s = rng.integers(0, 65536, (11, 19, spp))
                s[:, :5] = rng.integers(0, 300, (11, 5, spp))
            elif bits == 32 and fmt == 3:
                s = rng.normal(100, 150, (11, 19, spp)).astype(np.float32)
            elif bits == 32:
                s = rng.integers(-300, 600, (11, 19, spp)) % 2**32
            else:
                s = rng.integers(0, 1 << bits, (11, 19, spp))
            if fmt == 2 and bits == 16:
                s = rng.integers(-300, 600, (11, 19, spp)) % 65536
            # Pillow identifies no big-endian 16-bit WhiteIsZero and has no one-band unpacker for the planes of
            # some modes: refused alike
            decoded += _assert_same_outcome(write_tiff(s, bits, photo, bo, compression, predictor, rows, tile,
                                                       extra_samples=extra, planar=planar, bigtiff=big,
                                                       sample_format=fmt))
    assert decoded >= 200  # most files; the rest are refused by Pillow and the port alike


def test_tiff_big_endian_bigtiff_not_identified():
    """Pillow reads ``MM\\0+`` as a classic header and fails: not a TIFF for
    it, nor for the port."""
    data = write_tiff(_pattern(5, 6, 1), 8, 2, ">", 1, bigtiff=True)
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="identifies"):
        decode_rgb(data)


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (1, 1)], ids=["420", "422", "440", "444"])
def test_tiff_jpeg(sampling):
    """JPEG-compressed TIFF: YCbCr strips and tiles, the tables in
    ``JPEGTables`` or in each stream, upsampled by libjpeg's triangle
    filters (box replication differs) and converted to RGB as libtiff's
    ``JPEGCOLORMODE_RGB`` asks; RGB and grey components passed through;
    Pillow's own JPEG TIFFs."""
    img = np.clip(np.random.default_rng(sampling[0] * 3 + sampling[1]).normal(128, 60, (37, 45, 3)), 0, 255)
    img = img.astype(np.uint8)
    for layout, tables in itertools.product([dict(), dict(rows_per_strip=16), dict(tile=(16, 16))], [True, False]):
        _assert_like_pil(jpeg_tiff(img, 6, (sampling, (1, 1), (1, 1)), abbreviated=tables, **layout))
    if sampling == (1, 1):
        _assert_like_pil(jpeg_tiff(img, 2, ((1, 1),) * 3, rows_per_strip=16))
        _assert_like_pil(jpeg_tiff(img[:, :, :1], 1, ((1, 1),)))
        for mode in ("RGB", "L", "CMYK", "YCbCr"):
            _assert_like_pil(_pil_save(img, "TIFF", mode, compression="jpeg"))


def test_lossless_jpeg_subsampled_and_restart_rows():
    """SOF3 with subsampled components (replicated, as libjpeg-turbo 3
    upsamples lossless samples), restart intervals of whole MCU rows, and
    one that is not whole rows, which libjpeg-turbo refuses."""
    rng = np.random.default_rng(11)
    for (h, w), sampling, predictor, rows in itertools.product(
            [(13, 17), (9, 4)], [((2, 2), (1, 1), (1, 1)), ((1, 1), (2, 2), (1, 1)), ((2, 1), (1, 2), (1, 1))],
            [1, 7], [0, 1, 2]):
        img = np.clip(rng.normal(128, 50, (h, w, 3)), 0, 255).astype(np.uint8)
        hmax = max(s[0] for s in sampling)
        _assert_like_pil(write_jpeg_lossless(img, predictor, 0, sampling, rows * -(-w // hmax)))
    partial = write_jpeg_lossless(_pattern(13, 17, 1), 1, 0, None, 5)
    with pytest.raises(OSError):
        _pil_rgb(partial)
    with pytest.raises(ValueError, match="Pillow refuses them too"):
        decode_rgb(partial)
