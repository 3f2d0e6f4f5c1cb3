"""The port's image decoding (``io/jpeg.py``, ``io/png.py``, ``io/image.py``)
against Pillow's ``Image.open(p).convert("RGB")`` on this host, and the
image-pair bank (JPEG and WebP) against JAX's ``build_image_bank``. The
other formats have tests of their own (``test_torch_webp.py``,
``test_torch_image_formats.py``).

Files are written with Pillow where it writes the kind (baseline and
progressive JPEG at 4:4:4, 4:2:2 and 4:2:0, grey, ``optimize``, restart
markers, qualities 50–95, palette PNGs) and with the tests' own writers
where it does not (``_jpeg_writer``: 4:4:0, 4:1:1 and mixed sampling, RGB and
Adobe markers; ``_png_writer``: 2/4-bit grey, 16-bit colour, Adam7). The
port's decode is compared with Pillow's bit for bit, which is stricter than
the 1/255 the decoder is held to. The committed fixtures under
``tests/data/image_decode`` (``_make_image_fixtures.py``) are held to their
stored digests of Pillow's decode, which ``chip_smoke.py`` checks on the card's
machine without Pillow."""

import hashlib
import io
import itertools
import json
import os
import struct
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from _jpeg_writer import write_jpeg, write_jpeg_arithmetic, write_jpeg_lossless
from _png_writer import write_png
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)
from sliders_conceptmod_tpu.models import vae as jvae
from sliders_conceptmod_tpu.train import imageslider as jimage
from sliders_conceptmod_tpu_torch.io.image import decode_rgb, load_rgb
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.jpeg import decode_jpeg
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.models import vae as tvae
from sliders_conceptmod_tpu_torch.train import imageslider as timage

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "image_decode")
BANK_FOLDERS = ["minus2", "minus1", "plus1", "plus2"]


def _pattern(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx * 7 + yy * 3) % 256], -1)
    return np.clip(base + rng.integers(-60, 61, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_jpeg(img, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_like_pil(data: bytes, got: np.ndarray) -> None:
    want = _pil_rgb(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

SIZES = [(37, 53), (64, 64), (8, 8), (1, 1), (17, 3), (3, 2)]


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 90, 95])
def test_pil_baseline_jpeg(subsampling, quality):
    for (h, w) in SIZES:
        data = _pil_jpeg(_pattern(h, w, h * w + quality), quality=quality, subsampling=subsampling)
        _assert_like_pil(data, decode_jpeg(data))


@pytest.mark.parametrize("progressive,optimize,restart", list(itertools.product([False, True], [False, True], [0, 2])))
def test_pil_progressive_optimize_and_restart_jpeg(progressive, optimize, restart):
    for (h, w), sub in itertools.product(SIZES, [0, 1, 2]):
        kw = dict(quality=85, subsampling=sub, progressive=progressive, optimize=optimize)
        if restart:
            kw["restart_marker_blocks"] = restart
        data = _pil_jpeg(_pattern(h, w, h + 3 * w), **kw)
        _assert_like_pil(data, decode_jpeg(data))


@pytest.mark.parametrize("progressive", [False, True])
def test_grey_jpeg(progressive):
    for (h, w) in SIZES:
        data = _pil_jpeg(_pattern(h, w, 5), "L", quality=90, progressive=progressive)
        _assert_like_pil(data, decode_jpeg(data))
    data = write_jpeg(_pattern(37, 53, 6)[:, :, 1], restart=3)
    _assert_like_pil(data, decode_jpeg(data))


SAMPLINGS = {
    "440": ((1, 2), (1, 1), (1, 1)),  # h1v2: the vertical triangle filter
    "411": ((4, 1), (1, 1), (1, 1)),  # box replication (int_upsample)
    "410": ((4, 2), (1, 1), (1, 1)),
    "mixed": ((2, 2), (2, 1), (1, 2)),  # Cb h1v2, Cr h2v1 under a 2×2 luma
    "chroma_up": ((1, 1), (2, 2), (1, 1)),  # luma upsampled h2v2
}


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_other_samplings(name):
    for (h, w), restart in itertools.product([(37, 53), (16, 16), (5, 3), (1, 9), (9, 1), (2, 2), (31, 7)], [0, 3]):
        data = write_jpeg(_pattern(h, w, h + w), sampling=SAMPLINGS[name], restart=restart)
        _assert_like_pil(data, decode_jpeg(data))


@pytest.mark.parametrize("kw", [
    dict(jfif=False, ycc=False, ids=(82, 71, 66)),  # 'R', 'G', 'B' ids: RGB
    dict(jfif=False, ycc=False, adobe_transform=0),  # Adobe transform 0: RGB
    dict(jfif=False, adobe_transform=1),
    dict(jfif=False, adobe_transform=2),  # an unknown transform: YCbCr
    dict(jfif=False, ids=(5, 6, 7)),  # no marker, unknown ids: YCbCr
    dict(jfif=True, adobe_transform=0),  # JFIF wins: YCbCr
], ids=["rgb_ids", "adobe0", "adobe1", "adobe2", "no_marker", "jfif_and_adobe0"])
def test_colour_space_markers(kw):
    data = write_jpeg(_pattern(37, 53, 3), sampling=((1, 1),) * 3, **kw)
    _assert_like_pil(data, decode_jpeg(data))
    pil_rgb = _pil_jpeg(_pattern(24, 40, 8), quality=90, keep_rgb=True)  # Pillow's own Adobe RGB file
    _assert_like_pil(pil_rgb, decode_jpeg(pil_rgb))


def _patch_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    out = bytearray(data)
    at = out.index(b"\xff\xc0") if b"\xff\xc0" in out else out.index(b"\xff\xc2")
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("what,make,match", [
    ("arithmetic", lambda d: write_jpeg_arithmetic(_pattern(16, 16, 1), restart=2), "arithmetic"),
    ("arithmetic_progressive", lambda d: write_jpeg_arithmetic(_pattern(16, 16, 1), progressive=True), "arithmetic"),
    ("12-bit", lambda d: _patch_sof(d, marker=0xC1, precision=12), "12-bit"),
    ("lossless", lambda d: write_jpeg_lossless(_pattern(16, 16, 1), predictor=4), "lossless"),
    ("hierarchical", lambda d: _patch_sof(d, marker=0xC5), "hierarchical"),
])
def test_refused_jpeg_kinds(what, make, match):
    """The kinds the port once refused: arithmetic-coded (sequential and
    progressive) and lossless JPEGs now decode as Pillow decodes them;
    12-bit and hierarchical ones stay refused, as Pillow refuses them."""
    data = make(_pil_jpeg(_pattern(16, 16, 1), quality=90))
    if what in ("12-bit", "hierarchical"):
        with pytest.raises(Exception):
            _pil_rgb(data)
        with pytest.raises(ValueError, match=match) as err:
            decode_jpeg(data)
        assert "Pillow refuses them too" in str(err.value)
    else:
        _assert_like_pil(data, decode_jpeg(data))


def test_cmyk_and_webp_refused(tmp_path):
    """CMYK JPEGs, WebP and GIF, once refused, now decode as Pillow decodes
    them; bytes of no known format are refused citing item 14."""
    buf = io.BytesIO()
    Image.fromarray(_pattern(16, 16, 2)).convert("CMYK").save(buf, "JPEG")
    _assert_like_pil(buf.getvalue(), decode_jpeg(buf.getvalue()))
    path = tmp_path / "im.webp"
    Image.fromarray(_pattern(16, 16, 2)).save(path)
    _assert_like_pil(path.read_bytes(), load_rgb(str(path)))
    buf = io.BytesIO()
    Image.fromarray(_pattern(16, 16, 2)).save(buf, "GIF")
    _assert_like_pil(buf.getvalue(), decode_rgb(buf.getvalue()))
    with pytest.raises(ValueError, match="not an image format the port identifies") as err:
        decode_rgb(b"\0\0\0\0" + bytes(20))
    assert "queue 1, item 14" in str(err.value)


def test_512px_decode_time_and_signature_dispatch(tmp_path):
    """A 512×512 quality-90 4:2:0 image decodes bit-equal (its decode time
    on this host's CPU printed: ``pytest -s``); the format follows the bytes,
    not the name (a JPEG saved as .png)."""
    data = _pil_jpeg(_pattern(512, 512, 9), quality=90, subsampling=2)
    t0 = time.perf_counter()
    got = decode_jpeg(data)
    print(f"decode_jpeg 512x512 q90 4:2:0 ({len(data)} bytes): {time.perf_counter() - t0:.3f} s")
    _assert_like_pil(data, got)
    path = tmp_path / "really_a_jpeg.png"
    path.write_bytes(data)
    _assert_like_pil(data, load_rgb(str(path)))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 16), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 16), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_KINDS, ids=[f"type{c}_{d}bit" for c, d in PNG_KINDS])
def test_png_types(color, depth, interlace):
    rng = np.random.default_rng(color * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in [(1, 1), (3, 5), (9, 13), (17, 31)]:
        samples = rng.integers(0, 1 << depth, (h, w, ch))
        palette = trns = None
        if color == 3:  # a palette shorter than the indices reach: Pillow gives black past its end
            palette = rng.integers(0, 256, (max(1, (1 << depth) // 2 + 1), 3))
            trns = b"\x00\x80"  # dropped by convert("RGB")
        data = write_png(samples, depth, color, palette=palette, trns=trns, interlace=interlace)
        _assert_like_pil(data, decode_rgb(data))


def test_png_8bit_interlaced_and_16bit_clipping():
    rng = np.random.default_rng(4)
    for color in (0, 2, 4, 6):
        ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
        data = write_png(rng.integers(0, 256, (23, 29, ch)), 8, color, interlace=True)
        _assert_like_pil(data, decode_rgb(data))
    # 16-bit grey: Pillow clips to 255 where the other 16-bit types take the high byte
    grey = np.array([[0, 1, 255, 256, 1000, 65535, 32768, 128]])
    np.testing.assert_array_equal(decode_png(write_png(grey, 16, 0)), [[0, 1, 255, 255, 255, 255, 255, 128]])
    np.testing.assert_array_equal(decode_png(write_png(np.stack([grey] * 3, -1), 16, 2))[..., 0],
                                  [[0, 0, 0, 1, 3, 255, 128, 0]])


def test_png_errors():
    data = bytearray(write_png(np.zeros((4, 4)), 8, 0))
    data[24] = 3  # bit depth 3
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="bit depth 3"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="PLTE"):
        decode_png(write_png(np.zeros((4, 4), int), 8, 3))


# ---------------------------------------------------------------------------
# committed fixtures and the JPEG bank
# ---------------------------------------------------------------------------


def test_committed_fixtures_match_their_digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert len(digests) >= 93 and any(n.startswith("bank/") and n.endswith(".webp") for n in digests)
    for name, want in digests.items():
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        pil = _pil_rgb(data)
        assert hashlib.sha256(pil.tobytes()).hexdigest() == want["sha256"], name
        got = load_rgb(path)
        assert list(got.shape) == want["shape"] and hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
    assert os.path.getsize(FIXTURES) and sum(
        os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURES) for n in ns) < 400_000


def test_timing_files_match_their_digests():
    """The files whose decode chip_smoke.py times (outside the fixtures'
    size bound): three 512x512 ones (a lossy WebP, a 4:2:0 JPEG and an
    irreversible JPEG 2000), a 512x512 RGB ZSTD TIFF in one strip of
    several blocks and a 1728-pixel-wide Group 4 page. Pillow's decode of
    each is its stored digest; the port's decode is held to it here, and on
    the card's host by chip_smoke.py for the JPEG 2000 (its lockstep tier-1
    takes seconds there, too long for this suite)."""
    root = os.path.join(os.path.dirname(FIXTURES), "image_decode_timing")
    with open(os.path.join(root, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == ["j2k_irreversible_512.jp2", "jpeg_420_q90_512.jpg", "tiff_group4_1728.tif",
                               "tiff_zstd_rgb_512.tif", "webp_lossy_q90_512.webp"]
    for name, want in digests.items():
        path = os.path.join(root, name)
        with open(path, "rb") as f:
            assert hashlib.sha256(_pil_rgb(f.read()).tobytes()).hexdigest() == want["sha256"], name
        if name.endswith(".jp2"):
            assert want["shape"] == [512, 512, 3]
            continue
        got = load_rgb(path)
        assert list(got.shape) == want["shape"] == ([1100, 1728, 3] if "1728" in name else [512, 512, 3])
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name


@pytest.mark.parametrize("name", ["j2k_rgb_irreversible_tiles_rpcl.jp2", "j2k_grey_irreversible.j2k",
                                  "ppm_maxval300.ppm", "pbm_plain.pbm", "tga_palette_rle.tga", "ico_bmp.ico",
                                  "cursor.cur", "psd_cmyk_packbits.psd", "qoi_rgba.qoi", "tiff_rgb16_mm_predictor.tif",
                                  "tiff_ycbcr_jpeg_420_tables.tif", "tiff_bigtiff_tiled.tif", "lossless_420.jpg",
                                  "pcx_palette.pcx", "dcx_first.dcx", "sgi_rgba_16bit_rle.sgi", "dds_bc7.dds",
                                  "ftex_dxt1.ftc", "blp2_dxt3.blp", "icns_png.icns", "tiff_group4.tif",
                                  "tiff_zstd_predictor.tif", "tiff_ycc_420_tiles_refbw.tif"])
def test_new_formats_load_as_jax_loads_them(name):
    """One committed file of each format (and TIFF and JPEG kind) that the
    port decodes beyond JPEG, PNG, WebP, GIF and BMP: the port's
    ``load_image_array`` against the JAX package's, which reads through
    Pillow, at the file's size and resized."""
    path = os.path.join(FIXTURES, name)
    for resolution in (24, 16):
        np.testing.assert_array_equal(timage.load_image_array(path, resolution),
                                      jimage.load_image_array(path, resolution))


@pytest.mark.parametrize("resolution", [96, 32])
def test_image_bank_matches_jax(monkeypatch, resolution):
    """The committed bank's folders (two JPEGs, a lossy and a lossless WebP
    each) through JAX's PIL loader (its native loader turned off: it
    resizes bilinearly) and through the port, one tiny VAE."""
    from sliders_conceptmod_tpu.io import native

    monkeypatch.setattr(native, "load_images_native", lambda paths, res: None)
    root = os.path.join(FIXTURES, "bank")
    scales = [-2.0, -1.0, 1.0, 2.0]
    names = timage.list_paired_images(root, BANK_FOLDERS)
    assert sorted(os.path.splitext(n)[1] for n in names) == [".jpg", ".jpg", ".webp", ".webp"]
    for name in names:
        for folder in BANK_FOLDERS:
            path = os.path.join(root, folder, name)
            np.testing.assert_array_equal(timage.load_image_array(path, resolution),
                                          jimage.load_image_array(path, resolution))
    model = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
                          model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"])
    want = jimage.build_image_bank(root, BANK_FOLDERS, scales,
                                   lambda x: model.apply({"params": params}, x, method=model.encode), resolution)
    port = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    got = timage.build_image_bank(root, BANK_FOLDERS, scales, port.eval().encode, resolution)
    assert got.pair_table == [tuple(r) for r in np.asarray(want.pair_table).tolist()]
    assert tuple(got.mean.shape) == np.asarray(want.mean).shape == (4, len(names), 4, resolution // 2,
                                                                    resolution // 2)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.logvar.numpy(), np.asarray(want.logvar), atol=2e-4, rtol=0)
