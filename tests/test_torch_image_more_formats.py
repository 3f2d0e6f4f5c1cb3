"""The image kinds Pillow writes (or reads) that the port decoded last,
against Pillow 12.1's ``Image.open(p).convert("RGB")`` bit for bit: TIFF's CCITT fax codes (``io/ccitt.py``), its ZSTD
(``io/zstd.py``) and its YCbCr outside JPEG (libtiff's RGBA interface, in
``io/tiff.py``); PCX and DCX (``io/pcx.py``), SGI (``io/sgi.py``), the
BC1–BC7 blocks (``io/bcn.py``) of DDS (``io/dds.py``) and FTEX
(``io/ftex.py``), ICNS (``io/icns.py``) and BLP (``io/blp.py``); the
shared pieces (``io/_common.py``); IMT and SPIDER refused in Pillow's
order; and the CLIP scorer over a folder of every new format.

Pillow writes what it can (PCX, SGI raw, DDS raw and DXT1/3/5/BC2/BC3/BC5,
BLP palettes, ICNS with PNG, TIFF group3/group4/tiff_ccitt/zstd and YCbCr);
``_image_writers`` writes the rest (T.4 2-D rows, fill bits and fill order
2, subsampled YCbCr units, PCX bit planes, DCX, SGI run-length rows, every
DDS pixel format, FTEX, BLP JPEG and DXT, ICNS legacy entries), and
``zstandard`` the frames libtiff does not produce. Where Pillow refuses a
file the port raises ``ValueError``. The BCn decoders are held to Pillow's
C ``bcn`` decoder on seeded random blocks, 256 or more of each BCn mode,
BC6H mode and BC7 mode; BC7's partition and anchor tables and T.4's code
tables are pinned against Pillow one entry at a time."""

import csv
import io
import itertools
import os
import struct

import numpy as np
import pytest
import torch
import zstandard
from PIL import Image

from _image_writers import (fax_tiff, icns_rle, pcx_planes, split_jpeg, write_blp, write_dcx, write_dds, write_ftex,
                            write_icns, write_pcx, write_sgi, write_tiff, ycbcr_tiff)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)
from sliders_conceptmod_tpu_torch.io import bcn, ccitt, jpeg, zstd
from sliders_conceptmod_tpu_torch.io._common import ITEM, NotThisFormat, cmyk2rgb, error, refuse
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
    """Pillow's decode, bit for bit, or ``ValueError`` where Pillow refuses
    the file (with any exception: its BLP and FTEX readers raise
    ``NotImplementedError`` and ``AssertionError`` too)."""
    try:
        want = _pil_rgb(data)
    except Exception:
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


SIZES = [(13, 17), (1, 1), (8, 16), (5, 3), (4, 9)]


# ---------------------------------------------------------------------------
# io/_common.py: the shared pieces
# ---------------------------------------------------------------------------


def test_shared_pieces():
    """One ``error``/``refuse`` pair for every reader, their messages as the
    readers' own were; ``io/jpeg.py`` re-exports the names it first held."""
    assert str(error("PCX", "a run past the end of its row")) == "PCX: a run past the end of its row"
    assert str(refuse("TIFF", "Lab colour")) == f"TIFF: Lab colour is not supported ({ITEM})"
    assert ITEM == "ROADMAP.md queue 1, item 14" and issubclass(NotThisFormat, ValueError)
    assert jpeg.ITEM is ITEM and jpeg.NotThisFormat is NotThisFormat and jpeg.cmyk2rgb is cmyk2rgb
    np.testing.assert_array_equal(cmyk2rgb(np.array([[0, 0, 0, 0], [255, 0, 0, 0], [0, 0, 0, 255]])),
                                  [[255, 255, 255], [0, 255, 255], [0, 0, 0]])
    with pytest.raises(ValueError, match="^TIFF: a palette image without a ColorMap$"):
        decode_rgb(write_tiff(np.zeros((2, 2, 1), np.int64), 8, 3, "<", 1))


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------


def _pcx_files(variant: str):
    rng = np.random.default_rng(len(variant))
    for h, w in SIZES:
        img = _pattern(h, w, h * w)
        idx = rng.integers(0, 16, (h, w))
        pal16 = rng.integers(0, 256, (16, 3))
        stride = (w + 7) // 8
        if variant in ("1", "L", "P", "RGB"):
            yield _pil_save(img, "PCX", variant)
        elif variant in ("planes2", "planes4"):
            planes = int(variant[-1])
            for st in (stride, stride + stride % 2):
                yield write_pcx(pcx_planes(idx % (1 << planes), planes, st), w, 1, planes, palette16=pal16)
        elif variant == "grey_ramp":
            rows = np.pad(img[:, :, 0], ((0, 0), (0, w % 2)))
            yield write_pcx(rows, w, 8, 1, palette256=np.repeat(np.arange(256)[:, None], 3, 1))
            yield write_pcx(rows, w, 8, 1)  # no trailing palette: grey
        elif variant == "palette_marker":  # a 769-byte tail without its 12 is no palette: grey
            rows = np.pad(img[:, :, 0], ((0, 0), (0, w % 2)))
            data = write_pcx(rows, w, 8, 1, palette256=rng.integers(0, 256, (256, 3)))
            yield data[:-769] + b"\x0b" + data[-768:]
        elif variant == "header_stride":  # the header's stride differs from the width's: made even
            rows = np.pad(img.transpose(0, 2, 1), ((0, 0), (0, 0), (0, w % 2))).reshape(h, -1)
            yield write_pcx(rows, w, 8, 3, stride=w + 2)
        elif variant == "origin":
            yield write_pcx(np.pad(img[:, :, 0], ((0, 0), (0, w % 2))), w, 8, 1, origin=(5, 7))
        elif variant == "dcx":
            frames = [_pil_save(img, "PCX", "P"), _pil_save(img, "PCX", "1")]
            yield write_dcx(frames)
            yield write_dcx([write_pcx(pcx_planes(idx, 4, stride + stride % 2), w, 1, 4, palette16=pal16)])
        elif variant == "refused":
            yield write_pcx(pcx_planes(idx % 4, 1, (2 * w + 7) // 8), w, 2, 1)  # 2 bits
            yield write_pcx(pcx_planes(idx % 8, 3, stride), w, 1, 3)  # 1 bit in 3 planes
            yield write_pcx(np.pad(img[:, :, 0], ((0, 0), (0, w % 2))), w, 8, 1, version=3)
            yield _pil_save(img, "PCX", "RGB")[:-3]  # truncated
            bad = bytearray(write_pcx(np.zeros((h, w + w % 2), np.uint8), w, 8, 1))
            bad[128:130] = bytes([0xC0 | 63, 9])  # a run past its row
            yield bytes(bad)
            yield write_dcx([])


@pytest.mark.parametrize("variant", ["1", "L", "P", "RGB", "planes2", "planes4", "grey_ramp", "palette_marker",
                                     "header_stride", "origin", "dcx", "refused"])
def test_pcx(variant):
    """Pillow's four modes at odd and even widths (a padded RGB row is read
    as the decoder moves its planes, or not), the bit-plane palettes,
    the trailing palette's checks, DCX's first image; and what Pillow
    refuses."""
    decoded = [_assert_same_outcome(d) for d in _pcx_files(variant)]
    assert any(decoded) if variant != "refused" else not any(decoded)  # Pillow refuses its own 1 × 1 RGB


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,bpc,rle", [(m, b, r) for m in ("L", "RGB", "RGBA") for b in (1, 2) for r in (0, 1)])
def test_sgi(mode, bpc, rle):
    """Pillow writes raw 8- and 16-bit files; the writer run-length ones
    (grey in one and two dimensions)."""
    c = len(mode)
    for h, w in SIZES:
        img8 = _pattern(h, w, h + w + c, c)
        img = img8.astype(np.int64)
        if bpc == 2:
            img = img * 256 + np.random.default_rng(h).integers(0, 256, img.shape)
        if not rle:
            _assert_like_pil(_pil_save(img8[:, :, 0] if c == 1 else img8, "SGI", mode, bpc=bpc))
            _assert_like_pil(write_sgi(img.transpose(2, 0, 1), bpc, False))
        else:
            for dim in ((1, 2) if c == 1 else (3,)):
                planes = img.transpose(2, 0, 1).copy()
                planes[:, h // 2] = planes[:, h // 2, :1]  # a repeat run across the row
                _assert_like_pil(write_sgi(planes, bpc, True, dim))


def test_sgi_run_length_readings_and_refusals():
    """The decoder's readings: a last count that is not zero ends the image
    (the rows above stay black, no error); a row shorter than the image
    keeps the previous row's samples. And what Pillow refuses: two
    channels, an unknown compression, truncated data and tables, a run
    past its row."""
    planes = _pattern(6, 9, 3, 1).transpose(2, 0, 1).astype(np.int64)
    data = bytearray(write_sgi(planes, 1, True))
    starts = struct.unpack_from(">6I", data, 512)
    # row 2 (from the bottom) read as one count that is not zero: the image ends there
    struct.pack_into(">I", data, 512 + 4 * 6 + 4 * 2, 1)
    assert data[starts[2]] != 0
    assert _assert_same_outcome(bytes(data))
    short = bytearray(write_sgi(planes, 1, True))
    short[starts[1]] = 0  # the second row is empty: it keeps the first row's samples
    assert _assert_same_outcome(bytes(short))
    two = write_sgi(np.zeros((2, 4, 5), np.int64), 1, True)
    assert not _assert_same_outcome(two)
    raw = write_sgi(planes, 1, False)
    assert not _assert_same_outcome(raw[:-5])
    assert not _assert_same_outcome(raw[:2] + b"\x02" + raw[3:])
    assert not _assert_same_outcome(write_sgi(planes, 1, True)[:540])
    wide = bytearray(write_sgi(planes, 1, True))
    wide[starts[0]] = 20  # a run of 20 in a row of 9
    assert not _assert_same_outcome(bytes(wide))


# ---------------------------------------------------------------------------
# BC1–BC7 (io/bcn.py), on seeded random blocks
# ---------------------------------------------------------------------------

_BCN = {"BC1": (1, 8), "BC2": (2, 16), "BC3": (3, 16), "BC4": (4, 8), "BC5": (5, 16), "BC5S": (5, 16)}
_BC6_MODE_BITS = [0, 1] + [2 | (k << 2) for k in range(8)] + [3 | (k << 2) for k in range(4)] + [0x13]
BCN_KINDS = (list(_BCN) + [f"BC6H{s}_mode{m}" for s in ("", "S") for m in range(15)]
             + [f"BC7_mode{m}" for m in range(9)])


def _random_blocks(kind: str, n: int, seed: int) -> bytes:
    size = _BCN[kind][1] if kind in _BCN else 16
    raw = np.random.default_rng(seed).integers(0, 256, (n, size)).astype(np.uint8)
    if kind.startswith("BC6H"):
        bits = _BC6_MODE_BITS[int(kind.split("mode")[1])]  # mode 14: a reserved one
        width = 2 if bits < 2 else 5
        raw[:, 0] = (raw[:, 0] & np.uint8(~((1 << width) - 1) & 0xFF)) | bits
    elif kind.startswith("BC7"):
        mode = int(kind.split("mode")[1])
        raw[:, 0] = 0 if mode == 8 else (raw[:, 0] & np.uint8(~((2 << mode) - 1) & 0xFF)) | (1 << mode)
    return raw.tobytes()


@pytest.mark.parametrize("kind", BCN_KINDS)
def test_bcn_random_blocks(kind):
    """256 seeded random blocks (a 64 × 64 surface) of each kind through
    Pillow's C decoder and the port's, then a ragged 30 × 21 surface; BC6H
    and BC7 each of their modes (BC6H's reserved modes are black; a BC7 block
    with no mode bit is opaque black)."""
    name = kind.split("_")[0]
    n, _ = _BCN.get(name, (6 if name.startswith("BC6H") else 7, 16))
    for w, h, seed in ((64, 64, 1), (30, 21, 2)):
        blocks = _random_blocks(kind, -(-w // 4) * -(-h // 4), seed)
        data = write_dds(w, h, blocks, dxgi=name)
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = bcn.decode_bcn(blocks, w, h, n, name)
        np.testing.assert_array_equal(got[:, :, 0] if want.ndim == 2 else got, want)
        _assert_like_pil(data)


def test_bc7_tables_pinned():
    """Each entry of BC7's partition and anchor tables read off Pillow's
    decoder: a mode 1 (two subsets) or mode 2 (three subsets) block of each
    partition whose subsets' endpoints differ shows the partition; its
    index bits all set show the anchors, which take one bit fewer."""
    def block(fields):
        v, pos = 0, 0
        for val, n in fields:
            v |= (val & ((1 << n) - 1)) << pos
            pos += n
        return v.to_bytes(16, "little")

    def red(b):
        return np.asarray(Image.open(io.BytesIO(write_dds(4, 4, b, dxgi="BC7"))).convert("RGB"))[..., 0].reshape(-1)

    for p in range(64):
        r = red(block([(2, 2), (p, 6)] + [(v, 6) for v in (0, 0, 20, 20)] + [(0, 6)] * 8 + [(0, 48)]))
        assert sum(int(b) << i for i, b in enumerate(r > 0)) == bcn.SI2[p]
        r = red(block([(2, 2), (p, 6)] + [(v, 6) for v in (0, 63, 0, 63)] + [(0, 6)] * 8 + [(0, 2), (-1, 46)]))
        assert [i for i in range(16) if r[i] != r.max()] == [0, bcn.AI0[p]]
        r = red(block([(4, 3), (p, 6)] + [(v, 5) for v in (0, 0, 10, 10, 20, 20)] + [(0, 5)] * 12 + [(0, 29)]))
        sub = [sorted(set(r.tolist())).index(x) for x in r]
        assert sum(s << (2 * i) for i, s in enumerate(sub)) == bcn.SI3[p]
        r = red(block([(4, 3), (p, 6)] + [(v, 5) for v in (0, 31) * 3] + [(0, 5)] * 12 + [(-1, 29)]))
        anchors = [i for i in range(16) if r[i] != r.max()]
        assert anchors == sorted({0, bcn.AI1[p], bcn.AI2[p]})
        assert sub[bcn.AI1[p]] == 1 and sub[bcn.AI2[p]] == 2


# ---------------------------------------------------------------------------
# DDS and FTEX
# ---------------------------------------------------------------------------


def _dds_files(variant: str):
    rng = np.random.default_rng(len(variant) + 3)
    for h, w in SIZES:
        rgba = _pattern(h, w, h * w + 1, 4)
        nb = -(-w // 4) * -(-h // 4)
        if variant in ("RGB", "RGBA", "L", "LA"):
            yield _pil_save(rgba, "DDS", variant)
        elif variant in ("DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"):
            yield _pil_save(rgba, "DDS", "RGB" if variant == "BC5" else "RGBA", pixel_format=variant)
        elif variant == "masks":
            for bitcount, masks, flags in ((16, (0xF800, 0x7E0, 0x1F, 0), 0x40),
                                           (16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41),
                                           (24, (0xFF, 0xFF00, 0xFF0000, 0), 0x40),
                                           (32, (0xFF0000, 0xFF00, 0xFF, 0), 0x40), (16, (0xF00, 0xF0, 0, 0xF), 0x41)):
                payload = rng.integers(0, 256, w * h * bitcount // 8).astype(np.uint8).tobytes()
                yield write_dds(w, h, payload, pfflags=flags, bitcount=bitcount, masks=masks)
                yield write_dds(w, h, payload[: len(payload) // 2], pfflags=flags, bitcount=bitcount, masks=masks)
        elif variant == "luminance_palette":
            yield write_dds(w, h, rng.integers(0, 256, w * h).astype(np.uint8).tobytes(), pfflags=0x20000, bitcount=8)
            yield write_dds(w, h, rng.integers(0, 256, 2 * w * h).astype(np.uint8).tobytes(), pfflags=0x20001,
                            bitcount=16)
            yield write_dds(w, h, rng.integers(0, 256, w * h).astype(np.uint8).tobytes(), pfflags=0x20, bitcount=8,
                            palette=rng.integers(0, 256, (256, 4)))
        elif variant == "fourcc":
            for fourcc, size in ((b"ATI1", 8), (b"BC4U", 8), (b"ATI2", 16), (b"BC5U", 16), (b"BC5S", 16)):
                yield write_dds(w, h, rng.integers(0, 256, nb * size).astype(np.uint8).tobytes(), fourcc=fourcc)
        elif variant == "dx10":
            for name, size in (("BC1", 8), ("BC4", 8), ("BC6H", 16), ("BC6HS", 16), ("BC7", 16)):
                yield write_dds(w, h, rng.integers(0, 256, nb * size).astype(np.uint8).tobytes(), dxgi=name)
            yield write_dds(w, h, rng.integers(0, 256, 4 * w * h).astype(np.uint8).tobytes(), dxgi="RGBA")
        elif variant == "refused":
            good = _pil_save(rgba, "DDS", "RGBA", pixel_format="DXT5")
            yield good[:4] + struct.pack("<I", 100) + good[8:]
            yield good[:-1]
            yield write_dds(w, h, b"\0" * 64, fourcc=b"DXT2")
            yield write_dds(w, h, b"\0" * 64, pfflags=0x20000, bitcount=4)
            yield write_dds(w, h, b"\0" * 64, pfflags=0x2)
            yield _pil_save(rgba, "DDS", "L")[:-1]
            data = write_dds(w, h, b"\0" * (nb * 16), dxgi="BC7")
            yield data[:128] + struct.pack("<I", 2) + data[132:]  # DXGI R32G32B32A32_FLOAT


@pytest.mark.parametrize("variant", ["RGB", "RGBA", "L", "LA", "DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5", "masks",
                                     "luminance_palette", "fourcc", "dx10", "refused"])
def test_dds(variant):
    """Pillow's own DDS files (raw and its BCn encoders), every other pixel
    format the writer's (masks scaled to 8 bits, short files black at the
    end, luminance, palettes, FourCC and DX10 headers), and refusals."""
    decoded = [_assert_same_outcome(d) for d in _dds_files(variant)]
    assert all(decoded) if variant != "refused" else not any(decoded)


@pytest.mark.parametrize("kind", ["dxt1", "uncompressed", "refused"])
def test_ftex(kind):
    rng = np.random.default_rng(5)
    for h, w in SIZES:
        if kind == "dxt1":
            _assert_like_pil(write_ftex(w, h, rng.integers(0, 256, -(-w // 4) * -(-h // 4) * 8).astype(np.uint8)
                                        .tobytes(), 0))
        elif kind == "uncompressed":
            _assert_like_pil(write_ftex(w, h, _pattern(h, w, 2).tobytes(), 1))
        else:
            good = write_ftex(w, h, _pattern(h, w, 2).tobytes(), 1)
            for bad in (write_ftex(w, h, b"\0" * 64, 2), good[:20] + struct.pack("<i", 2) + good[24:], good[:-1]):
                assert not _assert_same_outcome(bad)


# ---------------------------------------------------------------------------
# BLP
# ---------------------------------------------------------------------------


def _blp_files(variant: str):
    rng = np.random.default_rng(len(variant) + 11)
    for h, w in SIZES:
        img = _pattern(h, w, h + 2 * w)
        if variant in ("blp1_palette", "blp2_palette"):
            version = variant[:4].upper()
            yield _pil_save(img, "BLP", "P", blp_version=version)
            buf = io.BytesIO()
            Image.fromarray(_pattern(h, w, 4, 4), "RGBA").quantize(16).save(buf, "BLP", blp_version=version)
            yield buf.getvalue()
        elif variant == "blp1_jpeg":
            for mode, alpha in (("RGB", 0), ("RGB", 8), ("L", 0), ("CMYK", 0)):
                head, scan = split_jpeg(_pil_save(img, "JPEG", mode, quality=85))
                yield write_blp(1, w, h, scan, 0, 5, alpha, jpeg_header=head)
        elif variant.startswith("blp2_dxt"):
            ae = {"blp2_dxt1": 0, "blp2_dxt3": 1, "blp2_dxt5": 7}[variant]
            size = 8 if ae == 0 else 16
            blocks = rng.integers(0, 256, -(-w // 4) * -(-h // 4) * size).astype(np.uint8)
            for alpha in (0, 1, 8):
                yield write_blp(2, w, h, blocks.tobytes(), 1, 2, alpha, ae)
        elif variant == "refused":
            idx = rng.integers(0, 256, w * h).astype(np.uint8).tobytes()
            yield write_blp(2, w, h, idx, 1, 3)  # raw BGRA
            yield write_blp(2, w, h, idx, 0, 1)  # BLP2 JPEG
            yield write_blp(2, w, h, idx, 1, 2, 0, 4)  # alpha encoding 4
            yield write_blp(1, w, h, idx, 1, 3)  # BLP1 encoding 3
            yield write_blp(2, w, h, idx[:-1], 1, 1)  # too few indices
            yield write_blp(2, w, h, b"\0" * 7, 1, 2, 0, 0)  # truncated blocks


@pytest.mark.parametrize("variant", ["blp1_palette", "blp2_palette", "blp1_jpeg", "blp2_dxt1", "blp2_dxt3",
                                     "blp2_dxt5", "refused"])
def test_blp(variant):
    """Pillow writes BLP1 and BLP2 palettes; the writer BLP1 JPEG (the
    header shared, the channels taken B, G, R; grey and CMYK too) and BLP2
    DXT (the plugin's Python decoders, rows padded to whole blocks read as
    the image's rows, alpha or not, so widths that are no multiple of 4
    shear as Pillow shears them)."""
    decoded = [_assert_same_outcome(d) for d in _blp_files(variant)]
    assert all(decoded) if variant != "refused" else not any(decoded)


def test_blp_dxt_is_not_the_c_decoder():
    """BLP2's DXT1 widens RGB565 by a shift, the C decoder by replication:
    the same block decodes differently, each as its Pillow decoder does."""
    block = bytes([0xFF, 0xFF, 0x00, 0x00, 0, 0, 0, 0])
    blp = decode_rgb(write_blp(2, 4, 4, block, 1, 2, 0, 0))
    dds = decode_rgb(write_dds(4, 4, block, fourcc=b"DXT1"))
    assert blp[0, 0].tolist() == [248, 252, 248] and dds[0, 0].tolist() == [255, 255, 255]
    _assert_like_pil(write_blp(2, 4, 4, block, 1, 2, 0, 0))


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------


def _png(img) -> bytes:
    return _pil_save(img, "PNG")


def _icns_files(variant: str):
    rng = np.random.default_rng(len(variant))
    if variant == "pillow":
        yield _pil_save(_pattern(40, 40, 3), "ICNS")
    elif variant == "png":
        yield write_icns([(b"icp4", _png(_pattern(16, 16, 1, 4))), (b"ic11", _png(_pattern(32, 32, 2)))])
        yield write_icns([(b"ic11", _png(_pattern(16, 16, 3)))])  # half the entry's size: a scale Pillow allows
    elif variant == "jpeg2000":
        yield write_icns([(b"icp4", _pil_save(_pattern(16, 16, 4), "JPEG2000"))])
        yield write_icns([(b"icp5", _pil_save(_pattern(32, 32, 5), "JPEG2000", no_jp2=True))])
    elif variant == "legacy":
        for kind, mask, n in ((b"is32", b"s8mk", 16), (b"il32", b"l8mk", 32), (b"ih32", b"h8mk", 48)):
            rgb = _pattern(n, n, n)
            rgb[n // 3 : n // 2] = 9  # runs
            yield write_icns([(kind, b"".join(icns_rle(rgb[:, :, c]) for c in range(3))),
                              (mask, rng.integers(0, 256, n * n).astype(np.uint8).tobytes())])
            yield write_icns([(kind, rgb.tobytes())])  # raw RGB
        rgb = np.repeat(_pattern(16, 16, 7), 8, 0).repeat(8, 1)
        yield write_icns([(b"it32", b"\0\0\0\0" + b"".join(icns_rle(rgb[:, :, c]) for c in range(3)))])
        yield write_icns([(b"is32", b"".join(icns_rle(_pattern(16, 16, 8)[:, :, c]) for c in range(3))),
                          (b"icp4", _png(_pattern(16, 16, 9)))])  # the PNG of the same size wins
    elif variant == "refused":
        yield write_icns([(b"s8mk", b"\0" * 256)])  # a mask alone
        yield write_icns([(b"it32", b"\1\0\0\0" + b"\0" * 100)])
        yield write_icns([(b"ic11", _png(_pattern(20, 20, 1)))])  # 20 px in a 32 px entry
        yield write_icns([(b"is32", icns_rle(np.zeros((16, 16))))])  # one channel only
        yield write_icns([(b"icp4", b"GIF89a" + b"\0" * 20)])


@pytest.mark.parametrize("variant", ["pillow", "png", "jpeg2000", "legacy", "refused"])
def test_icns(variant):
    """Pillow's own ICNS (PNG entries up to 1024 px), small PNG and JPEG 2000
    entries, the legacy run-length and raw entries with their masks, the
    largest size chosen; and what Pillow refuses."""
    decoded = [_assert_same_outcome(d) for d in _icns_files(variant)]
    assert all(decoded) if variant != "refused" else not any(decoded)


# ---------------------------------------------------------------------------
# TIFF: CCITT fax (io/ccitt.py)
# ---------------------------------------------------------------------------


def _fax_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.int64)
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y : y + rng.integers(1, 8), x : x + rng.integers(1, max(2, w // 3))] ^= 1
    img[h // 2] = (rng.random(w) < 0.3).astype(np.int64)
    return img


@pytest.mark.parametrize("compression", ["group3", "group4", "tiff_ccitt"])
def test_tiff_ccitt_pillow(compression):
    """Pillow's (libtiff's) own fax files at widths from 1 to past 2560
    (extended make-up codes), in one strip and several."""
    for (h, w), seed in zip([(9, 1), (17, 77), (12, 1728), (6, 2600), (31, 200)], range(5)):
        img = (_fax_image(h, w, seed) * 255).astype(np.uint8)
        _assert_like_pil(_pil_save(img, "TIFF", "1", compression=compression))
        _assert_like_pil(_pil_save(np.random.default_rng(seed).integers(0, 2, (h, w)).astype(np.uint8) * 255,
                                   "TIFF", "1", compression=compression))


FAX_VARIANTS = {
    "mh": dict(compression=2), "mh_fill_order_2": dict(compression=2, fill_order=2),
    "t4_1d": dict(compression=3, t4options=0), "t4_1d_fill_bits": dict(compression=3, t4options=4),
    "t4_2d_k2": dict(compression=3, t4options=1, k=2), "t4_2d_k4_fill_bits": dict(compression=3, t4options=5, k=4),
    "t4_2d_rtc_fill_order_2": dict(compression=3, t4options=1, k=3, rtc=True, fill_order=2),
    "t4_uncompressed_option": dict(compression=3, t4options=3, k=2),
    "t6": dict(compression=4), "t6_eofb_fill_order_2": dict(compression=4, rtc=True, fill_order=2),
}


@pytest.mark.parametrize("variant", list(FAX_VARIANTS))
def test_tiff_ccitt_variants(variant):
    """The kinds Pillow cannot write (T.4's 2-D coding, fill bits, fill
    order 2, RTC and EOFB), photometric 0 and 1, one strip and several;
    Pillow's decode is the reference."""
    kw = dict(FAX_VARIANTS[variant])
    compression = kw.pop("compression")
    for (h, w), seed in zip([(11, 37), (20, 130), (3, 1)], range(3)):
        img = _fax_image(h, w, seed + 10)
        for photometric, rows in itertools.product((0, 1), (None, 4)):
            _assert_like_pil(fax_tiff(img, compression, photometric, rows_per_strip=rows, **kw))


def test_tiff_ccitt_code_tables_pinned():
    """Every run length's code held to the bits Pillow's modified Huffman
    writer (``tiff_ccitt``) puts in a row of two runs: each terminating
    code, each colour's make-up codes and the extended make-up codes."""
    runs = list(range(1, 64)) + [m + 5 for m in range(64, 2561, 64)]

    def code(r, table):
        make = r & ~63
        return ((ccitt.EXTENDED_CODES[make] if make > 1728 else table[make]) if make else "") + table[r & 63]

    for r in runs:
        for first, second in ((r, 1), (1, r)):
            row = np.array([255] * first + [0] * second, np.uint8)[None]
            data = _pil_save(row, "TIFF", "1", compression="tiff_ccitt")
            im = Image.open(io.BytesIO(data))
            (offset,), (count,), photometric = im.tag_v2[273], im.tag_v2[279], im.tag_v2[262]
            black = (row[0] == 0) if photometric == 0 else (row[0] != 0)  # the fax's black runs: its 1 bits
            edges = [0] + [i for i in range(1, len(black)) if black[i] != black[i - 1]] + [len(black)]
            lengths = ([0] if black[0] else []) + [b - a for a, b in zip(edges, edges[1:])]
            want = "".join(code(n, ccitt.BLACK_CODES if k % 2 else ccitt.WHITE_CODES) for k, n in enumerate(lengths))
            bits = "".join(f"{b:08b}" for b in data[offset : offset + count])
            assert bits.startswith(want) and set(bits[len(want):]) <= {"0"}, (first, second)
    assert len(ccitt.WHITE_CODES) == len(ccitt.BLACK_CODES) == 91 and len(ccitt.EXTENDED_CODES) == 13


# ---------------------------------------------------------------------------
# ZSTD (io/zstd.py) and ZSTD TIFF
# ---------------------------------------------------------------------------


def _content(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == "smooth":
        return (np.sin(np.arange(n) / 7.0) * 90 + 128 + rng.normal(0, 3, n)).clip(0, 255).astype(np.uint8).tobytes()
    if kind == "text":
        return (b"a quick brown fox jumps over the lazy dog; " * (n // 40 + 1))[:n]
    return np.repeat(rng.integers(0, 256, n // 40 + 1), 40)[:n].astype(np.uint8).tobytes()


_SKIPPABLE = b"\x5a\x2a\x4d\x18" + struct.pack("<I", 6) + b"abcdef"
ZSTD_CASES = {
    "empty": lambda: zstandard.ZstdCompressor().compress(b""),
    "raw_block": lambda: zstandard.ZstdCompressor(level=1).compress(_content("random", 5000)),
    "rle_block": lambda: zstandard.ZstdCompressor().compress(b"\x07" * 300000),
    **{f"level_{lv}_{k}": (lambda lv=lv, k=k, n=n: zstandard.ZstdCompressor(level=lv).compress(_content(k, n)))
       for lv, k, n in ((1, "smooth", 70000), (3, "text", 5000), (9, "runs", 20000), (19, "smooth", 3000),
                        (-5, "smooth", 9000))},
    "multi_block_checksum": lambda: zstandard.ZstdCompressor(level=5, write_checksum=True).compress(
        _content("smooth", 400000)),
    "no_content_size": lambda: zstandard.ZstdCompressor(write_content_size=False, write_checksum=True).compress(
        _content("text", 150000)),
    "frames_after_the_first": lambda: (zstandard.ZstdCompressor(level=7).compress(_content("runs", 90000))
                                       + _SKIPPABLE + zstandard.ZstdCompressor(level=3).compress(b"not read")),
    "skippable_first": lambda: _SKIPPABLE + zstandard.ZstdCompressor(level=3).compress(_content("smooth", 1000)),
    "streamed": lambda: _streamed(_content("smooth", 200000)),
}


def _streamed(data: bytes) -> bytes:
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    return cobj.compress(data) + cobj.flush()


@pytest.mark.parametrize("case", list(ZSTD_CASES))
def test_zstd_frames(case):
    """RFC 8878 frames as ``zstandard`` writes them (raw, RLE and compressed
    blocks, one and four Huffman streams, treeless literals, every table
    mode, repeat offsets, checksums) decode to what ``zstandard``'s
    one-frame decoder gives: the first frame's content, as libtiff reads a
    strip, and nothing for a skippable frame."""
    data = ZSTD_CASES[case]()
    want = zstandard.ZstdDecompressor().decompressobj().decompress(data)
    assert want == {"frames_after_the_first": _content("runs", 90000), "skippable_first": b""}.get(case, want)
    assert zstd.decode_zstd(data) == want


def test_zstd_refusals_and_xxh64():
    good = zstandard.ZstdCompressor(write_checksum=True).compress(_content("text", 3000))
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999 and zstd.xxh64(b"a" * 100) & 0xFFFFFFFF == int.from_bytes(
        zstandard.ZstdCompressor(write_checksum=True).compress(b"a" * 100)[-4:], "little")
    for bad in (good[:-1] + bytes([good[-1] ^ 1]), good[:-9], b"\x28\xb5\x2f\xfd\x08" + good[5:], b"not zstd"):
        with pytest.raises(ValueError, match="ZSTD"):
            zstd.decode_zstd(bad)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "I;16", "1", "P"])
def test_tiff_zstd_pillow(mode):
    img = _pattern(37, 29, 5, 4 if mode == "RGBA" else 3)
    if mode == "I;16":
        _assert_like_pil(_pil_save(img[:, :, 0].astype(np.uint16) * 3, "TIFF", compression="zstd"))
    else:
        _assert_like_pil(_pil_save(img, "TIFF", mode, compression="zstd"))


def test_tiff_zstd_writer():
    """The horizontal predictor, tiles, planes and big-endian files under
    ZSTD, and strips of several blocks."""
    rng = np.random.default_rng(9)
    _assert_like_pil(write_tiff(rng.integers(0, 256, (21, 23, 3)), 8, 2, "<", 50000, predictor=2, rows_per_strip=5))
    _assert_like_pil(write_tiff(rng.integers(0, 65536, (13, 17, 3)), 16, 2, ">", 50000, predictor=2))
    _assert_like_pil(write_tiff(rng.integers(0, 256, (20, 37, 3)), 8, 2, "<", 50000, tile=(16, 16)))
    _assert_like_pil(write_tiff(rng.integers(0, 256, (13, 19, 3)), 8, 2, "<", 50000, planar=2, rows_per_strip=4))
    big = np.concatenate([_pattern(300, 300, 1), rng.integers(0, 256, (300, 300, 3)).astype(np.uint8)], 0)
    _assert_like_pil(_pil_save(big, "TIFF", compression="zstd"))


# ---------------------------------------------------------------------------
# TIFF: YCbCr outside JPEG (libtiff's RGBA interface)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma", "zstd", "raw"])
def test_tiff_ycbcr_pillow(compression):
    """Pillow's own YCbCr TIFFs (1 × 1); the uncompressed one Pillow refuses
    as truncated, and so does the port."""
    img = _pattern(23, 31, 6)
    data = _pil_save(img, "TIFF", "YCbCr", compression=compression)
    assert _assert_same_outcome(data) == (compression != "raw")


@pytest.mark.parametrize("sub", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiff_ycbcr_subsampled(sub):
    """Each subsampling libtiff's RGBA interface puts, in strips (4 × 4 loses
    a strip's last bytes where its units are an odd number across) and in
    tiles (4 × 4 takes 4 × 2's skip past the right edge), under each codec,
    with ReferenceBlackWhite, YCbCrCoefficients and YCbCrPositioning."""
    rng = np.random.default_rng(sub[0] * 4 + sub[1])
    tags = [{}, {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]), 531: (3, [2])},
            {529: (5, [2126, 10000, 7152, 10000, 722, 10000]), 532: (5, [0, 1, 255, 1, 100, 1, 200, 1, 60, 1, 255, 1])}]
    for (h, w), compression, extra in zip([(13, 19), (16, 16), (5, 3), (9, 22), (17, 9)], [8, 5, 32773, 34925, 50000],
                                          itertools.cycle(tags)):
        ycc = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        _assert_like_pil(ycbcr_tiff(ycc, sub, compression, rows_per_strip=sub[1] * 2, extra_tags=extra))
        _assert_like_pil(ycbcr_tiff(ycc, sub, compression, tile=(16, 16), extra_tags=extra))


def test_tiff_ycbcr_every_chroma_pair():
    """``TIFFYCbCrToRGBInit``'s tables matched entry by entry: every (Cb, Cr)
    pair at five luma values, and every luma value, through Pillow's own
    Deflate YCbCr files."""
    cbcr = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    for y in (0, 16, 128, 235, 255):
        ycc = np.concatenate([np.full((256, 256, 1), y), cbcr], -1).astype(np.uint8)
        _assert_like_pil(_ycc_file(ycc))
    luma = np.stack([np.arange(256)[None].repeat(3, 0), np.full((3, 256), 90), np.full((3, 256), 200)], -1)
    _assert_like_pil(_ycc_file(luma.astype(np.uint8)))


def _ycc_file(ycc: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(ycc, "YCbCr").save(buf, "TIFF", compression="tiff_adobe_deflate")
    return buf.getvalue()


def test_tiff_ycbcr_planes_predictor_and_refusals():
    rng = np.random.default_rng(12)
    ycc = rng.integers(0, 256, (7, 9, 3))
    _assert_like_pil(write_tiff(ycc, 8, 6, "<", 5, planar=2, extra_tags={530: (3, [1, 1])}))
    _assert_like_pil(write_tiff(ycc, 8, 6, ">", 8, predictor=2, extra_tags={530: (3, [1, 1])}))
    zero_green = {529: (5, [1, 3, 0, 1, 1, 3])}  # YCbCrCoefficients with LumaGreen 0
    for bad in (write_tiff(ycc, 8, 6, "<", 8, extra_tags={530: (3, [3, 3])}), write_tiff(ycc[..., :1], 8, 6, "<", 5),
                ycbcr_tiff(ycc.astype(np.uint8), (2, 2), 8, rows_per_strip=4, extra_tags=zero_green)):
        assert not _assert_same_outcome(bad)
    with pytest.raises(ValueError, match="queue 1, item 14"):
        decode_rgb(_pil_save(_pattern(5, 6, 1), "TIFF", "LAB"))


# ---------------------------------------------------------------------------
# identification: IMT and SPIDER in Pillow's order
# ---------------------------------------------------------------------------


def test_imt_and_spider_refused_in_pillows_place():
    """IM Tools (after IM) and SPIDER (after SGI) have no ``_accept``: their
    ``_open`` decides, and the port asks what it asks. Pillow identifies
    these files as IMT and SPIDER; the port refuses them citing item 14,
    not with the generic message, and a file that only looks like them
    goes on to the next format."""
    imt = b"width 4\nheight 3\npixel n8\n\x0c" + bytes(range(12))
    spider = _pil_save(np.arange(12, dtype=np.float32).reshape(3, 4), "SPIDER")
    for data, fmt in ((imt, "IMT"), (spider, "SPIDER")):
        assert Image.open(io.BytesIO(data)).format == fmt
        with pytest.raises(ValueError, match=rf"{fmt} is not supported \(ROADMAP.md queue 1, item 14\)"):
            decode_rgb(data)
    # a newline but no size: not IM Tools (Pillow then finds no format at all)
    with pytest.raises(ValueError, match="not an image format the port identifies"):
        decode_rgb(b"width 0\nheight 3\npixel n8\n" + b"\x01" * 40)


# ---------------------------------------------------------------------------
# the CLIP scorer over a folder of every new format
# ---------------------------------------------------------------------------


def _new_format_files() -> dict:
    rng = np.random.default_rng(21)
    img = _pattern(40, 48, 22)
    head, scan = split_jpeg(_pil_save(img, "JPEG", quality=90))
    fax = (_fax_image(40, 48, 3) * 255).astype(np.uint8)
    return {
        "pcx": _pil_save(img, "PCX"), "dcx": write_dcx([_pil_save(img, "PCX", "P")]), "sgi": _pil_save(img, "SGI"),
        "dds": _pil_save(img, "DDS", "RGB", pixel_format="BC5"),
        "bc7.dds": write_dds(48, 40, rng.integers(0, 256, 120 * 16).astype(np.uint8).tobytes(), dxgi="BC7"),
        "ftex": write_ftex(48, 40, img.tobytes(), 1), "blp": write_blp(1, 48, 40, scan, 0, 5, jpeg_header=head),
        "icns": write_icns([(b"il32", b"".join(icns_rle(_pattern(32, 32, 4)[:, :, c]) for c in range(3)))]),
        "g4.tif": _pil_save(fax, "TIFF", "1", compression="group4"),
        "zstd.tif": _pil_save(img, "TIFF", compression="zstd"),
        "ycbcr.tif": ycbcr_tiff(img, (2, 2), 8, rows_per_strip=8),
    }


def test_clip_scorer_reads_every_new_format(tmp_path):
    """``eval/clip_score.py`` (which reads every file of a folder, whatever
    its extension) over one file of each new format gives the CSV it gives
    over the same pixels saved as PNG; tiny seeded CLIP weights."""
    from transformers import CLIPConfig, CLIPModel

    from sliders_conceptmod_tpu_torch.eval import clip_score as tclip_cli

    model_dir = tmp_path / "clip"
    cfg = CLIPConfig(text_config={"vocab_size": 49408, "hidden_size": 32, "intermediate_size": 64,
                                  "num_hidden_layers": 2, "num_attention_heads": 4, "max_position_embeddings": 77,
                                  "eos_token_id": 49407, "bos_token_id": 49406, "pad_token_id": 0,
                                  "hidden_act": "quick_gelu"},
                     vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                                    "num_attention_heads": 4, "image_size": 32, "patch_size": 16,
                                    "hidden_act": "quick_gelu"}, projection_dim=16)
    torch.manual_seed(0)
    CLIPModel(cfg).save_pretrained(str(model_dir), safe_serialization=True)
    files = _new_format_files()
    csvs = []
    for kind in ("native", "png"):
        root = tmp_path / kind
        (root / "1.0").mkdir(parents=True)
        for case, (name, data) in enumerate(sorted(files.items())):
            if kind == "png":
                name, data = "png", _pil_save(_pil_rgb(data), "PNG")
            (root / "1.0" / f"{case}_0.{name}").write_bytes(data)
        prompts = root / "prompts.csv"
        prompts.write_text("case_number,prompt,evaluation_seed\n"
                           + "".join(f"{c},a photo,{c}\n" for c in range(len(files))))
        out = tclip_cli.run(tclip_cli.build_parser().parse_args(
            ["--im_path", str(root), "--prompts_path", str(prompts), "--prompt", "a photo", "--clip_model",
             str(model_dir), "--device", "cpu", "--batch_size", "4"]))
        with open(out, newline="") as f:
            csvs.append(list(csv.reader(f)))
    assert csvs[0] == csvs[1] and len(csvs[0]) == len(files) + 1 and all(r[-1] not in ("", "nan") for r in csvs[0][1:])


def test_new_formats_in_the_fixtures():
    """Every committed fixture of this slice's kinds is identified as Pillow
    identifies it (the digests themselves are checked by
    ``test_torch_image_decode.py``)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "image_decode")
    kinds = {"pcx": "PCX", "dcx": "DCX", "sgi": "SGI", "dds": "DDS", "ftc": "FTEX", "blp": "BLP", "icns": "ICNS"}
    seen = set()
    for name in sorted(os.listdir(root)):
        ext = name.rsplit(".", 1)[-1]
        if ext in kinds:
            with open(os.path.join(root, name), "rb") as f:
                assert Image.open(f).format == kinds[ext], name
            seen.add(ext)
    assert seen == set(kinds)
