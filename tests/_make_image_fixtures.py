"""Writes ``tests/data/image_decode/``: small files of every kind the port
decodes (``io/image.py``: JPEG, PNG, WebP, GIF, BMP, TIFF, JPEG 2000,
PBM/PGM/PPM, TGA, ICO/CUR, PSD, QOI, PCX/DCX, SGI, DDS, FTEX, BLP, ICNS;
TIFF's CCITT, ZSTD and YCbCr kinds), the four
folders of an image-pair bank (``bank/{minus2,minus1,plus1,plus2}``, scales
−2, −1, 1, 2: two JPEGs, a lossy and a lossless WebP each), and
``digests.json``: the SHA-256 of Pillow's ``convert("RGB")`` of each file
with its shape, which ``chip_smoke.py`` holds the port's decode to on a
machine without Pillow. Pillow writes what it can (baseline and progressive
JPEG at 4:4:4, 4:2:2 and 4:2:0, grey, restart markers, an Adobe RGB file,
CMYK, WebP, GIF; JPEG 2000 reversible and irreversible, tiled, at several
resolutions, in each progression order, with small code-blocks and
precincts and several layers; TGA, PPM/PGM/PBM, ICO, QOI; TIFF with JPEG,
LZMA and CMYK); ``_jpeg_writer``, ``_png_writer``, ``_image_writers`` and
``_webp_encoder`` (libwebp's own encoder, for the simple loop filter and
token partitions) write the rest (PSD, CUR, BigTIFF, 16-bit, planar and
YCbCr-JPEG TIFF, 15/16-bit and colour-mapped TGA, plain PNM and odd
maxvals, JP2 boxes for sYCC and palettes, subsampled lossless JPEG, T.4
2-D and T.6 fax rows, subsampled YCbCr units, ZSTD frames libtiff does not
write, PCX bit planes, DCX, SGI run-length rows, DDS BC4/BC6H/BC7 and
masks, FTEX, BLP JPEG and DXT, ICNS legacy entries). The two timing files
added with them: a 512x512 RGB ZSTD TIFF in one strip (several blocks) and
a 1728-pixel-wide Group 4 page.

    python tests/_make_image_fixtures.py
"""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _image_writers import (fax_tiff, icns_rle, icon_dib, jp2_wrap, jpeg_tiff, pcx_planes, split_jpeg,  # noqa: E402
                            write_blp, write_bmp, write_dcx, write_dds, write_ftex, write_gif, write_icns, write_icon,
                            write_pcx, write_psd, write_sgi, write_tga, write_tiff, ycbcr_tiff)
from _jpeg_writer import write_jpeg, write_jpeg_arithmetic, write_jpeg_lossless  # noqa: E402
from _png_writer import write_png  # noqa: E402
from _webp_encoder import encode_lossy  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "image_decode")
# three 512x512 files whose decode chip_smoke.py times on the card's host: a lossy WebP, a 4:2:0 JPEG and an
# irreversible JPEG 2000 (OpenJPEG's defaults)
OUT_TIMING = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "image_decode_timing")
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


def pil_save(img: np.ndarray, fmt: str, mode: str = None, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, fmt, **kw)
    return buf.getvalue()


def webp_first_frame_offset(frame: bytes, x: int, y: int, canvas: tuple) -> bytes:
    """An animated WebP whose only frame (a simple file's bitstream chunk)
    sits at (2x, 2y) on a larger canvas."""
    def chunk(tag, payload):
        return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)

    def u24(v):
        return struct.pack("<I", v)[:3]

    img = Image.open(io.BytesIO(frame))
    anmf = u24(x) + u24(y) + u24(img.width - 1) + u24(img.height - 1) + u24(100) + b"\0" + frame[12:]
    body = (chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + u24(canvas[0] - 1) + u24(canvas[1] - 1))
            + chunk(b"ANIM", b"\xff\xff\xff\xff\0\0") + chunk(b"ANMF", anmf))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


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
    rgba = np.concatenate([pattern(33, 47, 11), rng.integers(0, 256, (33, 47, 1)).astype(np.uint8)], -1)
    pal16 = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    out.update({
        "webp_lossy_q80.webp": pil_save(pattern(40, 56, 12), "WEBP", quality=80),
        "webp_lossy_alpha.webp": pil_save(rgba, "WEBP", quality=60, alpha_quality=50),
        "webp_lossless.webp": pil_save(pattern(37, 29, 13), "WEBP", lossless=True),
        "webp_lossless_palette16.webp": pil_save(pal16[rng.integers(0, 16, (21, 35))], "WEBP", lossless=True),
        "webp_anim_offset.webp": webp_first_frame_offset(pil_save(pattern(13, 11, 14), "WEBP", quality=70), 3, 2,
                                                         (30, 24)),
        "webp_simple_filter_4parts.webp": encode_lossy(pattern(48, 40, 15), 50, simple_filter=True, partitions=2),
        "arithmetic_420.jpg": write_jpeg_arithmetic(pattern(37, 45, 16)),
        "arithmetic_progressive_restart.jpg": write_jpeg_arithmetic(pattern(40, 32, 17), progressive=True, restart=3),
        "cmyk.jpg": pil_save(pattern(29, 35, 18), "JPEG", "CMYK", quality=85),
        "ycck.jpg": write_jpeg(np.concatenate([pattern(31, 27, 19), rng.integers(0, 256, (31, 27, 1))], -1),
                               ((2, 2), (1, 1), (1, 1), (2, 2)), adobe_transform=2, jfif=False, ids=(1, 2, 3, 4)),
        "lossless_p4.jpg": write_jpeg_lossless(pattern(19, 23, 20), predictor=4),
        "gif_interlaced_offset_transparent.gif": write_gif(rng.integers(0, 16, (21, 17)), screen=(30, 28),
                                                           offset=(5, 4), local_palette=rng.integers(0, 256, (16, 3)),
                                                           transparency=3, interlace=True, min_size=4),
        "gif_pillow.gif": pil_save(pattern(33, 41, 21), "GIF"),
        "bmp_rle8.bmp": write_bmp(rng.integers(0, 4, (19, 29)), 8, 40, palette=rng.integers(0, 256, (256, 3)),
                                  compression=1),
        "bmp_rle4.bmp": write_bmp(rng.integers(0, 3, (13, 23)), 4, 108, palette=rng.integers(0, 256, (16, 3)),
                                  compression=2),
        "bmp_24_top_down.bmp": write_bmp(pattern(17, 21, 22)[:, :, ::-1], 24, 124, top_down=True),
        "bmp_16_bitfields.bmp": write_bmp(rng.integers(0, 65536, (15, 19)), 16, 56, compression=3,
                                          masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_os2_4bit.bmp": write_bmp(rng.integers(0, 16, (11, 13)), 4, 12, palette=rng.integers(0, 256, (16, 3))),
        "tiff_lzw_predictor_mm.tif": write_tiff(pattern(27, 33, 23), 8, 2, ">", 5, predictor=2, rows_per_strip=8),
        "tiff_tiled_packbits.tif": write_tiff(pattern(40, 37, 24), 8, 2, "<", 32773, tile=(16, 16)),
        "tiff_palette4_deflate.tif": write_tiff(rng.integers(0, 16, (17, 23, 1)), 4, 3, "<", 8,
                                                colormap=rng.integers(0, 65536, (16, 3))),
        "tiff_1bit_white_is_zero.tif": write_tiff(rng.integers(0, 2, (19, 21, 1)), 1, 0, ">", 1),
        "tiff_rgba_associated.tif": write_tiff(np.concatenate([pattern(15, 17, 25), rng.integers(0, 256, (15, 17, 1))],
                                                              -1), 8, 2, "<", 32946, predictor=2, extra_samples=(1,)),
    })
    out.update(pillow_formats(rng))
    out.update(more_formats(np.random.default_rng(26)))
    for i, folder in enumerate(BANK_FOLDERS):  # the same four images a brightness step apart per folder
        for j, kw in enumerate((dict(quality=90), dict(quality=90, progressive=True))):
            img = np.clip(pattern(96, 96, 20 + j).astype(int) + 30 * (i - 1.5), 0, 255).astype(np.uint8)
            out[f"bank/{folder}/{j:03d}.jpg"] = pil_jpeg(img, **kw)
        for j, kw in ((2, dict(quality=90)), (3, dict(lossless=True))):
            img = np.clip(pattern(96, 96, 20 + j).astype(int) + 30 * (i - 1.5), 0, 255).astype(np.uint8)
            out[f"bank/{folder}/{j:03d}.webp"] = pil_save(img, "WEBP", **kw)
    return out


def pillow_formats(rng) -> dict:
    """The formats of ROADMAP item 14 the port reads since: JPEG 2000,
    PBM/PGM/PPM, TGA, ICO/CUR, PSD, QOI, and the TIFF and lossless-JPEG
    kinds beyond the first TIFF reader's."""
    rgba = np.concatenate([pattern(23, 29, 40), rng.integers(0, 256, (23, 29, 1)).astype(np.uint8)], -1)
    grey16 = Image.fromarray(pattern(19, 21, 41)[:, :, 0].astype(np.uint16) * 37 + 100)
    j2k_grey = io.BytesIO()
    Image.fromarray(pattern(21, 19, 42)[:, :, 0]).save(j2k_grey, "JPEG2000", no_jp2=True, irreversible=True)
    j2k_i16 = io.BytesIO()
    grey16.save(j2k_i16, "JPEG2000")
    rgb_cs = io.BytesIO()
    Image.fromarray(pattern(17, 23, 43)).save(rgb_cs, "JPEG2000", no_jp2=True)
    idx_cs = io.BytesIO()
    Image.fromarray(rng.integers(0, 12, (15, 18)).astype(np.uint8)).save(idx_cs, "JPEG2000", no_jp2=True)
    cur_entries = [(icon_dib(rng.integers(0, 16, (16, 16)), 4, rng.integers(0, 256, (16, 3)),
                             rng.integers(0, 2, (16, 16))), 16, 16, 0, 4),
                   (icon_dib(pattern(24, 24, 44)[:, :, ::-1], 24, mask=rng.integers(0, 2, (24, 24))), 24, 24, 0, 24)]
    ico_bmp = io.BytesIO()
    Image.fromarray(rgba).save(ico_bmp, "ICO", sizes=[(16, 16), (23, 23)], bitmap_format="bmp")
    tiff16 = pattern(13, 17, 45).astype(np.int64) * 257 + rng.integers(0, 257, (13, 17, 3))
    return {
        "j2k_rgb_reversible.jp2": pil_save(pattern(33, 27, 46), "JPEG2000"),
        "j2k_rgb_irreversible_tiles_rpcl.jp2": pil_save(pattern(37, 41, 47), "JPEG2000", irreversible=True,
                                                        tile_size=(16, 16), progression="RPCL", num_resolutions=3),
        "j2k_pcrl_codeblock4_precinct16.j2k": pil_save(pattern(29, 31, 48), "JPEG2000", no_jp2=True,
                                                       progression="PCRL", codeblock_size=(4, 4),
                                                       precinct_size=(16, 16), num_resolutions=3),
        "j2k_cprl_layers_offset.j2k": pil_save(pattern(27, 35, 49), "JPEG2000", no_jp2=True, irreversible=True,
                                               progression="CPRL", quality_mode="rates",
                                               quality_layers=[40, 20, 8], tile_size=(16, 16), tile_offset=(3, 5),
                                               offset=(7, 9)),
        "j2k_rlcp_rgba.jp2": pil_save(rgba, "JPEG2000", progression="RLCP", num_resolutions=2),
        "j2k_grey_irreversible.j2k": j2k_grey.getvalue(),
        "j2k_grey16.jp2": j2k_i16.getvalue(),
        "j2k_sycc.jp2": jp2_wrap(rgb_cs.getvalue(), 3, 8, 17, 23, enumcs=18),
        "j2k_palette.jp2": jp2_wrap(idx_cs.getvalue(), 1, 8, 15, 18, palette=rng.integers(0, 256, (12, 3))),
        "tga_rgb_rle.tga": pil_save(pattern(19, 23, 50), "TGA", compression="tga_rle"),
        "tga_rgba.tga": pil_save(rgba, "TGA"),
        "tga_palette_rle.tga": pil_save(pattern(17, 21, 51), "TGA", "P", compression="tga_rle"),
        "tga_grey.tga": pil_save(pattern(13, 15, 52), "TGA", "L"),
        "tga_16bit_top_mirrored_rle.tga": write_tga(rng.integers(0, 65536, (11, 14)), 10, 16, top=True,
                                                    mirror=True),
        "tga_map16_rle_rows.tga": write_tga(rng.integers(0, 9, (12, 10)), 9, 8, rng.integers(0, 65536, 9), 16,
                                            map_start=2, cross_rows=False),
        "ppm_binary.ppm": pil_save(pattern(17, 19, 53), "PPM"),
        "pgm_binary.pgm": pil_save(pattern(13, 17, 54), "PPM", "L"),
        "pbm_binary.pbm": pil_save(pattern(15, 21, 55), "PPM", "1"),
        "pgm_plain_maxval7.pgm": b"P2\n# a comment\n5 3\n7\n" + " ".join(
            str(v) for v in rng.integers(0, 8, 15)).encode() + b"\n",
        "ppm_plain.ppm": b"P3 4 2 255\n" + " ".join(str(v) for v in rng.integers(0, 256, 24)).encode() + b"\n",
        "pbm_plain.pbm": b"P1\n6 3\n" + "".join(str(v) for v in rng.integers(0, 2, 18)).encode(),
        "pgm_maxval1000.pgm": b"P5 7 5 1000\n" + rng.integers(0, 1001, 35).astype(">u2").tobytes(),
        "ppm_maxval300.ppm": b"P6 5 4 300\n" + rng.integers(0, 301, 60).astype(">u2").tobytes(),
        "ico_png.ico": pil_save(rgba, "ICO", sizes=[(16, 16), (23, 23)]),
        "ico_bmp.ico": ico_bmp.getvalue(),
        "cursor.cur": write_icon(cur_entries, cursor=True),
        "psd_rgb_packbits.psd": write_psd(pattern(14, 19, 56).transpose(2, 0, 1), 3, compression=1),
        "psd_rgba_raw.psd": write_psd(rgba.transpose(2, 0, 1), 3),
        "psd_cmyk_packbits.psd": write_psd(rng.integers(0, 256, (4, 9, 13)), 4, compression=1),
        "psd_indexed.psd": write_psd(rng.integers(0, 256, (1, 8, 11)), 2, palette=rng.integers(0, 256, (256, 3))),
        "psd_bitmap.psd": write_psd(rng.integers(0, 2, (1, 9, 13)), 0, bits=1, compression=1),
        "qoi_rgb.qoi": pil_save(pattern(21, 25, 57), "QOI"),
        "qoi_rgba.qoi": pil_save(rgba, "QOI"),
        "tiff_jpeg_pillow.tif": pil_save(pattern(24, 32, 58), "TIFF", compression="jpeg"),
        "tiff_ycbcr_jpeg_420_tables.tif": jpeg_tiff(pattern(37, 45, 59), rows_per_strip=16),
        "tiff_lzma_cmyk.tif": pil_save(pattern(15, 17, 60), "TIFF", "CMYK", compression="lzma"),
        "tiff_bigtiff_tiled.tif": write_tiff(pattern(21, 23, 61), 8, 2, "<", 8, tile=(16, 16), bigtiff=True),
        "tiff_rgb16_mm_predictor.tif": write_tiff(tiff16, 16, 2, ">", 5, predictor=2, rows_per_strip=5),
        "tiff_grey16.tif": pil_save(np.asarray(grey16), "TIFF"),
        "tiff_planar_deflate.tif": write_tiff(pattern(13, 19, 62), 8, 2, "<", 8, planar=2, rows_per_strip=4),
        "lossless_420.jpg": write_jpeg_lossless(pattern(19, 23, 63), 1, 0, ((2, 2), (1, 1), (1, 1))),
    }


def fax_page(h: int, w: int, seed: int) -> np.ndarray:
    """A fax-like page, 0/1 (1 black): lines of glyphs of a few strokes
    each, with margins, and a ruled box."""
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), np.uint8)
    for top in range(h // 12, h - h // 12 - 20, 28):
        x = w // 12
        while x < w - w // 12 - 20:
            gw = int(rng.integers(8, 18))
            if rng.random() < 0.85:  # a glyph of two to four strokes
                for _ in range(int(rng.integers(2, 5))):
                    if rng.random() < 0.5:
                        c = int(rng.integers(0, gw - 2))
                        page[top + int(rng.integers(0, 6)) : top + 20, x + c : x + c + 2] = 1
                    else:
                        r = int(rng.integers(0, 18))
                        page[top + r : top + r + 2, x : x + gw] = 1
            x += gw + int(rng.integers(2, 6))
    page[h // 20 : h // 20 + 3, w // 12 : -w // 12] = 1
    page[h // 20 : -h // 20, w // 12 : w // 12 + 3] = 1
    return page


def more_formats(rng) -> dict:
    """The kinds of the slice of the image formats Pillow writes that the
    port decoded last: TIFF's CCITT, ZSTD and YCbCr; PCX/DCX, SGI, DDS
    (BC1–BC7), ICNS, BLP, FTEX."""
    import zstandard

    img = pattern(19, 23, 70)
    rgba = np.concatenate([pattern(17, 21, 71), rng.integers(0, 256, (17, 21, 1)).astype(np.uint8)], -1)
    idx = rng.integers(0, 16, (11, 13))
    fax = fax_page(40, 61, 72)
    # a checksummed frame of the strip, then a skippable frame and another frame, which libtiff does not read
    zframes = (zstandard.ZstdCompressor(level=3, write_checksum=True).compress(img.tobytes())
               + b"\x50\x2a\x4d\x18" + struct.pack("<I", 4) + b"skip"
               + zstandard.ZstdCompressor(level=19, write_content_size=False).compress(img[10:].tobytes()))
    head, scan = split_jpeg(pil_jpeg(pattern(16, 24, 73), quality=85))

    def blocks(n, size):
        return rng.integers(0, 256, n * size).astype(np.uint8).tobytes()

    return {
        "tiff_group3.tif": pil_save(fax * 255, "TIFF", "1", compression="group3"),
        "tiff_group4.tif": pil_save(fax * 255, "TIFF", "1", compression="group4"),
        "tiff_ccitt_rle.tif": pil_save(fax * 255, "TIFF", "1", compression="tiff_ccitt"),
        "tiff_t4_2d_fill_bits_fill_order_2.tif": fax_tiff(fax, 3, 0, rows_per_strip=16, fill_order=2,
                                                          t4options=5, k=4, rtc=True),
        "tiff_t6_white_is_zero.tif": fax_tiff(fax, 4, 0, rows_per_strip=24),
        "tiff_zstd.tif": pil_save(img, "TIFF", compression="zstd"),
        "tiff_zstd_predictor.tif": write_tiff(pattern(13, 17, 74), 8, 2, ">", 50000, predictor=2, rows_per_strip=5),
        "tiff_zstd_frames_checksum_skippable.tif": write_tiff(img, 8, 2, "<", 50000, pieces=[zframes]),
        "tiff_ycc_lzw.tif": pil_save(img, "TIFF", "YCbCr", compression="tiff_lzw"),
        "tiff_ycc_422_deflate.tif": ycbcr_tiff(pattern(13, 19, 75), (2, 1), 8, rows_per_strip=4),
        "tiff_ycc_420_tiles_refbw.tif": ycbcr_tiff(pattern(21, 19, 76), (2, 2), 5, tile=(16, 16),
                                                     extra_tags={532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1,
                                                                           240, 1])}),
        "tiff_ycc_44_odd_units.tif": ycbcr_tiff(pattern(9, 11, 77), (4, 4), 32773, rows_per_strip=4),
        "pcx_rgb_odd.pcx": pil_save(img, "PCX"),
        "pcx_palette.pcx": pil_save(img, "PCX", "P"),
        "pcx_1bit.pcx": pil_save(img, "PCX", "1"),
        "pcx_grey.pcx": pil_save(img, "PCX", "L"),
        "pcx_4_planes.pcx": write_pcx(pcx_planes(idx, 4, 2), 13, 1, 4, palette16=rng.integers(0, 256, (16, 3))),
        "dcx_first.dcx": write_dcx([pil_save(pattern(9, 14, 78), "PCX", "P"), pil_save(img, "PCX")]),
        "sgi_rgb_raw.sgi": pil_save(img, "SGI"),
        "sgi_rgba_16bit_rle.sgi": write_sgi(rgba.transpose(2, 0, 1).astype(np.int64) * 257, 2, True),
        "sgi_grey_rle.sgi": write_sgi(img[None, :, :, 0].astype(np.int64), 1, True),
        "dds_rgb.dds": pil_save(img, "DDS"),
        "dds_luminance_alpha.dds": pil_save(rgba, "DDS", "LA"),
        "dds_dxt1.dds": pil_save(rgba, "DDS", pixel_format="DXT1"),
        "dds_dxt5.dds": pil_save(rgba, "DDS", pixel_format="DXT5"),
        "dds_bc5.dds": pil_save(img, "DDS", pixel_format="BC5"),
        "dds_bc4_ati1.dds": write_dds(21, 17, blocks(30, 8), fourcc=b"ATI1"),
        "dds_bc6h.dds": write_dds(21, 17, blocks(30, 16), dxgi="BC6H"),
        "dds_bc6h_signed.dds": write_dds(21, 17, blocks(30, 16), dxgi="BC6HS"),
        "dds_bc7.dds": write_dds(21, 17, blocks(30, 16), dxgi="BC7"),
        "dds_565.dds": write_dds(13, 11, blocks(143, 2), pfflags=0x40, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
        "dds_palette.dds": write_dds(13, 11, blocks(143, 1), pfflags=0x20, bitcount=8,
                                     palette=rng.integers(0, 256, (256, 4))),
        "ftex_dxt1.ftc": write_ftex(21, 17, blocks(30, 8), 0),
        "ftex_rgb.ftu": write_ftex(23, 19, img.tobytes(), 1),
        "blp1_palette.blp": pil_save(img, "BLP", "P", blp_version="BLP1"),
        "blp2_palette.blp": pil_save(img, "BLP", "P"),
        "blp1_jpeg.blp": write_blp(1, 24, 16, scan, 0, 5, jpeg_header=head),
        "blp2_dxt1_alpha.blp": write_blp(2, 21, 17, blocks(30, 8), 1, 2, 1, 0),
        "blp2_dxt3.blp": write_blp(2, 20, 16, blocks(20, 16), 1, 2, 8, 1),
        "blp2_dxt5_no_alpha.blp": write_blp(2, 21, 17, blocks(30, 16), 1, 2, 0, 7),
        "icns_png.icns": write_icns([(b"icp4", pil_save(pattern(16, 16, 79), "PNG")),
                                     (b"ic11", pil_save(pattern(32, 32, 80), "PNG"))]),
        "icns_legacy_rle_mask.icns": write_icns(
            [(b"is32", b"".join(icns_rle(pattern(16, 16, 81)[:, :, c]) for c in range(3))),
             (b"s8mk", rng.integers(0, 256, 256).astype(np.uint8).tobytes()),
             (b"il32", b"".join(icns_rle(np.repeat(pattern(8, 8, 82), 4, 0).repeat(4, 1)[:, :, c]) for c in range(3))),
             (b"l8mk", rng.integers(0, 256, 1024).astype(np.uint8).tobytes())]),
        "icns_jpeg2000.icns": write_icns([(b"icp4", pil_save(pattern(16, 16, 83), "JPEG2000"))]),
    }


def timing_files() -> dict:
    img = pattern(512, 512, 30)
    return {"webp_lossy_q90_512.webp": pil_save(img, "WEBP", quality=90),
            "jpeg_420_q90_512.jpg": pil_jpeg(img, quality=90, subsampling=2),
            "j2k_irreversible_512.jp2": pil_save(img, "JPEG2000", irreversible=True),
            "tiff_zstd_rgb_512.tif": pil_save(img, "TIFF", compression="zstd", strip_size=1 << 20),
            "tiff_group4_1728.tif": pil_save(fax_page(1100, 1728, 31) * 255, "TIFF", "1", compression="group4")}


def write(out_dir: str, table: dict) -> None:
    digests = {}
    for name, data in table.items():
        path = os.path.join(out_dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        digests[name] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


def main() -> None:
    write(OUT, files())
    write(OUT_TIMING, timing_files())


if __name__ == "__main__":
    main()
