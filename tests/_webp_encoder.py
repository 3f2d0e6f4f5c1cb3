"""libwebp's own lossy encoder, called through ctypes in the libwebp that
Pillow bundles (``pillow.libs``), for the VP8 options Pillow's ``save``
does not expose: the simple loop filter, 2–8 token partitions, the filter
strength and sharpness, and the segment count. Pillow then decodes the
files, as it decodes any WebP. Test-side only."""

import ctypes
import glob
import os

import numpy as np
import PIL

_ABI = 0x0210  # WEBP_ENCODER_ABI_VERSION of libwebp 1.5–1.6 (only its major byte is checked)
# int offsets into WebPConfig (encode.h)
_METHOD, _SEGMENTS, _FILTER_STRENGTH, _SHARPNESS, _FILTER_TYPE, _AUTOFILTER, _PARTITIONS = 2, 6, 8, 9, 10, 11, 18
# pointer offsets into WebPPicture: the writer and its custom pointer; int offsets: width, height
_WRITER, _CUSTOM, _WIDTH, _HEIGHT = 12, 13, 2, 3


def _library():
    libdir = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    for dep in glob.glob(os.path.join(libdir, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    (path,) = glob.glob(os.path.join(libdir, "libwebp-*.so*"))
    lib = ctypes.CDLL(path)
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    for name, args, res in [("WebPConfigInitInternal", [vp, c_int, ctypes.c_float, c_int], c_int),
                            ("WebPValidateConfig", [vp], c_int), ("WebPPictureInitInternal", [vp, c_int], c_int),
                            ("WebPPictureImportRGB", [vp, vp, c_int], c_int), ("WebPMemoryWriterInit", [vp], None),
                            ("WebPEncode", [vp, vp], c_int), ("WebPPictureFree", [vp], None),
                            ("WebPMemoryWriterClear", [vp], None)]:
        getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    return lib


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 1)]


def encode_lossy(rgb: np.ndarray, quality: float = 75.0, simple_filter: bool = False, partitions: int = 0,
                 method: int = 0, filter_strength=None, sharpness: int = 0, segments: int = 4) -> bytes:
    """uint8 ``[H, W, 3]`` → a simple-format lossy WebP file. Partitions
    (log2 of their count) take effect at methods 0–2."""
    lib = _library()
    h, w, _ = rgb.shape
    config = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(config, 0, ctypes.c_float(quality), _ABI):
        raise RuntimeError("WebPConfigInit failed")
    config[_METHOD], config[_FILTER_TYPE], config[_PARTITIONS] = method, 0 if simple_filter else 1, partitions
    config[_SHARPNESS], config[_SEGMENTS] = sharpness, segments
    if filter_strength is not None:
        config[_FILTER_STRENGTH], config[_AUTOFILTER] = filter_strength, 0
    if not lib.WebPValidateConfig(config):
        raise ValueError("invalid WebP config")
    picture = (ctypes.c_uint8 * 512)()
    if not lib.WebPPictureInitInternal(picture, _ABI):
        raise RuntimeError("WebPPictureInit failed")
    ints = ctypes.cast(picture, ctypes.POINTER(ctypes.c_int32))
    ints[_WIDTH], ints[_HEIGHT] = w, h
    pixels = np.ascontiguousarray(rgb, np.uint8)
    if not lib.WebPPictureImportRGB(picture, pixels.ctypes.data_as(ctypes.c_void_p), 3 * w):
        raise RuntimeError("WebPPictureImportRGB failed")
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    ptrs = ctypes.cast(picture, ctypes.POINTER(ctypes.c_void_p))
    ptrs[_WRITER] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    ptrs[_CUSTOM] = ctypes.addressof(writer)
    try:
        if not lib.WebPEncode(config, picture):
            raise RuntimeError("WebPEncode failed")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(picture)
        lib.WebPMemoryWriterClear(ctypes.byref(writer))
