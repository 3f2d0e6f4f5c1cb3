"""The image-pair loader's resize in the port against the JAX loader.

``train/imageslider.py::load_image_array`` reads a PNG and resizes it to the
training resolution as the JAX ``load_image_array`` does with PIL
(``Image.open(p).convert("RGB").resize((r, r))``: bicubic, a = −0.5, with
antialiasing when it shrinks). The port mirrors Pillow's fixed-point
resample in numpy (``io/resample.py``), so the arrays are compared bit for
bit — the stated bound of 1/255 is not needed. Cases: down- and upscaling,
non-square inputs, grey, grey + alpha and RGBA; an ``r × r`` image passes
unchanged; JPEG loads as the JAX loader loads it; WebP stays refused.
"""

import numpy as np
import pytest
from PIL import Image

from sliders_conceptmod_tpu.train import imageslider as jimage
from sliders_conceptmod_tpu_torch.io.resample import resize_like_pil
from sliders_conceptmod_tpu_torch.train import imageslider as timage
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CASES = [  # (height, width) of the file, training resolution
    ((400, 600), 512),  # landscape, up one side and down the other
    ((600, 400), 256),  # portrait, downscaled
    ((37, 53), 64),  # odd sizes, upscaled
    ((700, 700), 256),  # square, shrunk by 2.7
    ((5, 3), 32),  # tiny, upscaled tenfold
]


def _image(h, w, seed):
    """Noise over a smooth ramp: both the filter's ringing and its averaging show."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 3 % 256, 255 - xx % 256], -1)
    return np.clip(ramp + rng.integers(-40, 41, (h, w, 4)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("shape,resolution", CASES, ids=[f"{h}x{w}-{r}" for (h, w), r in CASES])
def test_load_image_array_resizes_as_the_jax_loader(tmp_path, mode, shape, resolution):
    path = str(tmp_path / f"im_{mode}.png")
    Image.fromarray(_image(*shape, seed=sum(shape))).convert(mode).save(path)
    want = jimage.load_image_array(path, resolution)
    got = timage.load_image_array(path, resolution)
    assert got.shape == want.shape == (1, 3, resolution, resolution) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_resize_matches_pil_on_uint8_and_passes_the_target_size_through():
    img = _image(48, 80, seed=3)[:, :, :3]
    for size in ((64, 64), (80, 20), (17, 48), (160, 96)):
        want = np.asarray(Image.fromarray(img).resize(size))
        np.testing.assert_array_equal(resize_like_pil(img, size), want)
    same = resize_like_pil(img, (80, 48))
    np.testing.assert_array_equal(same, img)
    assert same is not img  # a copy, as PIL's resize returns one


def test_jpeg_and_webp_stay_refused(tmp_path):
    """JPEG and WebP, refused until ``io/jpeg.py`` and ``io/webp.py``, now
    load and resize as the JAX loader does (lossy and lossless WebP); a
    format the port leaves out (AVIF) stays refused (ROADMAP.md queue 1,
    item 14)."""
    img = _image(16, 16, seed=1)[:, :, :3]
    for name, kw in (("im.jpg", {}), ("im.webp", {}), ("lossless.webp", {"lossless": True})):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path, **kw)
        for resolution in (16, 40):
            np.testing.assert_array_equal(timage.load_image_array(path, resolution),
                                          jimage.load_image_array(path, resolution))
    path = str(tmp_path / "im.avif")
    Image.fromarray(img).save(path)
    with pytest.raises(ValueError, match="AVIF is not supported.*queue 1, item 14"):
        timage.load_image_array(path, 16)
