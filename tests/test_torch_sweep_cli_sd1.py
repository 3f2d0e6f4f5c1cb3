"""The port's SD1 sweep CLI against the JAX CLI on the CPU.

Both packages' CLIs run on a tiny SD1 checkpoint that the JAX package
writes (``io/ldm_export.py``, with the tiny VAE; ``tests/_sweep_cli_assets.py``) and on
one JAX-written slider (``train_method`` full, Linear and conv sites): 64px,
3 steps, scales -1 and +1, one sample, the port's latent draw patched to the
JAX CLI's ``normal(PRNGKey(seed))``. Both write the same file tree.

* With the CLIs' weight dtype turned to fp32 in both packages the pixels
  agree within 1 of 255 (the rounding of the last step).
* At the CLIs' own bf16 (both load bf16 weights) the pixels are held within
  a bf16 bound: bf16 keeps 8 mantissa bits, and the two packages round
  different intermediates (the matmuls' and convolutions' partial sums, the
  merged weights); through 3 steps and the decode of a random tiny model
  that moves a pixel by at most ``PIXEL_MAX`` of 255 and the image's mean
  absolute difference by at most ``PIXEL_MEAN`` (the bound in
  ``tests/_sweep_cli_assets.py``; the largest mean measured on the CPU
  was 2.18).

The parser has the JAX flags and defaults."""

import numpy as np
import pytest
from PIL import Image

import _sweep_cli_assets as A
from sliders_conceptmod_tpu.cli import generate_images_sd1 as jcli_sd1
from sliders_conceptmod_tpu_torch.cli import generate_images_sd1 as tcli_sd1
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_sd1")
    A.make_assets(root, "sd1")
    return root


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_sd1_sweep_matches_jax(assets, tmp_path, monkeypatch, fp32):
    if fp32:
        A.fp32(monkeypatch, jcli_sd1, tcli_sd1)
    jcli_sd1.run(jcli_sd1.build_parser().parse_args(A.args(assets, "sd1", tmp_path / "jax")))
    monkeypatch.setattr(tcli_sd1, "draw_latents", A.jax_draw)
    tcli_sd1.main(A.args(assets, "sd1", tmp_path / "port", "--device", "cpu"))
    A.assert_same_sweep(tmp_path / "port", tmp_path / "jax", fp32)
    composite = np.asarray(Image.open(tmp_path / "port" / A.SLIDER / "all" / "0.png"))
    one = np.asarray(Image.open(tmp_path / "port" / A.SLIDER / "1.0" / "0_0.png"))
    assert composite.shape == (one.shape[0], 2 * one.shape[1], 3)


def test_sd1_parser_has_the_jax_flags():
    required = ["--model_name", "m", "--prompts_path", "p", "--save_path", "s"]
    assert vars(tcli_sd1.build_parser().parse_args(required)) == vars(jcli_sd1.build_parser().parse_args(required))
