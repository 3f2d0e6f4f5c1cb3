"""The port's UCE baseline generator (``cli/generate_images_uce.py``)
against the JAX package's CLI on the CPU.

Both CLIs run on a tiny SD1 single file (with the tiny VAE; written by
``tests/_baseline_assets.py``) and one UCE edit of its UNet saved as
``.safetensors`` (every ``attn2`` K/V tensor moved): 64px, 3 LMS steps,
scales -1, 0 and 0.5 (the ``half`` folder), ``start_noise`` 700 (the
original UNet for the first step, the interpolated one after), one sample,
the port's latent draw patched to the JAX CLI's ``normal(PRNGKey(seed))``.
Both write the same file tree (three scale folders and the composite).

* With both packages' weight dtype turned to fp32 the pixels agree within 1
  of 255 (the rounding of the last step).
* At the CLI's own bf16 the pixels are held within the bf16 bound of
  ``tests/_sweep_cli_assets.py``: the packages round different
  intermediates.

The interpolation holds only the edited tensors over an fp32 base and gives
the base back bit for bit at scale 0. The parsers of all four baseline
CLIs have JAX's flags and defaults, and ``--device``."""

import os

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

import _baseline_assets as B
from sliders_conceptmod_tpu.cli import generate_images_customdiffusion as jcd
from sliders_conceptmod_tpu.cli import generate_images_textinversion as jti
from sliders_conceptmod_tpu.cli import generate_images_textinversion_xl as jtixl
from sliders_conceptmod_tpu.cli import generate_images_uce as juce
from sliders_conceptmod_tpu_torch.cli import generate_images_customdiffusion as tcd
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion as tti
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion_xl as ttixl
from sliders_conceptmod_tpu_torch.cli import generate_images_uce as tuce
from sliders_conceptmod_tpu_torch.eval.baselines import load_edited_unet
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

EDIT = "uce_edited.safetensors"


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("uce")
    B.write_checkpoints(root)
    sd = B.unet_entries(root / "tiny-sd1.safetensors")
    rng = np.random.default_rng(5)
    for k in sd:
        if B.is_kv(k):
            sd[k] = sd[k] + 0.2 * rng.standard_normal(sd[k].shape).astype(np.float32)
    np_save_file(sd, str(root / EDIT))
    return root


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_uce_cli_matches_jax(assets, tmp_path, monkeypatch, fp32):
    argv = ["--model_name", str(assets / EDIT), "--prompts_path", str(assets / "prompts.csv"),
            "--base", str(assets / "tiny-sd1.safetensors"), "--scales=-1,0,0.5", "--start_noise", "700", *B.COMMON]
    B.run_both(monkeypatch, juce, [tuce], argv, tmp_path, fp32)
    imgs = B.assert_same_images(tmp_path, 4, fp32)
    assert {os.path.dirname(n) for n in imgs} == {f"{EDIT}/-1", f"{EDIT}/0", f"{EDIT}/half", f"{EDIT}/all"}
    assert not np.array_equal(imgs[f"{EDIT}/-1/0_0.png"], imgs[f"{EDIT}/half/0_0.png"])  # the edit bites


def test_uce_interpolation_at_zero_is_the_base(assets):
    """Only the edited tensors are interpolated over an fp32 base; over a bf16
    base every tensor's rounding residue is a delta (as in JAX); scale 0 gives
    the base back bit for bit."""
    edited = load_edited_unet(str(assets / EDIT))
    for dtype in (torch.float32, torch.bfloat16):
        _, _, unet, _ = tfactory.load_models(str(assets / "tiny-sd1.safetensors"), weight_dtype=dtype, device="cpu")
        delta = tuce.edit_delta(unet, edited)
        if dtype == torch.float32:
            assert sorted(delta) == sorted(k for k in edited if B.is_kv(k))
        params = dict(unet.named_parameters())
        for k, v in tuce.interpolate(unet, delta, 0.0).items():
            assert v.dtype == dtype and torch.equal(v, params[k])
    scales = (-0.5, 0.5, 0.55, 10.5, 2.0, -1.0, 0.0)
    assert [tuce.scale_folder(s) for s in scales] == [juce.scale_folder(s) for s in scales]


@pytest.mark.parametrize("jax_cli,port_cli,required", [
    (juce, tuce, ["--model_name", "m", "--prompts_path", "p", "--save_path", "s"]),
    (jti, tti, ["--model_name", "m", "--prompts_path", "p", "--token", "t"]),
    (jtixl, ttixl, ["--model_name", "m", "--prompts_path", "p", "--token", "t"]),
    (jcd, tcd, ["--model_name", "m", "--prompts_path", "p", "--token", "t"]),
], ids=["uce", "ti", "ti_xl", "cd"])
def test_parsers_have_the_jax_flags(jax_cli, port_cli, required):
    B.parser_flags(jax_cli, port_cli, required)
