"""The port's Textual-Inversion generators (``cli/generate_images_textinversion.py``,
``cli/generate_images_textinversion_xl.py``) against the JAX package's CLIs
on the CPU.

Both CLIs run on the tiny SD1 / SDXL single files of
``tests/_baseline_assets.py`` with the same embedding files: a diffusers
``learned_embeds.safetensors`` (SD1, one vector), and ``clip_l`` /
``clip_g`` (XL, one per tower); 64px, 3 steps (LMS for SD1, DDIM for XL),
one sample, ``" with <sks>"`` appended to the prompt, the port's latent draw
patched to the JAX CLIs' ``normal(PRNGKey(seed))``. Both packages' weight
dtype is turned to fp32; the pixels agree within 1 of 255 and the file trees
are equal. Without the embedding the token's row is a grown zero row in
both, so the image with the embedding differs from the one without."""

import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file

import _baseline_assets as B
from sliders_conceptmod_tpu.cli import generate_images_textinversion as jti
from sliders_conceptmod_tpu.cli import generate_images_textinversion_xl as jtixl
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion as tti
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion_xl as ttixl
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ti")
    B.write_checkpoints(root)
    rng = np.random.default_rng(6)
    _, te, _, _ = tfactory.load_models(str(root / "tiny-sd1.safetensors"), device="cpu")
    _, tes, _, _ = tfactory.load_models_xl(str(root / "tiny-xl.safetensors"), device="cpu", with_unet=False)
    d1, dl, dg = (t.model.config.hidden_size for t in (te, *tes))
    np_save_file({"<sks>": rng.standard_normal(d1).astype(np.float32)}, str(root / "learned_embeds.safetensors"))
    np_save_file({"clip_l": rng.standard_normal(dl).astype(np.float32),
                  "clip_g": rng.standard_normal(dg).astype(np.float32)}, str(root / "learned_embeds_xl.safetensors"))
    return root


@pytest.mark.parametrize("family", ["sd1", "xl"])
def test_textinversion_cli_matches_jax(assets, tmp_path, monkeypatch, family):
    jax_cli, port_modules, base, emb = (
        (jti, [tti], "tiny-sd1.safetensors", "learned_embeds.safetensors") if family == "sd1"
        else (jtixl, [ttixl, tti], "tiny-xl.safetensors", "learned_embeds_xl.safetensors"))
    argv = ["--model_name", str(assets / base), "--prompts_path", str(assets / "prompts.csv"), "--token", "<sks>",
            *B.COMMON]
    B.run_both(monkeypatch, jax_cli, port_modules, argv + ["--embedding_path", str(assets / emb)], tmp_path, True)
    with_emb = B.assert_same_images(tmp_path, 1, True)
    port_modules[0].main(argv + ["--save_path", str(tmp_path / "plain"), "--device", "cpu"])
    (name,) = with_emb
    from PIL import Image

    assert not np.array_equal(with_emb[name], np.asarray(Image.open(tmp_path / "plain" / name)))
