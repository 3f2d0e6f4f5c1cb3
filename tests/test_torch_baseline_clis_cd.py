"""The port's Custom Diffusion generator (``cli/generate_images_customdiffusion.py``)
against the JAX package's CLI on the CPU.

Both CLIs run on the tiny SDXL / SD1 single files of
``tests/_baseline_assets.py`` with the same ``delta.bin`` (a pickle):

* ``--family xl`` (DDIM): one plain ``attn2`` K/V entry (copied over the
  base), one compressed rank-2 entry (``u @ v`` added), one ``attn1`` entry
  (ignored), and the token ``<new1>`` with one embedding per tower;
* ``--family sd1`` (LMS): one plain K/V entry, a ``text_encoder`` state dict
  (transformers' names, every value moved) that replaces the tower, and
  the token's one embedding.

64px, 3 steps, one sample, ``" with <new1>"`` appended, the port's latent draw
patched to the JAX CLI's ``normal(PRNGKey(seed))``; the same file tree.
With both packages' weight dtype turned to fp32 the pixels agree within 1 of
255; at the CLI's own bf16 (XL) within the bf16 bound of
``tests/_sweep_cli_assets.py``."""

import numpy as np
import pytest
import torch

import _baseline_assets as B
from sliders_conceptmod_tpu.cli import generate_images_customdiffusion as jcd
from sliders_conceptmod_tpu_torch.cli import generate_images_customdiffusion as tcd
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion as tti
from sliders_conceptmod_tpu_torch.io import ldm_export as tle
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cd")
    B.write_checkpoints(root)
    rng = np.random.default_rng(7)
    _, tes, xl, _ = tfactory.load_models_xl(str(root / "tiny-xl.safetensors"), device="cpu")
    xsd = {k: v.numpy() for k, v in xl.state_dict().items()}
    kv = sorted(k for k in xsd if B.is_kv(k))
    w = xsd[kv[1]]
    (root / "xl").mkdir()
    torch.save({"unet": {kv[0]: _t(xsd[kv[0]] + 0.3),
                         kv[1]: {"u": _t(rng.standard_normal((w.shape[0], 2))),
                                 "v": _t(0.3 * rng.standard_normal((2, w.shape[1])))},
                         next(k for k in sorted(xsd) if ".attn1.to_k." in k): _t(np.zeros_like(w))},
                "modifier_token": {"<new1>": [_t(rng.standard_normal(t.model.config.hidden_size)) for t in tes]}},
               str(root / "xl" / "delta.bin"))
    _, te, unet, _ = tfactory.load_models(str(root / "tiny-sd1.safetensors"), device="cpu")
    ssd = {k: v.numpy() for k, v in unet.state_dict().items()}
    k1 = next(k for k in sorted(ssd) if B.is_kv(k) and ".to_v." in k)
    # the tower's state dict under transformers' names (the single-file export strips to them)
    te_sd = {k: v + 0.02 for k, v in tle.export_clip_text(te.model.state_dict(), prefix="").items()}
    (root / "sd1").mkdir()
    torch.save({"unet": {k1: _t(ssd[k1] * 1.5)}, "text_encoder": te_sd,
                "modifier_token": {"<new1>": _t(rng.standard_normal(te.model.config.hidden_size))}},
               str(root / "sd1" / "delta.bin"))
    return root


@pytest.mark.parametrize("family,fp32", [("xl", True), ("xl", False), ("sd1", True)],
                         ids=["xl-fp32", "xl-bf16", "sd1-fp32"])
def test_customdiffusion_cli_matches_jax(assets, tmp_path, monkeypatch, family, fp32):
    base = "tiny-xl.safetensors" if family == "xl" else "tiny-sd1.safetensors"
    argv = ["--model_name", str(assets / family / "delta.bin"), "--prompts_path", str(assets / "prompts.csv"),
            "--token", "<new1>", "--family", family, "--base", str(assets / base), *B.COMMON]
    B.run_both(monkeypatch, jcd, [tcd, tti], argv, tmp_path, fp32)
    B.assert_same_images(tmp_path, 1, fp32)
