"""The port's SDXL sweep CLI against the JAX CLI on the CPU.

Both packages' CLIs run on a tiny-xl checkpoint that the JAX package
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

The CLI resumes (files that exist are kept) and refuses the flags that are
not ported, and the int8 flags without ``--batch_scales`` as JAX does; its
parser has the JAX flags and defaults (and ``--device``)."""

import os

import pytest
import torch

import _sweep_cli_assets as A
from sliders_conceptmod_tpu.cli import generate_images_xl as jcli_xl
from sliders_conceptmod_tpu_torch.cli import generate_images_xl as tcli_xl
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, save_file
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_xl")
    A.make_assets(root, "xl")
    return root


@pytest.mark.parametrize("batch,fp32", [(False, True), (False, False), (True, False)],
                         ids=["merged_fp32", "merged_bf16", "batch_scales_bf16"])
def test_xl_sweep_matches_jax(assets, tmp_path, monkeypatch, batch, fp32):
    if fp32:
        A.fp32(monkeypatch, jcli_xl, tcli_xl)
    extra = ["--start_noise", "500"] + (["--batch_scales"] if batch else [])
    jcli_xl.run(jcli_xl.build_parser().parse_args(A.args(assets, "xl", tmp_path / "jax", *extra)))
    monkeypatch.setattr(tcli_xl, "draw_latents", A.jax_draw)
    tcli_xl.main(A.args(assets, "xl", tmp_path / "port", *extra, "--device", "cpu"))
    A.assert_same_sweep(tmp_path / "port", tmp_path / "jax", fp32)


def test_xl_sweep_resumes(assets, tmp_path, monkeypatch):
    out = tmp_path / "port"
    tcli_xl.main(A.args(assets, "xl", out, "--device", "cpu"))
    keep = out / A.SLIDER / "1.0" / "0_0.png"
    kept = keep.read_bytes()
    os.remove(out / A.SLIDER / "-1.0" / "0_0.png")
    calls = []
    real = tcli_xl.sample_loop
    monkeypatch.setattr(tcli_xl, "sample_loop", lambda *a, **k: calls.append(1) or real(*a, **k))
    os.utime(keep, (0, 0))
    tcli_xl.main(A.args(assets, "xl", out, "--device", "cpu"))
    assert len(calls) == 1  # only the missing scale ran
    assert keep.read_bytes() == kept and os.stat(keep).st_mtime == 0
    assert (out / A.SLIDER / "-1.0" / "0_0.png").exists()


def test_sweep_refusals(assets, tmp_path):
    # the int8 base runs with --batch_scales (tests/test_torch_quant_serve.py); without it JAX's rule
    # refuses it (the default path merges), as it refuses a sharded sweep without it
    # (tests/test_torch_mesh_sweep.py runs one with it)
    for flag, match in (("--quantize_base", "requires --batch_scales"), ("--w8a8", "requires --batch_scales"),
                        ("--mesh_data=2", "requires --batch_scales")):
        with pytest.raises(SystemExit, match=match):
            tcli_xl.main(A.args(assets, "xl", tmp_path / "out", flag, "--device", "cpu"))
    # text-encoder parts apply since they were ported (tests/test_torch_te_slider.py); a partial
    # one raises as JAX's load_te_part does: a down factor without its up, a key on no site
    te_slider = tmp_path / "te_slider.safetensors"
    sd = load_file(str(assets / "xl" / A.SLIDER))
    sd["lora_te1_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight"] = torch.zeros(2, 16)
    save_file(sd, str(te_slider))
    args = A.args(assets, "xl", tmp_path / "out", "--device", "cpu")
    args[1] = str(te_slider)
    with pytest.raises(KeyError, match="lora_up"):
        tcli_xl.main(args)
    sd["lora_te1_text_model_encoder_layers_0_mlp_fc1.lora_down.weight"] = torch.zeros(2, 16)
    save_file(sd, str(te_slider))
    with pytest.raises(ValueError, match="match no full site"):
        tcli_xl.main(args)
    p = tcli_xl.build_parser()
    defaults = vars(p.parse_args(["--model_name", "m", "--prompts_path", "p", "--save_path", "s"]))
    jdefaults = vars(jcli_xl.build_parser().parse_args(["--model_name", "m", "--prompts_path", "p", "--save_path", "s"]))
    assert {k: v for k, v in defaults.items() if k != "device"} == jdefaults  # the JAX flags and defaults
