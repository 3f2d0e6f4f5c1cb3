"""The port's acceptance chain (``cli/acceptance.py``) against the JAX
package's on the CPU.

* The chain with ``--skip_train`` on the same slider over the tiny SDXL
  single file of ``tests/_baseline_assets.py`` (64px, 2 DDIM steps, scales
  -1, 0, 1; fp32 in both packages; the port's latent draw patched to the
  JAX CLI's), the same tiny transformers CLIP directory and the same LPIPS
  weight files: the same sweep tree (pixels within 1 of 255), the same
  ``acceptance.json`` keys and CSV columns, the curves within ``CURVE_TOL``
  (scores of images that differ by at most one level of 255), and
  ``lpips_identity`` exactly 0.0. Then the port's chain trains too
  (``train_seconds``).
* ``verify_outputs`` catches every structural break JAX's catches (the
  cases of ``tests/test_eval_clis.py::test_acceptance_verify_catches_structural_breaks``).

``cli/make_config.py`` and ``cli/run_batch.py`` are held in
``tests/test_torch_run_batch.py``."""

import csv
import json
import os

import numpy as np
import pytest
import torch

import _baseline_assets as B
import _sweep_cli_assets as A
from sliders_conceptmod_tpu.cli import acceptance as jacc
from sliders_conceptmod_tpu.cli import generate_images_xl as jgen
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import acceptance as tacc
from sliders_conceptmod_tpu_torch.cli import generate_images_xl as tgen
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLIDER = "acc_full_rank2_alpha1.safetensors"
CURVE_TOL = 1e-3  # scores of images within one level of 255 of each other


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The tiny SDXL file, a slider over it, a tiny CLIP directory and LPIPS weights."""
    from transformers import CLIPConfig, CLIPModel

    root = tmp_path_factory.mktemp("acceptance")
    B.write_checkpoints(root)
    _, _, unet, _ = tfactory.load_models_xl(str(root / "tiny-xl.safetensors"), device="cpu")
    sites = tlora.create_sites(unet, rank=2, alpha=1.0, train_method="full", target_replace=(
        tlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + tlora.UNET_TARGET_REPLACE_MODULE_CONV))
    g = torch.Generator().manual_seed(8)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = 0.3 * torch.randn(leaf["up"].shape, generator=g)
    tlora.save_weights(str(root / SLIDER), sites, lp)
    # one case: a case outside --till_case would leave its CLIP cells empty, which verify_outputs refuses
    (root / "acc_prompts.csv").write_text("case_number,prompt,evaluation_seed\n0,a photo of a person,42\n")
    cfg = CLIPConfig(
        text_config={"vocab_size": 49408, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "max_position_embeddings": 77, "eos_token_id": 49407,
                     "bos_token_id": 49406, "pad_token_id": 0, "hidden_act": "quick_gelu"},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                       "image_size": 64, "patch_size": 16, "hidden_act": "quick_gelu"},
        projection_dim=16)
    torch.manual_seed(0)
    CLIPModel(cfg).save_pretrained(str(root / "clip"), safe_serialization=True)
    g = torch.Generator().manual_seed(9)
    alex = {}
    for idx, out_c, in_c, k in [(0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
                                (10, 256, 256, 3)]:
        alex[f"features.{idx}.weight"] = torch.randn((out_c, in_c, k, k), generator=g) * 0.05
        alex[f"features.{idx}.bias"] = torch.randn((out_c,), generator=g) * 0.01
    torch.save(alex, root / "alexnet.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g) * 0.1
                for i, c in enumerate([64, 192, 384, 256, 256])}, root / "lpips_alex.pth")
    return root


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_acceptance_chain_matches_jax(assets, tmp_path, monkeypatch):
    argv = ["--config_file", "unused.yaml", "--prompts_path", str(assets / "acc_prompts.csv"), "--base",
            str(assets / "tiny-xl.safetensors"), "--image_size", "64", "--ddim_steps", "2", "--scales=-1,0,1",
            "--till_case", "2", "--clip_model", str(assets / "clip"), "--alexnet_weights", str(assets / "alexnet.pth"),
            "--lpips_weights", str(assets / "lpips_alex.pth"), "--skip_train", "--model_name", str(assets / SLIDER)]
    A.fp32(monkeypatch, jgen, tgen)
    jsweep = jacc.run(jacc.build_parser().parse_args(argv + ["--save_path", str(tmp_path / "jax")]))
    monkeypatch.setattr(tgen, "draw_latents", A.jax_draw)
    tsweep = tacc.main(argv + ["--save_path", str(tmp_path / "port"), "--device", "cpu"])
    assert os.path.relpath(tsweep, tmp_path / "port") == os.path.relpath(jsweep, tmp_path / "jax") == SLIDER
    assert A.tree(tmp_path / "port") == A.tree(tmp_path / "jax")
    from PIL import Image

    for name in A.tree(tmp_path / "jax"):
        if name.endswith(".png"):
            got, want = (np.asarray(Image.open(tmp_path / r / name)).astype(int) for r in ("port", "jax"))
            assert np.abs(got - want).max() <= 1, name
    for csv_name in ("clip_scores.csv", "lpips_score.csv"):
        assert _header(os.path.join(tsweep, csv_name)) == _header(os.path.join(jsweep, csv_name))
    got, want = (json.loads((tmp_path / r / "acceptance.json").read_text()) for r in ("port", "jax"))
    assert set(got) == set(want) == {"slider", "sweep_dir", "sweep_seconds", "clip_seconds", "lpips_seconds",
                                     "clip_curve", "lpips_curve", "lpips_identity"}
    assert got["lpips_identity"] == want["lpips_identity"] == 0.0
    for curve in ("clip_curve", "lpips_curve"):
        assert set(got[curve]) == set(want[curve])
        for k in want[curve]:
            assert abs(got[curve][k] - want[curve][k]) <= CURVE_TOL, (curve, k, got[curve][k], want[curve][k])


def test_acceptance_chain_trains(assets, tmp_path):
    cfg = (open(os.path.join(REPO, "data", "config-tiny-xl.yaml")).read()
           .replace('"data/prompts-tiny.yaml"', f'"{REPO}/data/prompts-tiny.yaml"')
           .replace("iterations: 4", "iterations: 2").replace("/tmp/slider_smoke", str(tmp_path / "ckpt")))
    (tmp_path / "config.yaml").write_text(cfg)
    tacc.main(["--config_file", str(tmp_path / "config.yaml"), "--prompts_path", str(assets / "acc_prompts.csv"),
               "--save_path", str(tmp_path / "acc"), "--base", "tiny-xl", "--rank", "2", "--image_size", "64",
               "--ddim_steps", "2", "--scales=-1,0,1", "--till_case", "2", "--alexnet_weights",
               str(assets / "alexnet.pth"), "--lpips_weights", str(assets / "lpips_alex.pth"), "--device", "cpu"])
    report = json.loads((tmp_path / "acc" / "acceptance.json").read_text())
    assert report["slider"].endswith("tinyxl_slider_alpha1.0_rank2_full_last.safetensors")
    assert os.path.exists(report["slider"]) and report["train_seconds"] > 0 and report["lpips_identity"] == 0.0
    assert "clip_curve" not in report  # no --clip_model: the stage is skipped with a warning


def _write(sweep, name, columns):
    with open(sweep / name, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(columns))
        w.writerow(["" if v != v else v for v in columns.values()])


BREAKS = [
    ("clip_scores.csv", {"case_number": 0, "clip_-1.0": 0.1, "clip_0.0": 0.2}, False, "missing column clip_1.0"),
    ("clip_scores.csv", {"case_number": 0, "clip_-1.0": 0.1, "clip_0.0": float("nan"), "clip_1.0": 0.3}, False,
     "non-finite"),
    ("clip_scores.csv", {"case_number": 0, "clip_-1.0": 0.1, "clip_0.0": 0.3, "clip_1.0": 0.2}, True, "not monotone"),
    ("lpips_score.csv", {"case_number": 0, "lpips_-1.0": -0.5, "lpips_1.0": 0.2}, False, "negative LPIPS"),
    ("lpips_score.csv", {"case_number": 0, "lpips_-1.0": 0.5}, False, "missing column lpips_1.0"),
    ("lpips_score.csv", {"case_number": 0, "lpips_-1.0": float("inf"), "lpips_1.0": 0.2}, False, "non-finite"),
]


@pytest.mark.parametrize("csv_name,columns,monotone,message", BREAKS,
                         ids=["clip_missing", "clip_nan", "clip_not_monotone", "lpips_negative", "lpips_missing",
                              "lpips_inf"])
def test_verify_outputs_catches_structural_breaks(tmp_path, csv_name, columns, monotone, message):
    sweep = tmp_path / "sweep"
    for scale in ("-1.0", "0.0", "1.0"):
        (sweep / scale).mkdir(parents=True)
    _write(sweep, csv_name, columns)
    for verify in (jacc.verify_outputs, tacc.verify_outputs):
        with pytest.raises(SystemExit, match=message):
            verify(str(sweep), "0.0", expect_monotone=monotone)


def test_verify_outputs_reports_jax_curves(tmp_path):
    sweep = tmp_path / "sweep"
    for scale in ("-1.0", "0.0", "half"):
        (sweep / scale).mkdir(parents=True)
    _write(sweep, "clip_scores.csv", {"case_number": 0, "clip_-1.0": 0.1, "clip_0.0": 0.2, "clip_0.5": 0.3})
    _write(sweep, "lpips_score.csv", {"case_number": 0, "lpips_-1.0": 0.4, "lpips_0.5": 0.0})
    assert tacc.verify_outputs(str(sweep), "0.0", expect_monotone=True) == \
        jacc.verify_outputs(str(sweep), "0.0", expect_monotone=True) == \
        {"clip_curve": {"-1.0": 0.1, "0.0": 0.2, "0.5": 0.3}, "lpips_curve": {"-1.0": 0.4, "0.5": 0.0}}
    with pytest.raises(SystemExit, match="no scale folders"):
        tacc.verify_outputs(str(tmp_path / "sweep" / "half"), "0.0")
