"""The port's scorers and eval CLIs against the JAX package's, on the CPU.

``models/clip_vision.py`` and ``models/lpips.py`` load the same weight
files as JAX's ``load_clip_scorer`` and ``load_lpips_params``: a tiny
transformers ``CLIPModel`` directory and random torchvision-AlexNet and
lpips lin-head ``.pth`` files, made as ``tests/test_eval_clis.py`` makes
them. Their outputs are held to JAX's (fp32, ≤ 2e-4); then both packages'
``eval/clip_score.py`` and ``eval/lpip_score.py`` run over copies of one
synthetic sweep and their CSVs are compared: the same columns in the same
order, the same rows, the prompts' fields as read, and each score within
1e-4 relative. The weights are synthetic, so this checks the pipeline, not
the metric's values."""

import csv
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)
from sliders_conceptmod_tpu.eval import clip_score as jclip_cli
from sliders_conceptmod_tpu.eval import lpip_score as jlpips_cli
from sliders_conceptmod_tpu.models import clip_vision as jclip
from sliders_conceptmod_tpu.models import lpips as jlpips
from sliders_conceptmod_tpu_torch.eval import clip_score as tclip_cli
from sliders_conceptmod_tpu_torch.eval import lpip_score as tlpips_cli
from sliders_conceptmod_tpu_torch.eval.table import eval_device
from sliders_conceptmod_tpu_torch.io.safetensors import save_file
from sliders_conceptmod_tpu_torch.models import clip_vision as tclip
from sliders_conceptmod_tpu_torch.models import lpips as tlpips
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig
from sliders_conceptmod_tpu_torch.models.tokenizer import write_synthetic_bpe_files

TOL = 2e-4


@pytest.fixture(scope="module")
def tiny_clip_dir(tmp_path_factory):
    """A transformers CLIPModel directory (config.json + model.safetensors);
    no vocabulary files, so both tokenizers fall back to HashTokenizer."""
    from transformers import CLIPConfig, CLIPModel

    d = tmp_path_factory.mktemp("tiny_clip")
    cfg = CLIPConfig(
        text_config={
            "vocab_size": 49408, "hidden_size": 32, "intermediate_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "max_position_embeddings": 77, "eos_token_id": 49407,
            "bos_token_id": 49406, "pad_token_id": 0, "hidden_act": "quick_gelu",
        },
        vision_config={
            "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "image_size": 64, "patch_size": 16,
            "hidden_act": "quick_gelu",
        },
        projection_dim=16,
    )
    torch.manual_seed(0)
    CLIPModel(cfg).save_pretrained(str(d), safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def lpips_weight_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips_w")
    torch.manual_seed(0)
    alex = {}
    for idx, out_c, in_c, k in [(0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
                                (10, 256, 256, 3)]:
        alex[f"features.{idx}.weight"] = torch.randn(out_c, in_c, k, k) * 0.05
        alex[f"features.{idx}.bias"] = torch.randn(out_c) * 0.01
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1) * 0.1 for i, c in enumerate([64, 192, 384, 256, 256])}
    torch.save(alex, d / "alexnet.pth")
    torch.save(lin, d / "lpips_alex.pth")
    return str(d / "alexnet.pth"), str(d / "lpips_alex.pth")


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """3 scale folders (one named 'half') × 3 cases × 2 samples, non-square
    images for the resize and crop; case 2 has no images; a stray file."""
    root = tmp_path_factory.mktemp("sweep")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (72, 96, 3), np.uint8)
    for scale in ("-1.0", "0.0", "half"):
        sd = root / scale
        sd.mkdir()
        for case in (0, 1):
            for idx in (0, 1):
                img = base.copy() if scale == "0.0" else np.clip(
                    base.astype(np.int32) + (30 if scale == "half" else -40) + 7 * case + 3 * idx, 0, 255
                ).astype(np.uint8)
                Image.fromarray(img).save(sd / f"{case}_{idx}.png")
        (sd / "notes.txt").write_text("not an image")
    csv_path = root / "prompts.csv"
    csv_path.write_text(
        "case_number,prompt,evaluation_seed,concept\n"
        "0,\"a smiling person, outdoors\",1,person\n"
        "1,a person,2,\n"
        "2,a cat,3,cat\n"
    )
    return str(root), str(csv_path)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_csvs_agree(port_csv, jax_csv, score_prefix):
    p_head, p_rows = _read(port_csv)
    j_head, j_rows = _read(jax_csv)
    assert p_head == j_head and len(p_rows) == len(j_rows)
    for pr, jr in zip(p_rows, j_rows):
        for name, a, b in zip(p_head, pr, jr):
            if not name.startswith(score_prefix):
                assert a == b, (name, a, b)
            elif b == "":
                assert a == "", (name, a)
            else:
                assert abs(float(a) - float(b)) <= 1e-4 * max(abs(float(b)), 1e-6), (name, a, b)


def test_preprocess_matches_jax():
    rng = np.random.default_rng(1)
    for h, w, size in ((72, 96, 64), (96, 72, 32), (50, 50, 224), (31, 17, 16)):
        imgs = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(tclip.preprocess_images(imgs, size), jclip.preprocess_images(imgs, size))


def test_clip_scorer_matches_jax(tiny_clip_dir):
    jmodel, jparams, jtok = jclip.load_clip_scorer(tiny_clip_dir)
    model, tok = tclip.load_clip_scorer(tiny_clip_dir, "cpu")
    prompts = ["a photo of a person", "a cat"]
    ids = np.asarray(tok(prompts))
    np.testing.assert_array_equal(ids, np.asarray(jtok(prompts)))
    px = tclip.preprocess_images(np.random.default_rng(2).integers(0, 256, (3, 80, 64, 3)).astype(np.uint8), 64)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(px), jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(px), torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_full_width_config_and_a_directory_written_by_the_port(tmp_path):
    """A seeded port scorer written under transformers names
    (``hf_state_dict``, the way ``chip_smoke.py`` writes ViT-B/32) with
    synthetic BPE files loads in JAX's ``load_clip_scorer`` and scores the
    same; ViT-B/32's configs are JAX's."""
    assert tclip.CLIPVisionConfig.vit_b32() == tclip.CLIPVisionConfig(**vars(jclip.CLIPVisionConfig.vit_b32()))
    torch.manual_seed(3)
    vcfg, tcfg = tclip.CLIPVisionConfig.tiny(), CLIPTextConfig.tiny(projection_dim=16)
    model = tclip.CLIPScorer(vcfg, tcfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05)
    sd = tclip.hf_state_dict(model)
    assert "vision_model.encoder.layers.0.mlp.fc1.weight" in sd and "text_projection.weight" in sd
    assert "text_model.embeddings.token_embedding.weight" in sd and "text_model.encoder.layers.1.mlp.fc2.bias" in sd
    save_file(sd, str(tmp_path / "model.safetensors"))
    config = {"projection_dim": 16,
              "vision_config": {k: getattr(vcfg, k) for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                                              "num_attention_heads", "image_size", "patch_size")},
              "text_config": {k: getattr(tcfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                                            "num_hidden_layers", "num_attention_heads")}}
    (tmp_path / "config.json").write_text(json.dumps(config))
    write_synthetic_bpe_files(str(tmp_path), ["a photo of a person", "a cat on a mat"], n_merges=40)
    jmodel, jparams, jtok = jclip.load_clip_scorer(str(tmp_path))
    port, tok = tclip.load_clip_scorer(str(tmp_path), "cpu")
    ids = np.asarray(tok(["a photo of a person"]))
    np.testing.assert_array_equal(ids, np.asarray(jtok(["a photo of a person"])))
    assert ids[0, 1] != 49407 and ids.max() < 49408  # the BPE vocabulary, not HashTokenizer
    px = tclip.preprocess_images(np.random.default_rng(4).integers(0, 256, (2, 40, 40, 3)).astype(np.uint8), 32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(px), jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(px), torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_lpips_matches_jax(lpips_weight_files):
    alex, lin = lpips_weight_files
    jmodel = jlpips.LPIPS()
    jparams = jlpips.load_lpips_params(alex, lin)
    model = tlpips.load_lpips(alex, lin, "cpu")
    rng = np.random.default_rng(3)
    i0 = rng.uniform(-1, 1, (2, 3, 64, 80)).astype(np.float32)
    i1 = np.clip(i0 + rng.normal(0, 0.2, i0.shape), -1, 1).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(i0), jnp.asarray(i1)))
    with torch.no_grad():
        got = model(torch.from_numpy(i0), torch.from_numpy(i1)).numpy()
        same = model(torch.from_numpy(i0), torch.from_numpy(i0)).numpy()
    assert want.min() > 1e-4
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    assert np.abs(same).max() < 1e-6  # LPIPS(x, x) = 0
    x = torch.randn(2, 8, 5, 5)
    want_n = jnp.asarray(x.numpy()) / (jnp.sqrt(jnp.sum(jnp.asarray(x.numpy()) ** 2, axis=1, keepdims=True)) + 1e-10)
    np.testing.assert_allclose(tlpips.normalize_tensor(x).numpy(), np.asarray(want_n), rtol=1e-6, atol=1e-7)


def _copy_sweep(sweep_dir, dst):
    root, csv_path = sweep_dir
    shutil.copytree(root, dst)
    return str(dst), os.path.join(str(dst), os.path.basename(csv_path))


def test_clip_score_cli_matches_jax(sweep_dir, tiny_clip_dir, tmp_path):
    jroot, jcsv = _copy_sweep(sweep_dir, tmp_path / "jax")
    troot, tcsv = _copy_sweep(sweep_dir, tmp_path / "port")
    common = ["--prompt", " a person ", "--clip_model", tiny_clip_dir, "--batch_size", "3", "--till_case", "1"]
    jclip_cli.run(jclip_cli.build_parser().parse_args(["--im_path", jroot, "--prompts_path", jcsv] + common))
    out = tclip_cli.run(tclip_cli.build_parser().parse_args(
        ["--im_path", troot, "--prompts_path", tcsv, "--device", "cpu"] + common))
    assert out == os.path.join(troot, "clip_scores.csv")
    head, rows = _read(out)
    assert head[-3:] == ["clip_-1.0", "clip_0.0", "clip_0.5"] and [r[-1] == "" for r in rows] == [False, False, True]
    _assert_csvs_agree(out, os.path.join(jroot, "clip_scores.csv"), "clip_")


def test_lpip_score_cli_matches_jax(sweep_dir, lpips_weight_files, tmp_path):
    alex, lin = lpips_weight_files
    jroot, jcsv = _copy_sweep(sweep_dir, tmp_path / "jax")
    troot, tcsv = _copy_sweep(sweep_dir, tmp_path / "port")
    common = ["--true", "0.0", "--alexnet_weights", alex, "--lpips_weights", lin]
    jlpips_cli.run(jlpips_cli.build_parser().parse_args(["--im_path", jroot, "--prompts_path", jcsv] + common))
    out = tlpips_cli.run(tlpips_cli.build_parser().parse_args(
        ["--im_path", troot, "--prompts_path", tcsv, "--device", "cpu"] + common))
    head, rows = _read(out)
    assert {"lpips_-1.0", "lpips_0.5"} <= set(head) and "lpips_0.0" not in head
    assert all(float(r[head.index("lpips_0.5")]) > 0 for r in rows[:2]) and rows[2][-1] == "0.0"
    _assert_csvs_agree(out, os.path.join(jroot, "lpips_score.csv"), "lpips_")
    np.testing.assert_array_equal(tlpips_cli.image_loader(os.path.join(troot, "half", "1_0.png")),
                                  jlpips_cli.image_loader(os.path.join(troot, "half", "1_0.png")))


def test_device_flag():
    assert eval_device("cuda") == "cuda" and eval_device("1") == "cuda:1" and eval_device("cpu") == "cpu"
    assert tclip_cli.build_parser().parse_args(["--im_path", "a", "--prompt", "b", "--prompts_path", "c",
                                                "--clip_model", "d"]).device == "cuda"
    with pytest.raises(ValueError, match="tpu"):
        eval_device("tpu")
