"""One-command acceptance chain: train → scale sweep → CLIP → LPIPS CSVs —
counterpart of ``sliders_conceptmod_tpu/cli/acceptance.py`` (the reference's
evaluate loop, ``README.md:34-35``, as one tested command):

  python -m sliders_conceptmod_tpu_torch.cli.acceptance \\
      --config_file data/config-xl.yaml --prompts_path prompts/prompts-person.csv \\
      --base <sdxl dir or single file> --save_path out/acc \\
      --clip_model <local CLIPModel dir> \\
      --alexnet_weights alexnet.pth --lpips_weights lpips_alex.pth

Each stage is the port's own CLI ``run()``; the chain adds no logic:

1. the SDXL trainer (``train/trainer.py``) → ``{save.path}/{decorated name}_last.safetensors``;
2. ``cli/generate_images_xl.py`` → ``{save_path}/{slider}/{scale}/{case}_{idx}.png``;
3. ``eval/clip_score.py`` → ``{sweep}/clip_scores.csv`` (``clip_<scale>`` columns);
4. ``eval/lpip_score.py`` → ``{sweep}/lpips_score.csv`` (``lpips_<scale>`` against ``--true_scale``);
5. :func:`verify_outputs`: the CSVs' structure, the per-scale mean curves,
   and LPIPS(im, im) == 0 exactly.

``--skip_train`` with ``--model_name`` evaluates an existing slider; a
scorer without weights is skipped with a warning. Per-stage seconds and the
curves land in ``{save_path}/acceptance.json`` under JAX's keys.
``--device`` is a CUDA ordinal (default ``0``) or ``cpu``, for every stage.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.cli import generate_images_xl as gen_cli
from sliders_conceptmod_tpu_torch.cli import train_lora_xl as train_cli
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.eval import clip_score, lpip_score
from sliders_conceptmod_tpu_torch.eval.table import read_table
from sliders_conceptmod_tpu_torch.models.lpips import load_lpips
from sliders_conceptmod_tpu_torch.train import trainer


def _scale_value(name: str) -> float:
    return float(name.replace("half", "0.5"))


def _column(path: str, col: str) -> np.ndarray:
    """``pd.read_csv(path)[col]`` as float64 (an empty field is NaN); a
    missing column raises SystemExit."""
    fields, rows = read_table(path)
    if col not in fields:
        raise SystemExit(f"[acceptance] verify: {path} missing column {col}")
    return np.asarray([float(r[col]) if r[col].strip() else math.nan for r in rows], np.float64)


def verify_outputs(sweep_dir, true_scale, expect_monotone=False, lpips_weights=None, alexnet_weights=None,
                   device: str = "cpu"):
    """Structural checks on the scorer CSVs: one ``clip_<scale>`` /
    ``lpips_<scale>`` column per scale folder, every value finite, LPIPS
    non-negative, and LPIPS(im, im) == 0 on a reference-scale image (with the
    LPIPS weights). Returns the per-scale mean curves for acceptance.json;
    with ``expect_monotone`` (real scorer weights) the mean CLIP curve must be
    monotone in scale, the slider-works criterion of the reference's evaluate
    loop (eval-scripts/clip_score.py:53-69)."""
    report = {}
    folders = sorted(d for d in os.listdir(sweep_dir) if os.path.isdir(os.path.join(sweep_dir, d)) and d != "all")
    if not folders:
        raise SystemExit(f"[acceptance] verify: no scale folders in {sweep_dir}")

    clip_csv = os.path.join(sweep_dir, "clip_scores.csv")
    if os.path.exists(clip_csv):
        curve = {}
        for folder in folders:
            col = f"clip_{folder.replace('half', '0.5')}"
            vals = _column(clip_csv, col)
            if not np.isfinite(vals).all():
                raise SystemExit(f"[acceptance] verify: non-finite values in {col}")
            curve[_scale_value(folder)] = float(vals.mean())
        report["clip_curve"] = {str(k): curve[k] for k in sorted(curve)}
        if expect_monotone and len(curve) >= 3:
            means = [curve[k] for k in sorted(curve)]
            diffs = np.diff(means)
            if not ((diffs >= 0).all() or (diffs <= 0).all()):
                raise SystemExit(f"[acceptance] verify: CLIP curve not monotone in scale: {means}")

    lpips_csv = os.path.join(sweep_dir, "lpips_score.csv")
    if os.path.exists(lpips_csv):
        curve = {}
        for folder in folders:
            if folder == true_scale:
                continue  # lpip_score skips the reference folder (reference behavior)
            col = f"lpips_{folder.replace('half', '0.5')}"
            vals = _column(lpips_csv, col)
            if not np.isfinite(vals).all():
                raise SystemExit(f"[acceptance] verify: non-finite values in {col}")
            if (vals < 0).any():
                raise SystemExit(f"[acceptance] verify: negative LPIPS in {col}")
            curve[_scale_value(folder)] = float(vals.mean())
        report["lpips_curve"] = {str(k): curve[k] for k in sorted(curve)}
        # the metric's zero point: LPIPS of a reference-scale image against itself is exactly 0
        if lpips_weights and alexnet_weights:
            true_dir = os.path.join(sweep_dir, true_scale)
            pngs = sorted(f for f in os.listdir(true_dir) if f.endswith(".png"))
            if pngs:
                im = torch.from_numpy(lpip_score.image_loader(os.path.join(true_dir, pngs[0]))).to(device)
                with torch.no_grad():
                    d = float(load_lpips(alexnet_weights, lpips_weights, device)(im, im)[0])
                if d != 0.0:
                    raise SystemExit(f"[acceptance] verify: LPIPS identity broken: d(im, im) = {d}")
                report["lpips_identity"] = 0.0
    return report


def run(args):
    timings = {}
    os.makedirs(args.save_path, exist_ok=True)

    # 1. train ---------------------------------------------------------------
    if args.skip_train:
        if not args.model_name:
            raise SystemExit("--skip_train requires --model_name")
        slider_path = args.model_name
    else:
        t0 = time.time()
        config = config_util.load_config_from_yaml(args.config_file)
        if args.name is not None:
            config.save.name = args.name
        train_cli._decorate(config, args.alpha, args.rank)
        prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, [])
        trainer.train(config, prompts, rank=args.rank, peft_type=args.peft_type, device=torch_device(args.device))
        slider_path = os.path.join(config.save.path, f"{config.save.name}_last.safetensors")
        timings["train_seconds"] = time.time() - t0
        print(f"[acceptance] trained {slider_path} in {timings['train_seconds']:.1f}s")

    # 2. scale-grid sweep ----------------------------------------------------
    t0 = time.time()
    gen_args = gen_cli.build_parser().parse_args(
        [
            "--model_name", slider_path,
            "--prompts_path", args.prompts_path,
            "--save_path", args.save_path,
            "--base", args.base,
            "--image_size", str(args.image_size),
            "--num_samples", str(args.num_samples),
            "--ddim_steps", str(args.ddim_steps),
            "--start_noise", str(args.start_noise),
            f"--scales={args.scales}",
            "--till_case", str(args.till_case),
            "--from_case", str(args.from_case),
            "--device", args.device,
        ]
        + (["--batch_scales"] if args.batch_scales else [])
    )
    gen_cli.run(gen_args)
    timings["sweep_seconds"] = time.time() - t0
    sweep_dir = os.path.join(args.save_path, os.path.basename(slider_path))
    print(f"[acceptance] sweep {sweep_dir} in {timings['sweep_seconds']:.1f}s")

    # 3. CLIP scores ---------------------------------------------------------
    if args.clip_model:
        t0 = time.time()
        clip_score.run(clip_score.build_parser().parse_args(
            [
                "--im_path", sweep_dir,
                "--prompt", args.clip_prompt or args.concept,
                "--prompts_path", args.prompts_path,
                "--clip_model", args.clip_model,
                "--till_case", str(args.till_case),
                "--from_case", str(args.from_case),
                "--device", args.device,
            ]
        ))
        timings["clip_seconds"] = time.time() - t0
    else:
        print("[acceptance] WARNING: no --clip_model — skipping CLIP scoring")

    # 4. LPIPS ---------------------------------------------------------------
    if args.alexnet_weights and args.lpips_weights:
        t0 = time.time()
        lpip_score.run(lpip_score.build_parser().parse_args(
            [
                "--im_path", sweep_dir,
                "--prompts_path", args.prompts_path,
                "--true", args.true_scale,
                "--alexnet_weights", args.alexnet_weights,
                "--lpips_weights", args.lpips_weights,
                "--device", args.device,
            ]
        ))
        timings["lpips_seconds"] = time.time() - t0
    else:
        print("[acceptance] WARNING: no LPIPS weights — skipping LPIPS scoring")

    # 5. structural verification of the CSVs + scale curves ------------------
    report = verify_outputs(sweep_dir, args.true_scale, expect_monotone=args.expect_monotone,
                            lpips_weights=args.lpips_weights, alexnet_weights=args.alexnet_weights,
                            device=torch_device(args.device))

    with open(os.path.join(args.save_path, "acceptance.json"), "w") as f:
        json.dump({"slider": slider_path, "sweep_dir": sweep_dir, **timings, **report}, f, indent=1)
    print(f"[acceptance] done: {json.dumps({**timings, **report})}")
    return sweep_dir


def build_parser():
    p = argparse.ArgumentParser(prog="acceptance", description="train -> sweep -> clip_scores.csv -> lpips_score.csv")
    p.add_argument("--config_file", type=str, default="data/config-xl.yaml")
    p.add_argument("--prompts_path", type=str, required=True, help="reference-schema prompts CSV")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--base", type=str, default="stabilityai/stable-diffusion-xl-base-1.0")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--peft_type", type=str, default="lora")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--model_name", type=str, default=None, help="existing slider (with --skip_train)")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--start_noise", type=int, default=750)
    p.add_argument("--scales", type=str, default="-2,-1,0,1,2")
    p.add_argument("--batch_scales", action="store_true")
    p.add_argument("--till_case", type=int, default=1000000)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--concept", type=str, default="person", help="CLIP probe prompt fallback")
    p.add_argument("--clip_prompt", type=str, default=None)
    p.add_argument("--clip_model", type=str, default=None, help="local CLIPModel dir")
    p.add_argument("--alexnet_weights", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--true_scale", type=str, default="0.0", help="LPIPS reference scale folder")
    p.add_argument("--expect_monotone", action="store_true",
                   help="assert the mean CLIP score is monotone in scale (use with real scorer weights)")
    p.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu (every stage)")
    return p


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
