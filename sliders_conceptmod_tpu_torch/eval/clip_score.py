"""CLI: CLIP score per scale folder of generated images — counterpart of
``sliders_conceptmod_tpu/eval/clip_score.py`` (reference
``eval-scripts/clip_score.py``).

For each scale subfolder of ``--im_path``: the CLIP ViT-B/32 image–text logit
of every image ``<case>_<i>.png`` against the fixed ``--prompt``, averaged per
``case_number`` and appended to the prompts CSV as a ``clip_<scale>`` column
(``half`` → ``0.5``; cases without images stay empty), written to
``{im_path}/clip_scores.csv``. A folder's images are scored in batches of
``--batch_size``. Weights come from a local ``openai/clip-vit-base-patch32``
layout directory (``--clip_model``); images are read with ``io/image.py``.
``--device`` picks the torch device (default ``cuda``).

    python -m sliders_conceptmod_tpu_torch.eval.clip_score --im_path SWEEP \\
        --prompt "a person" --prompts_path prompts.csv --clip_model CLIP_DIR
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.eval.table import (
    case_numbers,
    column_mean,
    eval_device,
    read_table,
    set_column,
    write_table,
)
from sliders_conceptmod_tpu_torch.io.image import load_rgb
from sliders_conceptmod_tpu_torch.models.clip_vision import load_clip_scorer, preprocess_images


def sorted_nicely(names):
    convert = lambda t: int(t) if t.isdigit() else t  # noqa: E731
    return sorted(names, key=lambda k: [convert(c) for c in re.split(r"([0-9]+)", k)])


@torch.no_grad()
def run(args) -> str:
    device = eval_device(args.device)
    model, tokenizer = load_clip_scorer(args.clip_model, device)
    prompt = args.prompt.strip()
    input_ids = torch.as_tensor(np.asarray(tokenizer([prompt])), dtype=torch.long, device=device)
    print(f"Eval against prompt: {prompt}")

    path = args.im_path
    model_names = sorted(m for m in os.listdir(path) if "all" not in m and ".csv" not in m)
    fields, rows = read_table(args.prompts_path)
    cases = case_numbers(rows)
    for model_name in model_names:
        im_folder = os.path.join(path, model_name)
        ratios = {}
        col = f"clip_{model_name.replace('half', '0.5')}"
        batch_imgs, batch_cases = [], []
        for image in sorted_nicely(os.listdir(im_folder)):
            try:
                case_number = int(image.split("_")[0].replace(".png", ""))
            except ValueError:
                continue
            if case_number not in cases or not (args.from_case <= case_number <= args.till_case):
                continue
            batch_imgs.append(load_rgb(os.path.join(im_folder, image)))
            batch_cases.append(case_number)
        bs = args.batch_size
        for i in range(0, len(batch_imgs), bs):
            # the model directory's own resolution (224 for ViT-B/32)
            px = preprocess_images(batch_imgs[i : i + bs], image_size=model.vision_config.image_size)
            logits = model(torch.from_numpy(px).to(device), input_ids)[:, 0].float().cpu().numpy()
            for case, s in zip(batch_cases[i : i + bs], logits):
                ratios.setdefault(case, []).append(float(s))
        values = [float(np.mean(ratios[c])) if c in ratios else float("nan") for c in cases]
        set_column(fields, rows, col, values)
        print(f"{model_name}: mean CLIP score {column_mean(values)}")

    out = os.path.join(path, "clip_scores.csv")
    write_table(out, fields, rows)
    print(f"wrote {out}")
    return out


def build_parser():
    parser = argparse.ArgumentParser(prog="clipScore", description="CLIP score for images")
    parser.add_argument("--im_path", type=str, required=True)
    parser.add_argument("--prompt", type=str, required=True)
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--clip_model", type=str, required=True, help="local CLIPModel dir")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default), an ordinal, or cpu")
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=32)
    return parser


if __name__ == "__main__":
    run(build_parser().parse_args())
