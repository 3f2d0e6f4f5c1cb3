"""CLI: LPIPS between the scale-0 ("true") images and each other scale
folder — counterpart of ``sliders_conceptmod_tpu/eval/lpip_score.py``
(reference ``eval-scripts/lpip_score.py``).

AlexNet LPIPS at 64px (the shortest side resized with Pillow's default
bicubic, ``io/resample.py``; no crop) between the same-named ``.png`` files
of ``--true`` and of every other folder, averaged per ``case_number`` into
an ``lpips_<scale>`` column (``half`` → ``0.5``; seeded with
``case_number * 0.0``, so a case without files reads 0.0), written to
``{im_path}/lpips_score.csv``. Weights are local files: ``--alexnet_weights``
(a torchvision AlexNet state dict) and ``--lpips_weights`` (the ``lpips``
package's alex.pth lin heads). ``--device`` picks the torch device (default
``cuda``).

    python -m sliders_conceptmod_tpu_torch.eval.lpip_score --im_path SWEEP \\
        --prompts_path prompts.csv --true 0.0 --alexnet_weights A.pth --lpips_weights L.pth
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.eval.table import case_numbers, eval_device, read_table, set_column, write_table
from sliders_conceptmod_tpu_torch.io.image import load_rgb
from sliders_conceptmod_tpu_torch.io.resample import resize_like_pil
from sliders_conceptmod_tpu_torch.models.lpips import load_lpips

IMSIZE = 64  # reference lpip_score.py:22


def image_loader(path: str) -> np.ndarray:
    """The file → ``[1, 3, h, w]`` float32 in [-1, 1], its shortest side 64."""
    im = load_rgb(path)
    h, w = im.shape[:2]
    short = min(w, h)
    im = resize_like_pil(im, (int(round(w * IMSIZE / short)), int(round(h * IMSIZE / short))))
    a = im.astype(np.float32) / 255.0
    return ((a - 0.5) * 2).transpose(2, 0, 1)[None]


@torch.no_grad()
def run(args) -> str:
    device = eval_device(args.device)
    model = load_lpips(args.alexnet_weights, args.lpips_weights, device)
    true = args.true
    models = [m for m in os.listdir(args.im_path) if m not in [true, "all"] and ".csv" not in m]
    original_path = os.path.join(args.im_path, true)
    fields, rows = read_table(args.prompts_path)
    cases = case_numbers(rows)

    for model_name in models:
        edited_path = os.path.join(args.im_path, model_name)
        file_names = [n for n in os.listdir(edited_path) if ".png" in n]
        col = f"lpips_{model_name.replace('half', '0.5')}"
        values = [case * 0.0 for case in cases]
        for index, case in enumerate(cases):
            scores = []
            for file in [f for f in file_names if f.startswith(f"{case}_")]:
                o, e = os.path.join(original_path, file), os.path.join(edited_path, file)
                if not (os.path.exists(o) and os.path.exists(e)):
                    continue
                a, b = (torch.from_numpy(image_loader(p)).to(device) for p in (o, e))
                scores.append(float(model(a, b)[0]))
            if scores:
                values[index] = float(np.mean(scores))
                print(f"Case {case}: {np.mean(scores)}")
        set_column(fields, rows, col, values)

    out = os.path.join(args.im_path, "lpips_score.csv")
    write_table(out, fields, rows)
    print(f"wrote {out}")
    return out


def build_parser():
    parser = argparse.ArgumentParser(prog="LPIPS", description="LPIPS vs scale-0 images")
    parser.add_argument("--im_path", type=str, required=True)
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--true", type=str, required=True)
    parser.add_argument("--alexnet_weights", type=str, required=True)
    parser.add_argument("--lpips_weights", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default), an ordinal, or cpu")
    return parser


if __name__ == "__main__":
    run(build_parser().parse_args())
