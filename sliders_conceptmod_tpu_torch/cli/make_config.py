"""One-liner slider spec → prompts YAML — counterpart of
``sliders_conceptmod_tpu/cli/make_config.py`` (reference
``conceptmod/textsliders/make_config.py:1-28``): ``"target|positive|unconditional"``
becomes one enhance pair at guidance 3, 512px, batch 12, written (by default)
to ``data/prompts-xl.yaml`` with the port's YAML writer
(``core/yaml_subset.py::dumps``, PyYAML's ``yaml.dump`` output):

  python -m sliders_conceptmod_tpu_torch.cli.make_config "person|smiling person|person"
"""

from __future__ import annotations

import argparse
import os

from sliders_conceptmod_tpu_torch.core import yaml_subset


def make_prompts(spec: str):
    parts = spec.split("|")
    target = parts[0]
    positive = parts[1] if len(parts) > 1 else target
    unconditional = parts[2] if len(parts) > 2 else ""
    return [
        {
            "target": target,
            "positive": positive,
            "unconditional": unconditional,
            "neutral": target,
            "action": "enhance",
            "guidance_scale": 3,
            "resolution": 512,
            "dynamic_resolution": False,
            "batch_size": 12,
        }
    ]


def write_prompts(spec: str, path: str) -> None:
    with open(path, "w") as f:
        f.write(yaml_subset.dumps(make_prompts(spec)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("spec", help='"target|positive|unconditional"')
    parser.add_argument("--out", default="data/prompts-xl.yaml")
    args = parser.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_prompts(args.spec, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
