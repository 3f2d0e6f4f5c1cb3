"""Batch slider training — the reference's ``run.sh`` as a CLI; counterpart
of ``sliders_conceptmod_tpu/cli/run_batch.py`` (reference
``conceptmod/textsliders/run.sh:1-45``): for each spec
``"target|positive|unconditional"``, write the prompts YAML
(``cli/make_config.py``) as ``prompts-batch.yaml`` beside the config, then
train an SDXL slider on it with a fixed list of attributes to disentangle:

  python -m sliders_conceptmod_tpu_torch.cli.run_batch --config_file data/config-xl.yaml \\
      --specs "person|smiling person|person" "sky|stormy sky|sky" \\
      [--attributes 'woman, man, bright, dim'] [--alpha 1.0 --rank 4]

Each slider's save name is its target with ``_`` for spaces, decorated as
``cli/train_lora_xl.py`` decorates it. ``--device`` picks the torch device
(default ``cuda``; ``cpu`` for tiny configs).
"""

from __future__ import annotations

import argparse
import os

from sliders_conceptmod_tpu_torch.cli import train_lora_xl
from sliders_conceptmod_tpu_torch.cli.make_config import write_prompts
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.train import trainer

DEFAULT_ATTRIBUTES = "woman, man, bright, dim"  # reference run.sh attribute list


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--specs", nargs="+", required=True, help='"target|positive|unconditional" ...')
    parser.add_argument("--attributes", type=str, default=DEFAULT_ATTRIBUTES)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--peft_type", type=str, default="lora")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (cuda, cuda:1, or cpu)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = []
    for spec in args.specs:
        config = config_util.load_config_from_yaml(args.config_file)
        out_path = os.path.join(os.path.dirname(args.config_file) or ".", "prompts-batch.yaml")
        write_prompts(spec, out_path)
        config.prompts_file = out_path
        config.save.name = spec.split("|")[0].replace(" ", "_")
        train_lora_xl._decorate(config, args.alpha, args.rank)
        attributes = [a.strip() for a in args.attributes.split(",")] if args.attributes else []
        prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, attributes)
        print(f"=== training slider for spec: {spec} ({len(prompts)} prompt pairs)")
        results.append(trainer.train(config, prompts, rank=args.rank, peft_type=args.peft_type, device=args.device))
    return results


if __name__ == "__main__":
    main()
