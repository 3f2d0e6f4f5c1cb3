"""CLI: SD1.x/2.x textual slider training — counterpart of
``sliders_conceptmod_tpu/cli/train_lora.py`` (reference
``conceptmod/textsliders/train_lora.py`` flag surface):

  python -m sliders_conceptmod_tpu_torch.cli.train_lora \\
      --config_file data/config.yaml --alpha 1 --rank 4

The same flags and save-name decoration (``_alpha{a}_rank{r}_{method}``) as
the JAX CLI. ``--device`` picks the torch device (default ``cuda``; ``cpu``
runs the kernels' plain versions, for tiny configs such as
``data/config-tiny.yaml``); ``--peft_type dora`` trains a DoRA slider
(``adapters/dora.py``). As in the JAX package, a prompt pair without a
``negative`` takes the ``unconditional`` one (``core/prompts.py``), which
gives the upstream 4-prompt loss.
"""

from __future__ import annotations

import argparse

from sliders_conceptmod_tpu_torch.cli.train_lora_xl import _decorate
from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train import trainer


def main(args):
    config = config_util.load_config_from_yaml(args.config_file)
    # a config that asks for more ranks than this process: run main in a spawned world of them
    if mesh_lib.spawn_for_config(config.tpu, config.tpu.samples_per_step, args.device, main, (args,)):
        return None
    if args.name is not None:
        config.save.name = args.name
    attributes = [a.strip() for a in args.attributes.split(",")] if args.attributes is not None else []
    _decorate(config, args.alpha, args.rank)
    prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, attributes)
    return trainer.train(
        config, prompts, rank=args.rank, peft_type=args.peft_type, resume_from=args.resume_from,
        device=args.device,
    )


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, cuda:1, or cpu for tiny configs).")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--attributes", type=str, default=None)
    parser.add_argument("--peft_type", type=str, default="lora", help="dora or lora (default)")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="resume checkpoint ({name}_resume.pt next to the saves, or its directory): restores "
                             "the factors, optimizer state, step and generators")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
