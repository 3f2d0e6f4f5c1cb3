"""CLI: SDXL textual slider training — counterpart of
``sliders_conceptmod_tpu/cli/train_lora_xl.py`` (reference
``conceptmod/textsliders/train_lora_xl.py:460-516``), plus the ``train_lora``
programmatic API.

  python -m sliders_conceptmod_tpu_torch.cli.train_lora_xl \\
      --config_file data/config-xl.yaml --alpha 1 --rank 4

``--device`` picks the torch device (default ``cuda``; ``cpu`` runs the
kernels' plain versions, for tiny configs); ``--peft_type dora`` trains a
DoRA slider (``adapters/dora.py``). ``main`` decorates the save name
as the reference does: ``_alpha{a}_rank{r}_{method}``.
"""

from __future__ import annotations

import argparse
import json
import os

from sliders_conceptmod_tpu_torch.core import config as config_util
from sliders_conceptmod_tpu_torch.core import prompts as prompt_util
from sliders_conceptmod_tpu_torch.adapters import dora as dora_lib
from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib
from sliders_conceptmod_tpu_torch.train import trainer


def _decorate(config, alpha, rank):
    config.network.alpha = alpha
    config.network.rank = rank
    config.save.name += f"_alpha{alpha}"
    config.save.name += f"_rank{rank}"
    config.save.name += f"_{config.network.training_method}"
    config.save.path += f"/{config.save.name}"


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
    if config.logging.verbose:
        print(prompts)
    return trainer.train(
        config, prompts, rank=args.rank, peft_type=args.peft_type, resume_from=args.resume_from,
        device=args.device,
    )


def train_lora(
    target,
    positive,
    negative,
    unconditional,
    alpha=1.0,
    device="cuda",
    name=None,
    attributes=None,
    batch_size=1,
    config_file="data/config-xl.yaml",
    resolution=512,
    steps=None,
    on_step_complete=None,
    peft_type="lora",
    rank=4,
):
    """Programmatic API (reference train_lora_xl.py:421-458): writes a
    prompts YAML next to the config, trains, returns the state dict (numpy,
    reference schema, with ``.dora_scale`` for DoRA)."""
    spec = {
        "target": target,
        "positive": positive,
        "negative": negative,
        "unconditional": unconditional,
        "neutral": target,
        "action": "enhance",
        "resolution": resolution,
        "dynamic_resolution": False,
        "batch_size": batch_size,
    }
    prompts_path = os.path.join(os.path.dirname(config_file) or ".", "prompts-xl.yaml")
    with open(prompts_path, "w") as f:
        # one block-list entry; json.dumps quotes every string as YAML reads it
        f.write("- " + "\n  ".join(f"{k}: {json.dumps(v)}" for k, v in spec.items()) + "\n")
    config = config_util.load_config_from_yaml(config_file)
    config.prompts_file = prompts_path
    if name is not None:
        config.save.name = name
    if steps is not None:
        config.train.iterations = steps
    attr_list = [a.strip() for a in attributes.split(",")] if attributes else []
    _decorate(config, alpha, rank)
    prompts = prompt_util.load_prompts_from_yaml(config.prompts_file, attr_list)
    result = trainer.train(
        config, prompts, rank=rank, peft_type=peft_type, on_step_complete=on_step_complete, save_file=False,
        device=device,
    )
    peft_mod = dora_lib if peft_type == "dora" else lora_lib
    return peft_mod.state_dict_numpy(result.sites, result.lora_params)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True, help="Config file for training.")
    parser.add_argument("--alpha", type=float, required=True, help="LoRA weight.")
    parser.add_argument("--rank", type=int, required=False, default=4, help="Rank of LoRA.")
    parser.add_argument("--device", type=str, required=False, default="cuda",
                        help="torch device (cuda, cuda:1, or cpu for tiny configs).")
    parser.add_argument("--name", type=str, required=False, default=None)
    parser.add_argument("--attributes", type=str, required=False, default=None,
                        help="attributes to disentangle (comma separated string)")
    parser.add_argument("--peft_type", type=str, required=False, default="lora", help="dora or lora (default)")
    parser.add_argument("--resume_from", type=str, required=False, default=None,
                        help="resume checkpoint ({name}_resume.pt next to the saves, or its directory): restores "
                             "the factors, optimizer state, step and generators")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
