"""CLI: the Textual-Inversion baseline generator (SDXL) — counterpart of
``sliders_conceptmod_tpu/cli/generate_images_textinversion_xl.py`` (reference
``eval-scripts/generate_images_textinversion_xl.py``).

The SD1 generator's flow (``cli/generate_images_textinversion.py``) through
SDXL with DDIM: an SDXL inversion carries two embeddings, clip_l for the
first text tower and clip_g for the second
(``eval/baselines.py::load_textual_inversion_xl``), each written into its
tower's token table at the token's id there; the micro-conditioning is
``add_time_ids`` at ``--image_size``:

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_textinversion_xl \\
      --model_name path/to/sdxl --prompts_path prompts/prompts-person.csv \\
      --token "<sks>" --embedding_path learned_embeds.safetensors
"""

from __future__ import annotations

import argparse
import os

import torch

from sliders_conceptmod_tpu_torch.cli.generate_images_textinversion import add_common_flags, sweep_cases
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import WEIGHT_DTYPE
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.eval.baselines import add_inversion_token, load_textual_inversion_xl
from sliders_conceptmod_tpu_torch.models import factory


def xl_encoder(text_encoders, image_size: int, device):
    """prompts -> (both towers' embeddings, {pooled, add_time_ids}) for the
    baseline loop (``sweep_cases``)."""
    time_ids = torch.from_numpy(get_add_time_ids(image_size, image_size)).to(device)

    def encode(prompts):
        text, pooled = factory.encode_prompts_xl(text_encoders, prompts)
        return text, {"text_embeds": pooled, "time_ids": time_ids.expand(len(prompts), -1)}

    return encode


def run(args):
    device = torch_device(args.device)
    folder = f"{args.save_path}/{os.path.basename(os.path.normpath(args.model_name))}"
    os.makedirs(folder, exist_ok=True)
    _, text_encoders, unet, scheduler, vae = factory.load_models_xl(
        args.model_name, scheduler_name="ddim", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device,
    )
    if args.embedding_path:
        for te, emb in zip(text_encoders, load_textual_inversion_xl(args.embedding_path)):
            add_inversion_token(te, args.token, emb)
    sweep_cases(args, unet, vae, scheduler, xl_encoder(text_encoders, args.image_size, device), folder, device)


def build_parser():
    parser = argparse.ArgumentParser(prog="Generate Text Inversion Images (XL)")
    parser.add_argument("--model_name", type=str, required=True, help="base model path")
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--token", type=str, required=True)
    return add_common_flags(parser)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
