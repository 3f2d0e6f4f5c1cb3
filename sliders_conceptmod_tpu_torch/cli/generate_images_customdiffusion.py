"""CLI: the Custom Diffusion baseline generator — counterpart of
``sliders_conceptmod_tpu/cli/generate_images_customdiffusion.py`` (reference
``eval-scripts/generate_images_customdiffusion.py``, its vendored
CustomDiffusion(XL)Pipeline's ``load_model``, :482-507 SD1 and :748-783 XL).

``--model_name`` is the ``delta.bin`` (a pickle: ``{"unet": {...},
"modifier_token": {token: embedding | [embedding, embedding_2]}}``, with
``text_encoder`` / ``text_encoder_2`` state dicts when the text towers were
trained). The loader:

* writes the cross-attention ``attn2`` ``to_k``/``to_v`` weights into the
  UNet (a copy, or the compressed ``u @ v`` added;
  ``eval/baselines.py::patch_custom_diffusion_kv``);
* replaces a tower's weights with its state dict from the delta;
* registers each modifier token on each tower with one embedding per tower
  (the last one repeats);

then sweeps the prompt CSV with ``" with {token}"`` appended (:806-814; 50
steps, CFG 7.5, 5 images a prompt) into ``{save_path}/{basename}/{case}_{i}.png``.
``--family xl`` (DDIM, the reference's default) or ``sd1`` (LMS).
``--device`` is a CUDA ordinal (default ``0``) or ``cpu``.

  python -m sliders_conceptmod_tpu_torch.cli.generate_images_customdiffusion \\
      --model_name delta.bin --prompts_path prompts/prompts-person.csv --token "<new1>" --base path/to/sdxl
"""

from __future__ import annotations

import argparse
import os

from sliders_conceptmod_tpu_torch.cli.generate_images_textinversion import sweep_cases
from sliders_conceptmod_tpu_torch.cli.generate_images_textinversion_xl import xl_encoder
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import WEIGHT_DTYPE
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.eval.baselines import (
    add_inversion_token,
    grow_token_table,
    load_pickle,
    patch_custom_diffusion_kv,
)
from sliders_conceptmod_tpu_torch.io import torch_convert as tc
from sliders_conceptmod_tpu_torch.models import factory


def load_text_encoder(te, sd: dict, what: str) -> None:
    """A tower's weights from a transformers-layout state dict, cast to its
    dtype; a token table the delta grew grows the tower's first."""
    sd = tc.clip_state_dict(sd)
    grow_token_table(te.model, sd["token_embedding.weight"].shape[0])
    tc.load_state(te.model, sd, what)


def run(args):
    device = torch_device(args.device)
    folder = f"{args.save_path}/{os.path.basename(os.path.normpath(args.model_name)) or 'customdiffusion'}"
    os.makedirs(folder, exist_ok=True)
    delta = load_pickle(args.model_name)  # as the reference's save_pretrained wrote it (:459-480)

    if args.family == "xl":
        _, encoders, unet, scheduler, vae = factory.load_models_xl(
            args.base, scheduler_name="ddim", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device,
        )
        encode = xl_encoder(encoders, args.image_size, device)
    else:
        _, te, unet, scheduler, vae = factory.load_models(
            args.base, scheduler_name="lms", weight_dtype=WEIGHT_DTYPE, with_vae=True, device=device,
        )
        encoders = [te]
        encode = lambda prompts: (factory.encode_prompts(te, prompts), None)  # noqa: E731

    patch_custom_diffusion_kv(unet, delta.get("unet", {}))
    for key, te_i in zip(("text_encoder", "text_encoder_2"), encoders):
        if key in delta:
            load_text_encoder(te_i, delta[key], f"{args.model_name} {key}")
    for token, embs in delta.get("modifier_token", {}).items():
        if not isinstance(embs, (list, tuple)):
            embs = [embs]
        for i, te_i in enumerate(encoders):
            add_inversion_token(te_i, token, embs[min(i, len(embs) - 1)])
    sweep_cases(args, unet, vae, scheduler, encode, folder, device)


def build_parser():
    parser = argparse.ArgumentParser(prog="Generate Custom Diffusion Images")
    parser.add_argument("--model_name", type=str, required=True, help="path to delta.bin")
    parser.add_argument("--prompts_path", type=str, required=True)
    parser.add_argument("--token", type=str, required=True)
    parser.add_argument("--family", type=str, default="xl", choices=["xl", "sd1"])
    parser.add_argument("--base", type=str, default="stabilityai/stable-diffusion-xl-base-1.0")
    parser.add_argument("--save_path", type=str, default="images/customdiffusion")
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--till_case", type=int, default=1000000)
    parser.add_argument("--from_case", type=int, default=0)
    parser.add_argument("--device", type=str, default="0", help="CUDA ordinal, or cpu")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
