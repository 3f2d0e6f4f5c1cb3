"""CLI: bake a slider into the base weights and write a single-file LDM/SGM
checkpoint (an A1111-style ``.safetensors``) — counterpart of
``sliders_conceptmod_tpu/cli/export_single_file.py``:

  python -m sliders_conceptmod_tpu_torch.cli.export_single_file \\
      --base /ckpts/sd15 --slider slider.safetensors --scale 1.0 \\
      --output merged.safetensors [--v2 | --xl | --sd3] [--half]

``--base`` is a diffusers directory, a single file or a family name
(``models/factory.py``), loaded in fp32 with its VAE. The slider (a UNet part;
rank and alpha from its tensors, else its file name) is merged at ``--scale``
(``adapters/lora.py::merge_lora_params``) into the site weights, and the
whole model is written through ``io/ldm_export.py`` in float32, or float16
with ``--half`` (which rounds: only the float32 export is bit-exact).
``--sd3`` writes SD3's ``*_incl_clips`` layout (the MMDiT and both CLIP
towers, no VAE, as the JAX CLI writes it) with a ``-``-delimited slider baked
in; ``--flux`` the BFL transformer-only layout (``io/ldm_export.py::
export_flux_bfl``; the text towers and the VAE ship apart) with a
``-``-delimited Flux slider baked in. The base loads in float32 on the
device (schnell at full depth: 47.6 GB).
Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_sd3 import sd3_slider
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import unet_slider
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.io import ldm_export
from sliders_conceptmod_tpu_torch.models import factory


def build_parser():
    parser = argparse.ArgumentParser("exportSingleFile")
    parser.add_argument("--base", required=True, help="diffusers dir, single file, or family")
    parser.add_argument("--slider", default=None, help="trained slider .safetensors to bake in")
    parser.add_argument("--scale", type=float, default=1.0, help="slider scale to bake at")
    parser.add_argument("--output", required=True)
    parser.add_argument("--v2", action="store_true", help="SD2 (OpenCLIP text-tower layout)")
    parser.add_argument("--xl", action="store_true", help="SDXL (SGM conditioner layout)")
    parser.add_argument("--sd3", action="store_true", help="SD3 (SGM MMDiT layout, CLIP towers included)")
    parser.add_argument("--flux", action="store_true", help="Flux (BFL transformer-only layout)")
    parser.add_argument("--half", action="store_true", help="save float16 tensors")
    parser.add_argument("--device", type=str, default="cuda", help="torch device or CUDA ordinal (cpu for tiny)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch_device(args.device)
    if args.flux:
        _, _, unet, _ = factory.load_models_flux(args.base, device=device)
    elif args.sd3:
        _, tes, unet, _ = factory.load_models_sd3(args.base, device=device)
    elif args.xl:
        _, tes, unet, _, vae = factory.load_models_xl(args.base, with_vae=True, device=device)
    else:
        _, te, unet, _, vae = factory.load_models(args.base, scheduler_name="ddim", v2=args.v2, with_vae=True,
                                                  device=device)
    unet_sd = unet.state_dict()
    if args.slider:
        parts = load_slider_file(args.slider)
        if parts.unet is None:
            raise ValueError(f"No matching LoRA keys between UNet and {args.slider}")
        slider_of = sd3_slider if args.sd3 or args.flux else unet_slider
        sites, lora_params = slider_of(unet, args.slider, parts.unet, device)
        unet_sd.update(lora_lib.merge_lora_params(unet, sites, lora_params, args.scale))
        print(f"baked {len(sites)} LoRA sites at scale {args.scale}")

    if args.flux:
        sd = ldm_export.export_flux_bfl(unet_sd)
    elif args.sd3:
        sd = ldm_export.export_sd3_checkpoint(unet_sd, tes[0].model.state_dict(), tes[1].model.state_dict())
    elif args.xl:
        sd = ldm_export.export_sdxl_checkpoint(unet_sd, tes[0].model.state_dict(), tes[1].model.state_dict(),
                                               vae.state_dict())
    else:
        sd = ldm_export.export_ldm_checkpoint(unet_sd, te.model.state_dict(), vae.state_dict(), v2=args.v2)
    dtype = torch.float16 if args.half else torch.float32
    sd = {k: v.to("cpu", dtype) for k, v in sd.items()}  # one tensor at a time: no second copy on the card
    ldm_export.save_ldm_checkpoint(args.output, sd)
    print(f"wrote {len(sd)} tensors -> {args.output}")
    return sd


if __name__ == "__main__":
    main()
