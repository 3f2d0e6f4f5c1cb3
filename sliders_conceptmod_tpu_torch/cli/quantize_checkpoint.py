"""CLI: quantize a frozen base's UNet (SD3, Flux: the transformer) once to an int8
artifact — counterpart of ``sliders_conceptmod_tpu/cli/quantize_checkpoint.py``.

The artifact (``io/quant_cache.py``: int8 kernels and fp32 per-column scales
in one safetensors file, in the JAX package's layout and format tag) loads
as ``--base`` in ``load_models`` / ``load_models_xl`` / ``load_models_sd3`` /
``load_models_flux`` and so in the trainers, the sweeps and serving, of this
package and of the JAX package. It holds the UNet (the transformer) only:
the text towers and the VAE of a run from it are the weightless family's
(Flux: the stand-in encoder). A Flux artifact of schnell at full depth is
about 12 GB.

  python -m sliders_conceptmod_tpu_torch.cli.quantize_checkpoint \\
      --base /ckpts/sd15 --family sd1 --out sd15.int8.safetensors
"""

from __future__ import annotations

import argparse

import torch

from sliders_conceptmod_tpu_torch.io import quant_cache
from sliders_conceptmod_tpu_torch.models import factory


def run(args) -> int:
    """Quantize ``args.base``'s UNet and write ``args.out``; the int8 kernel count."""
    dtype = torch.bfloat16 if args.precision == "bfloat16" else torch.float32
    if args.family == "flux":  # the transformer only, as JAX's artifact
        _, _, unet, _ = factory.load_models_flux(args.base, weight_dtype=dtype, device=args.device,
                                                 quantize_base=True)
    elif args.family == "sd3":  # the transformer only, as JAX's artifact
        _, _, unet, _ = factory.load_models_sd3(args.base, weight_dtype=dtype, device=args.device, quantize_base=True)
    elif args.family == "xl":
        _, _, unet, _ = factory.load_models_xl(args.base, weight_dtype=dtype, device=args.device, quantize_base=True)
    else:
        _, _, unet, _ = factory.load_models(args.base, weight_dtype=dtype, device=args.device, quantize_base=True)
    n_q = quant_cache.save_quantized(args.out, unet, metadata={"family": args.family, "source": str(args.base)})
    print(f"wrote {args.out}: {n_q} int8 kernels (family={args.family})")
    return n_q


def build_parser():
    p = argparse.ArgumentParser(prog="quantizeCheckpoint")
    p.add_argument("--base", required=True, help="checkpoint dir / single file / weightless family name")
    p.add_argument("--family", choices=["flux", "sd3", "xl", "sd1"], required=True)
    p.add_argument("--out", required=True, help="output .int8.safetensors path")
    p.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="where the UNet is quantized (cuda, or cpu)")
    return p


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
