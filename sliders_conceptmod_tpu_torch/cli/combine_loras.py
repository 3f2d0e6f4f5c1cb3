"""CLI: merge a UNet/transformer slider with two text-encoder sliders into one
``.safetensors`` — counterpart of ``sliders_conceptmod_tpu/cli/combine_loras.py``
(reference ``conceptmod/notrigger/combine_loras.py``):

  python -m sliders_conceptmod_tpu_torch.cli.combine_loras \\
      unet.safetensors te1.safetensors te2.safetensors out.safetensors [0.8 [1.0 [1.0]]]

* each part's strength is folded into its ``_down`` / ``_B`` factors; ``_up``
  / ``_A`` are copied, as are ``alpha`` and ``dora_scale`` (unscaled);
* keys are renamed as in JAX: the UNet part's ``lora_unet-…`` (SD3/Flux)
  keys become ``transformer.…`` with ``_down``/``_up`` → ``_A``/``_B`` and
  ``-`` → ``.``, while ``lora_unet_`` (SD1/XL) keys pass through; the CLIP
  part maps ``-`` → ``_``; the T5 part also ``lora_te2_`` → ``lora_te3_``;
* ``.safetensors`` inputs go through the port's reader (their stored
  dtype), ``.bin`` / ``.pt`` through ``torch.load(weights_only=True)`` in
  float32; the output through the port's writer.

Host-only: no device work.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from sliders_conceptmod_tpu_torch.io.safetensors import load_file, save_file


def read_tensors(file_path: str) -> Dict[str, torch.Tensor]:
    if file_path.endswith(".safetensors"):
        return load_file(file_path)
    if file_path.endswith(".bin") or file_path.endswith(".pt"):
        data = torch.load(file_path, map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in data.items()}
    raise ValueError(f"Unsupported checkpoint format: {file_path}")


def _rename(key: str, part: str) -> str:
    if part == "transformer":
        if key.startswith("lora_unet_"):
            # the JAX tool's deliberate deviation: the reference's rename chain
            # is for '-'-delimited SD3/Flux keys and would corrupt an SD1/XL
            # key ('down_blocks' → 'A_blocks'); these keep the canonical schema
            return key
        key = key.replace("lora_unet-", "transformer.")
        key = key.replace("_down", "_A")
        key = key.replace("_up", "_B")
        key = key.replace("-", ".")
    elif part == "CLIP":
        key = key.replace("-", "_")
    elif part == "T5":
        key = key.replace("-", "_")
        key = key.replace("lora_te2_", "lora_te3_")
    return key


def merge_part(out: Dict[str, torch.Tensor], tensors: Dict[str, torch.Tensor], strength: float, part: str) -> None:
    for k, v in tensors.items():
        k2 = _rename(k, part)
        if "alpha" in k or "dora_scale" in k:
            out[k2] = v.clone()
        elif "_up" in k or "_A" in k:
            out[k2] = v.clone()
        elif "_down" in k or "_B" in k:
            # the strength in the tensor's dtype, as numpy casts a Python float against an array
            out[k2] = torch.tensor(strength, dtype=v.dtype) * v
        else:
            raise AssertionError(f"{k} not supported")


def combine(unet_path, enc1_path, enc2_path, out_path, unet_strength=0.8, enc_strength=1.0, enc2_strength=1.0):
    out: Dict[str, torch.Tensor] = {}
    merge_part(out, read_tensors(unet_path), unet_strength, "transformer")
    merge_part(out, read_tensors(enc1_path), enc_strength, "CLIP")
    merge_part(out, read_tensors(enc2_path), enc2_strength, "T5")
    save_file(out, out_path)
    return out


def build_parser():
    parser = argparse.ArgumentParser(description="Merge slider safetensor files.")
    parser.add_argument("unet_model", type=str)
    parser.add_argument("encoder1_model", type=str)
    parser.add_argument("encoder2_model", type=str)
    parser.add_argument("output_model", type=str)
    parser.add_argument("unet_strength", type=float, default=0.8, nargs="?")
    parser.add_argument("enc_strength", type=float, default=1.0, nargs="?")
    parser.add_argument("enc2_strength", type=float, default=1.0, nargs="?")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return combine(args.unet_model, args.encoder1_model, args.encoder2_model, args.output_model,
                   args.unet_strength, args.enc_strength, args.enc2_strength)


if __name__ == "__main__":
    main()
