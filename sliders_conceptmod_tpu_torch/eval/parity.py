"""Forward-activation parity harness — counterpart of
``sliders_conceptmod_tpu/eval/parity.py``.

Both packages run their models on the same fixed probe inputs
(:func:`probe_inputs`, bit-equal to the JAX package's) and write the
activations under the same keys (``unet_out``, ``text_last_hidden``,
``text_penultimate``); ``compare`` reports each tensor's max-abs and
relative error. A dump of the port against a dump of the JAX package over
the same model directory is the real-weight parity check; the diffusers
reference side is :data:`TORCH_REFERENCE_SNIPPET`, to run where diffusers
is installed (nothing here imports it).

  python -m sliders_conceptmod_tpu_torch.eval.parity dump --model_dir /ckpts/sd15 \\
      --family sd15 --out parity_port.npz [--device cpu]
  python -m sliders_conceptmod_tpu_torch.eval.parity compare --a parity_jax.npz --b parity_port.npz

``dump`` loads the weights in fp32 and runs on ``--device`` (default
``cuda``); ``--family sdxl`` loads an SDXL directory and conditions the UNet
on the pooled embedding and ``time_ids`` probes.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.models import factory


def probe_inputs(family: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic probe tensors shared by both sides (the JAX package's,
    draw for draw)."""
    rng = np.random.default_rng(seed)
    d: Dict[str, np.ndarray] = {
        "latents": rng.standard_normal((1, 4, 64, 64)).astype(np.float32),
        "timestep": np.array([500.0], np.float32),
        "input_ids": np.array([[49406] + [320] * 5 + [49407] + [49407] * 70], np.int64),
    }
    if family == "sdxl":
        d["context"] = rng.standard_normal((1, 77, 2048)).astype(np.float32) * 0.2
        d["pooled"] = rng.standard_normal((1, 1280)).astype(np.float32) * 0.2
        d["time_ids"] = np.array([[512, 512, 0, 0, 512, 512]], np.float32)
    else:
        d["context"] = rng.standard_normal((1, 77, 768)).astype(np.float32) * 0.2
    return d


@torch.inference_mode()
def activations(model_dir: str, family: str, device: str = "cuda") -> Dict[str, np.ndarray]:
    """The port's activations on the probes: the UNet's output and the (first)
    text tower's last and penultimate hidden states, fp32 weights."""
    probes = probe_inputs(family)
    t = {k: torch.from_numpy(v).to(device) for k, v in probes.items()}
    if family == "sdxl":
        _, text_encoders, unet, _ = factory.load_models_xl(model_dir, device=device)
        added = {"text_embeds": t["pooled"], "time_ids": t["time_ids"]}
        unet_out = unet(t["latents"], t["timestep"], t["context"], added_cond_kwargs=added)
        te = text_encoders[0]
    else:
        _, te, unet, _ = factory.load_models(model_dir, device=device)
        unet_out = unet(t["latents"], t["timestep"], t["context"])
    te_out = te.model(t["input_ids"])
    acts = {"unet_out": unet_out, "text_last_hidden": te_out.last_hidden_state,
            "text_penultimate": te_out.hidden_states[-2]}
    return {k: v.float().cpu().numpy() for k, v in acts.items()}


def dump(model_dir: str, family: str, out: str, device: str = "cuda") -> None:
    acts = activations(model_dir, family, device)
    np.savez(out, **acts)
    print(f"wrote {out}: " + ", ".join(f"{k}{v.shape}" for k, v in acts.items()))


TORCH_REFERENCE_SNIPPET = r'''
# Run where torch + diffusers are installed (the reference environment):
import numpy as np, torch
from diffusers import UNet2DConditionModel
from transformers import CLIPTextModel
from sliders_conceptmod_tpu_torch.eval.parity import probe_inputs

def dump_reference_activations(model_dir, family, out):
    p = probe_inputs(family)
    unet = UNet2DConditionModel.from_pretrained(f"{model_dir}/unet").eval()
    te = CLIPTextModel.from_pretrained(f"{model_dir}/text_encoder").eval()
    with torch.no_grad():
        kwargs = {}
        if family == "sdxl":
            kwargs["added_cond_kwargs"] = {
                "text_embeds": torch.tensor(p["pooled"]),
                "time_ids": torch.tensor(p["time_ids"]),
            }
        u = unet(torch.tensor(p["latents"]), torch.tensor(p["timestep"]),
                 encoder_hidden_states=torch.tensor(p["context"]), **kwargs).sample
        t = te(torch.tensor(p["input_ids"]), output_hidden_states=True)
    np.savez(out, unet_out=u.numpy(),
             text_last_hidden=t.last_hidden_state.numpy(),
             text_penultimate=t.hidden_states[-2].numpy())
'''


def compare(a_path: str, b_path: str, atol: float = 5e-3) -> bool:
    """Each shared tensor's max-abs error and that error relative to ``b``'s
    largest value, which must stay within ``atol``; a key in one file only
    fails."""
    a, b = np.load(a_path), np.load(b_path)
    ok = True
    for k in sorted(set(a.files) & set(b.files)):
        diff = np.abs(a[k] - b[k])
        scale = np.abs(b[k]).max() + 1e-8
        line = f"{k}: max_abs={diff.max():.3e} rel={diff.max() / scale:.3e}"
        if diff.max() / scale > atol:
            ok = False
            line += "  <-- MISMATCH"
        print(line)
    missing = set(a.files) ^ set(b.files)
    if missing:
        print(f"only in one file: {sorted(missing)}")
        ok = False
    print("PARITY OK" if ok else "PARITY FAILED")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--model_dir", required=True)
    d.add_argument("--family", default="sd15")
    d.add_argument("--out", required=True)
    d.add_argument("--device", default="cuda", help="torch device: cuda (default), an ordinal, or cpu")
    c = sub.add_parser("compare")
    c.add_argument("--a", required=True)
    c.add_argument("--b", required=True)
    c.add_argument("--atol", type=float, default=5e-3)
    args = ap.parse_args(argv)
    if args.cmd == "dump":
        dump(args.model_dir, args.family, args.out, torch_device(args.device))
    else:
        raise SystemExit(0 if compare(args.a, args.b, args.atol) else 1)


if __name__ == "__main__":
    main()
