"""Times kernels K1 (flash-attention forward) and K3 (dK/dV) on the card at
every path shape, and holds them against their plain versions; with several
``--tree`` arguments, compares the kernels of two checkouts on one card.

    python -m sliders_conceptmod_tpu_torch.bench_attention                 # this checkout
    python -m sliders_conceptmod_tpu_torch.bench_attention \\
        --tree build/parent --tree . --rounds 2                            # A B B A

Each tree runs in a process of its own (it imports that tree's
``sliders_conceptmod_tpu_torch.ops.flash_attention`` and builds its kernels
into the tree's ``build/kernels/``); with two trees and ``--rounds 2`` the
order is A, B, B, A. Every process prints one JSON line per shape: K1's time
(CUDA events over back-to-back calls, the device time under
``torch.profiler``, and the host microseconds per call on the host's clock)
at the serving shapes (rows 2) and the training shapes (the student's rows),
K3's at the training shapes (inputs from K1 and K2 as the backward gets
them), each kernel's max-abs error against its fp32 plain
version, and ``scaled_dot_product_attention``'s forward and whole-backward
device time on the unpadded head dim as the yardstick. bf16, N(0, 1) inputs
from a seeded generator, head dims zero-padded to 64/128 as
``ops/attention.py`` pads them. Each process ends with a SHA-256 of K1, K2
and K3's fp32 outputs on fixed inputs (equal across trees whose fp32
kernels compute the same bits). Then a line with the card's name and power
limit. Needs a CUDA device: exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (name, Sq, Sk, heads, head dim, rows): SDXL serving at 1024px (rows 2 with CFG)
SERVE_SHAPES = [
    ("serve_self_4096", 4096, 4096, 10, 64, 2),
    ("serve_cross_4096x77", 4096, 77, 10, 64, 2),
    ("serve_self_1024", 1024, 1024, 20, 64, 2),
    ("serve_cross_1024x77", 1024, 77, 20, 64, 2),
]
# the training paths' d <= 128 attentions at the student's rows (chip_smoke.py's TRAIN_SHAPES)
TRAIN_SHAPES = [
    ("self_1024", 1024, 1024, 10, 64, 1),
    ("cross_1024x77", 1024, 77, 10, 64, 1),
    ("self_256", 256, 256, 20, 64, 1),
    ("cross_256x77", 256, 77, 20, 64, 1),
    ("sd15_self_4096", 4096, 4096, 8, 40, 1),
    ("sd15_cross_4096x77", 4096, 77, 8, 40, 1),
    ("sd15_self_1024", 1024, 1024, 8, 80, 1),
    ("sd15_cross_1024x77", 1024, 77, 8, 80, 1),
    ("sd15_pair_self_1024", 1024, 1024, 8, 40, 2),
    ("sd15_pair_cross_1024x77", 1024, 77, 8, 40, 2),
    ("sd15_pair_self_256", 256, 256, 8, 80, 2),
    ("sd15_pair_cross_256x77", 256, 77, 8, 80, 2),
    ("sd21_self_4096", 4096, 4096, 5, 64, 1),
]


def _device_ms(torch, fn, iters: int) -> float:
    """Summed durations of the kernels ``fn`` runs, per call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return us / 1e3 / iters


def _event_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(torch, fn, iters: int = 100) -> float:
    """Host microseconds of one call on the host's clock, without waiting for
    the card (the launch queue holds the 100 calls)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def worker(tree: str) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import torch.nn.functional as F

    from sliders_conceptmod_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.build("fwd", "bwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16

    def randn(lead, d):
        x = torch.randn((*lead, d), generator=gen, device="cuda").to(dt)
        return F.pad(x, (0, -d % 64)) if d % 64 else x

    for kind, shapes in (("serve", SERVE_SHAPES), ("train", TRAIN_SHAPES)):
        for name, sq, sk, h, d, rows in shapes:
            scale = d**-0.5
            q, do = randn((rows, sq, h), d), randn((rows, sq, h), d)
            k, v = randn((rows, sk, h), d), randn((rows, sk, h), d)
            o, lse = fa.flash_attention_fwd(q, k, v, scale)
            ref_o, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), scale)
            row = dict(tree=tree, kind=kind, shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                       k1_err=(o.float() - ref_o).abs().max().item(), k1_ref_max=ref_o.abs().max().item(),
                       k1_lse_err=(lse - ref_lse).abs().max().item())
            del ref_o, ref_lse
            iters = 20 if sk > 77 else 50
            row["k1_ms"] = _event_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale), iters)
            row["k1_device_ms"] = _device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale), 10)
            row["k1_host_us"] = _host_us(torch, lambda: fa.flash_attention_fwd(q, k, v, scale))
            qt, kt, vt = (x[..., :d].transpose(1, 2) for x in (q, k, v))
            row["sdpa_fwd_device_ms"] = _device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
            if kind == "train":
                _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
                ref = fa.bwd_dkv_reference(q.float(), k.float(), v.float(), lse, delta, do.float(), scale)
                row["k3_err"] = max((x.float() - w).abs().max().item() for x, w in zip((dk, dv), ref))
                row["k3_ref_max"] = max(w.abs().max().item() for w in ref)
                del ref, dk, dv
                k3 = lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)  # noqa: E731
                row["k3_ms"] = _event_ms(torch, k3, iters)
                row["k3_device_ms"] = _device_ms(torch, k3, 10)
                row["k3_host_us"] = _host_us(torch, k3)
                qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
                dot = do[..., :d].transpose(1, 2)
                fwd = lambda: F.scaled_dot_product_attention(qg, kg, vg)  # noqa: E731
                row["sdpa_bwd_device_ms"] = (_device_ms(torch, lambda: torch.autograd.grad(fwd(), (qg, kg, vg), dot), 10)
                                             - _device_ms(torch, fwd, 10))
            print(json.dumps(row), flush=True)
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()

    # fp32 runs the first (SIMT) kernels: a digest of their outputs on fixed
    # inputs, which two trees with the same fp32 kernels print alike
    gen = torch.Generator(device="cuda").manual_seed(1)
    digest = hashlib.sha256()
    for b, sq, sk, h, d in ((2, 300, 77, 3, 64), (1, 1024, 1024, 10, 64), (1, 256, 256, 8, 128)):
        q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda") for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, d**-0.5)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, d**-0.5)
        for t in (o, lse, dq, delta, dk, dv):
            digest.update(t.cpu().contiguous().numpy().tobytes())
    print(json.dumps(dict(tree=tree, fp32_sha256=digest.hexdigest())), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="checkout root (repeatable; default: this one)")
    ap.add_argument("--rounds", type=int, default=1, help="with two trees: 2 runs A B B A")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    trees = args.tree or [str(Path(__file__).resolve().parents[1])]
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", tree], env=env).returncode
        if rc != 0:
            return rc
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
