"""Times kernels K1 (flash-attention forward), K2 (dQ), K3 (dK/dV), K4a
(the k-grid forward), K4b (the k-grid dQ) and K4c (the k-grid dK/dV) on the
card at every path shape, and holds them against their plain versions; with
several ``--tree`` arguments, compares the kernels of two checkouts on one
card.

    python -m sliders_conceptmod_tpu_torch.bench_attention                 # this checkout
    python -m sliders_conceptmod_tpu_torch.bench_attention \\
        --tree build/parent --tree . --rounds 2                            # A B B A

Each tree runs in a process of its own (it imports that tree's
``sliders_conceptmod_tpu_torch.ops.flash_attention`` and ``.flash_attention_kgrid``
and builds its kernels into the tree's ``build/kernels/``); with two trees
and ``--rounds 2`` the order is A, B, B, A. Every process prints one JSON
line per shape: K1's time (CUDA events over back-to-back calls, the device
time under ``torch.profiler``, and the host microseconds per call on the
host's clock) at the serving shapes (rows 2) and the training shapes (the
student's rows); K2's and K3's at the training shapes (inputs from K1 and
K2 as the backward gets them); K4a's, and its plain version's, at the VAE
mid-block's shapes (one head of 512) and SD1.5's 1280-channel level (8 heads
of 160, run at 192); K4b's and K4c's, and their plain versions', at SD1.5's
training shapes of that level (inputs from K4a and K4b as the backward gets
them), with a ``cProfile`` breakdown of K4b's and K4c's wrapper calls at
``esd_self_256``; each kernel's max-abs error against its fp32 plain version, and
``scaled_dot_product_attention``'s forward and whole-backward device time on
the unpadded head dim as the yardstick. bf16, N(0, 1) inputs from a seeded
generator, head dims zero-padded to a multiple of 64 as ``ops/attention.py``
pads them. Each process ends with a SHA-256 of K1, K2, K3, K4a, K4b and K4c's
fp32 outputs on fixed inputs (equal across trees whose fp32 kernels compute
the same bits). Then a line with the card's name and power limit. Needs a
CUDA device: exits 2 without one.
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
# K4a's calls on the paths (chip_smoke.py's KGRID_PATH_SHAPES and KGRID_BWD_SHAPES)
KGRID_SHAPES = [
    ("vae_decode_16384", 16384, 16384, 1, 512, 1),  # serving: the decode of one 1024px image
    ("vae_decode_16384", 16384, 16384, 1, 512, 2),  # the concurrent pair's decode
    ("vae_encode_4096", 4096, 4096, 1, 512, 4),  # SDXL image pairs: one folder of four 512px images
    ("vae_encode_4096", 4096, 4096, 1, 512, 1),
    ("vae_encode_1024", 1024, 1024, 1, 512, 4),  # SD1.5 image pairs: one folder of four 256px images
    ("sd15_self_256", 256, 256, 8, 160, 1),  # SD1.5 ESD at 512px: the student (rows 1), the teacher (rows 3)
    ("sd15_cross_256x77", 256, 77, 8, 160, 1),
    ("sd15_self_64", 64, 64, 8, 160, 1),
    ("sd15_cross_64x77", 64, 77, 8, 160, 1),
    ("sd15_self_256", 256, 256, 8, 160, 3),
    ("sd15_cross_256x77", 256, 77, 8, 160, 3),
    ("sd15_pair_self_64", 64, 64, 8, 160, 2),  # SD1.5 image pairs at 256px: rows 2
    ("sd15_pair_cross_64x77", 64, 77, 8, 160, 2),
    ("sd15_pair_self_16", 16, 16, 8, 160, 2),
    ("sd15_pair_cross_16x77", 16, 77, 8, 160, 2),
]
# K4b's and K4c's calls on the SD1.5 training paths (chip_smoke.py's
# KGRID_BWD_SHAPES): (name, Sq, Sk, heads, head dim, rows)
KGRID_BWD_SHAPES = [
    ("esd_self_256", 256, 256, 8, 160, 1),  # ESD student at 512px, batch 1
    ("esd_cross_256x77", 256, 77, 8, 160, 1),
    ("esd_self_64", 64, 64, 8, 160, 1),
    ("esd_cross_64x77", 64, 77, 8, 160, 1),
    ("pair_self_64", 64, 64, 8, 160, 2),  # image-pair student at 256px, rows 2
    ("pair_cross_64x77", 64, 77, 8, 160, 2),
    ("pair_self_16", 16, 16, 8, 160, 2),
    ("pair_cross_16x77", 16, 77, 8, 160, 2),
]


def _device_ms(torch, fn, iters: int):
    """Summed durations of the kernels ``fn`` runs, per call (torch.profiler);
    a window with no device activity at all (the profiler drops one now and
    then) is taken again, up to three times, then None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if us > 0:
            return us / 1e3 / iters
    return None


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


def _host_us(torch, fn, iters: int = 100, rounds: int = 5) -> float:
    """Host microseconds of one call on the host's clock, without waiting for
    the card (the launch queue holds the calls): the median of ``rounds``
    runs of ``iters`` calls, since one run swings up to 2x on a shared host."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t) / iters * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[rounds // 2]


def _host_profile(torch, fn, iters: int = 1000, top: int = 12) -> dict:
    """Where a wrapper call's host time goes: ``cProfile`` over ``iters``
    calls, each function's own time in µs per call, the ``top`` largest
    (builtins such as a tensor's ``stride`` or the ``ctypes`` call as
    themselves). The profiler's own cost is in these times, so their sum
    exceeds the unprofiled host µs; read them as shares."""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(((tt, f"{Path(f).name}:{ln}:{name}") for (f, ln, name), (_, _, tt, _, _)
                   in pstats.Stats(prof).stats.items()), reverse=True)
    return dict(profiled_us=sum(tt for tt, _ in rows) / iters * 1e6,
                top={name: tt / iters * 1e6 for tt, name in rows[:top]})


def worker(tree: str) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import torch.nn.functional as F

    from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
    from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.build("fwd", "bwd", "kgrid", "kgrid_bwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16

    def randn(lead, d):
        x = torch.randn((*lead, d), generator=gen, device="cuda").to(dt)
        return F.pad(x, (0, -d % 64)) if d % 64 else x

    def sdpa_fwd_ms(qt, kt, vt):  # None where no backend takes the head dim
        try:
            return _device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        except RuntimeError:
            return None

    def sdpa_bwd_ms(q, k, v, do, d):
        """SDPA's whole backward on the unpadded head dim: the device time of
        forward+backward minus that of the forward (None: not measured)."""
        qr, kr, vr = (x[..., :d].transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do[..., :d].transpose(1, 2)
        fwd = lambda: F.scaled_dot_product_attention(qr, kr, vr)  # noqa: E731
        both = _device_ms(torch, lambda: torch.autograd.grad(fwd(), (qr, kr, vr), dot), 10)
        forward = _device_ms(torch, fwd, 10)
        return None if both is None or forward is None else both - forward

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
                dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
                ref, ref_delta = fa.bwd_dq_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                                     scale)
                row["k2_err"], row["k2_ref_max"] = (dq.float() - ref).abs().max().item(), ref.abs().max().item()
                row["k2_delta_err"] = (delta - ref_delta).abs().max().item()
                del dq, ref, ref_delta
                k2 = lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)  # noqa: E731
                row["k2_ms"] = _event_ms(torch, k2, iters)
                row["k2_device_ms"] = _device_ms(torch, k2, 10)
                row["k2_host_us"] = _host_us(torch, k2)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
                ref = fa.bwd_dkv_reference(q.float(), k.float(), v.float(), lse, delta, do.float(), scale)
                row["k3_err"] = max((x.float() - w).abs().max().item() for x, w in zip((dk, dv), ref))
                row["k3_ref_max"] = max(w.abs().max().item() for w in ref)
                del ref, dk, dv
                k3 = lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)  # noqa: E731
                row["k3_ms"] = _event_ms(torch, k3, iters)
                row["k3_device_ms"] = _device_ms(torch, k3, 10)
                row["k3_host_us"] = _host_us(torch, k3)
                row["sdpa_bwd_device_ms"] = sdpa_bwd_ms(q, k, v, do, d)
            print(json.dumps(row), flush=True)
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()

    for name, sq, sk, h, d, rows in KGRID_SHAPES:
        scale = d**-0.5
        q, k, v = (randn((rows, s, h), d) for s in (sq, sk, sk))
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v, scale)
        ref_o, ref_lse = kg.flash_attention_kgrid_reference(q.float(), k.float(), v.float(), scale, 1)
        row = dict(tree=tree, kind="kgrid", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                   k4a_err=(o.float() - ref_o).abs().max().item(), k4a_ref_max=ref_o.abs().max().item(),
                   k4a_lse_err=(lse - ref_lse).abs().max().item())
        del o, lse, ref_o, ref_lse
        big = rows * sq * sk >= 1 << 26
        k4a = lambda: kg.flash_attention_kgrid_fwd(q, k, v, scale)  # noqa: E731
        row["k4a_ms"] = _event_ms(torch, k4a, 3 if big else 50)
        row["k4a_device_ms"] = _device_ms(torch, k4a, 3 if big else 10)
        row["k4a_host_us"] = _host_us(torch, k4a, 10 if big else 100)
        row["k4a_plain_ms"] = _event_ms(torch, lambda: kg.flash_attention_kgrid_reference(q, k, v, scale), 2)
        row["sdpa_fwd_device_ms"] = sdpa_fwd_ms(*(x[..., :d].transpose(1, 2) for x in (q, k, v)))
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    for name, sq, sk, h, d, rows in KGRID_BWD_SHAPES:
        scale = d**-0.5
        q, do = randn((rows, sq, h), d), randn((rows, sq, h), d)
        k, v = randn((rows, sk, h), d), randn((rows, sk, h), d)
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v, scale)
        dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale)
        # fp32 plain versions over one split: the kernels' splits change only the summation order
        f = [x.float() for x in (q, k, v, o, do)]
        ref_dq, ref_delta = kg.kgrid_bwd_dq_reference(*f[:4], lse, f[4], scale)
        ref_dkv = kg.kgrid_bwd_dkv_reference(*f[:3], lse, ref_delta, f[4], scale, 1)
        row = dict(tree=tree, kind="kgrid_bwd", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                   k4b_err=(dq.float() - ref_dq).abs().max().item(), k4b_ref_max=ref_dq.abs().max().item(),
                   k4b_delta_err=(delta - ref_delta).abs().max().item(),
                   k4c_err=max((x.float() - w).abs().max().item() for x, w in zip((dk, dv), ref_dkv)),
                   k4c_ref_max=max(w.abs().max().item() for w in ref_dkv))
        del dq, dk, dv, f, ref_dq, ref_delta, ref_dkv
        k4b = lambda: kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)  # noqa: E731
        k4c = lambda: kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale)  # noqa: E731
        for kern, fn in (("k4b", k4b), ("k4c", k4c)):
            row[f"{kern}_ms"] = _event_ms(torch, fn, 50)
            row[f"{kern}_device_ms"] = _device_ms(torch, fn, 10)
            row[f"{kern}_host_us"] = _host_us(torch, fn)
            if name == "esd_self_256":
                row[f"{kern}_host_profile"] = _host_profile(torch, fn)
        row["k4b_plain_ms"] = _event_ms(torch, lambda: kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale), 5)
        row["k4c_plain_ms"] = _event_ms(
            torch, lambda: kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, scale), 5)
        row["sdpa_bwd_device_ms"] = sdpa_bwd_ms(q, k, v, do, d)
        print(json.dumps(row), flush=True)
        del q, k, v, o, lse, do, delta
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
    # K4a: the ragged JAX-test shape, one 512px image's encode (split 3 ways), d 192
    for b, sq, sk, h, d in ((2, 300, 77, 2, 512), (1, 4096, 4096, 1, 512), (1, 256, 77, 8, 192)):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda") for s in (sq, sk, sk))
        for t in kg.flash_attention_kgrid_fwd(q, k, v):
            digest.update(t.cpu().contiguous().numpy().tobytes())
    # K4b and K4c: the ragged JAX-test shape at d 512 (K4c split 2 ways), SD1.5's 256x77 and 256^2 at d 192
    for b, sq, sk, h, d in ((2, 300, 77, 2, 512), (1, 256, 77, 8, 192), (1, 256, 256, 8, 192)):
        q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda") for _ in range(2))
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
        for t in kg.flash_attention_kgrid_bwd(q, k, v, o, lse, do, d**-0.5):
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
