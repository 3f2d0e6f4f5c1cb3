"""Times kernels K1 (flash-attention forward), K2 (dQ), K3 (dK/dV), K4a
(the k-grid forward), K4b (the k-grid dQ) and K4c (the k-grid dK/dV) on the
card at every path shape, and holds them against their plain versions; with
several ``--tree`` arguments, compares the kernels of two checkouts on one
card.

    python -m sliders_conceptmod_tpu_torch.bench_attention                 # this checkout
    python -m sliders_conceptmod_tpu_torch.bench_attention \\
        --tree build/parent --tree . --rounds 2                            # A B B A
    python -m sliders_conceptmod_tpu_torch.bench_attention \\
        --tree build/parent --tree . --sections fp32,edit,digest           # the fp32 edit path

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
the same bits), and one of their bf16 outputs (equal across trees whose
bf16 kernels compute the same bits). Then a line with the card's name and
power limit. Needs a CUDA device: exits 2 without one.

``--sections`` picks what each process runs (default: ``kernels``, ``fp32``
and ``digest``):
``kernels`` (the bf16 rows above), ``fp32`` (all six kernels in fp32 at the
shapes of null-text inversion editing, SD1.5 at 512px, 8 heads: K1/K2/K3 at
4096 and 1024 queries against themselves and 77 keys, head dims 40 and 80
padded to 64 and 128; K4a/K4b/K4c at 256 and 64 queries, 160 padded to 192;
each against its plain version, its fp32 bound and SDPA in fp32 with the
efficient backend pinned; then K4a alone at the fp32 VAEs' mid-block, one
head of 512 at 4096² (SD1.5's encode and decode in the edit) and 16384²
(SD3's 1024px decode), against SDPA's efficient backend or, where that
refuses d 512, the backend that takes it, named), ``edit`` (one null-text inner step of the
full-width SD1.5 UNet in fp32 with seeded weights, profiled, and the
launches of a demo-default edit; then the tree's ``chip_smoke.py`` edit
phase over the directory its load phase writes), ``smoke`` (the seconds of
the tree's ``chip_smoke.py`` kernel and kernel_kgrid phases, run as its main
runs them: what the smoke's kernel checks cost against its time limit) and
``digest``.
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
# null-text inversion editing (demos/demo_image_editing.py: SD1.5 at 512px in
# fp32, 8 heads): every attention of an inner step, (name, Sq, Sk, heads, head
# dim, rows). Head dims 40 and 80 run K1/K2/K3 padded to 64 and 128, 160 runs
# K4a/K4b/K4c padded to 192
EDIT_SHAPES = [
    ("edit_self_4096", 4096, 4096, 8, 40, 1),
    ("edit_cross_4096x77", 4096, 77, 8, 40, 1),
    ("edit_self_1024", 1024, 1024, 8, 80, 1),
    ("edit_cross_1024x77", 1024, 77, 8, 80, 1),
    ("edit_self_256", 256, 256, 8, 160, 1),
    ("edit_cross_256x77", 256, 77, 8, 160, 1),
    ("edit_self_64", 64, 64, 8, 160, 1),
    ("edit_cross_64x77", 64, 77, 8, 160, 1),
]
# K4a in fp32 at the VAE mid-block (one head of 512, rows 1): SD1.5's encode
# and decode of a 512px image in the edit, SD3's 1024px decode
FP32_VAE_SHAPES = [("vae_mid_4096", 4096, 4096, 1, 512, 1), ("sd3_decode_16384", 16384, 16384, 1, 512, 1)]
# the demo's defaults: 50 DDIM steps, at most 10 null-text inner steps each, scales 0, 2, 4
EDIT_STEPS, EDIT_INNER_STEPS, EDIT_SCALES = 50, 10, 3
# the least time of fp32-accurate work on the H100: products as three TF32
# tensor-core passes (494.7 TFLOP/s / 3), bytes at HBM3's rate
FP32_PEAK_FLOPS, PEAK_BYTES = 494.7e12 / 3, 3.35e12
SECTIONS = ("kernels", "fp32", "edit", "smoke", "digest")


def fp32_bound(kind: str, bh: int, sq: int, sk: int, d: int) -> tuple:
    """Least time of one fp32 call, ms, and what bounds it: K1/K4a ("fwd",
    4·BH·Sq·Sk·d flops), K2/K4b ("dq", 6·) or K3/K4c ("dkv", 8·) at the
    unpadded head dim, against each input read once and each output written
    once (fp32 tensors, lse and δ)."""
    mult, nbytes = {"fwd": (4, 4 * bh * d * (2 * sq + 2 * sk) + 4 * bh * sq),
                    "dq": (6, 4 * bh * d * (4 * sq + 2 * sk) + 8 * bh * sq),
                    "dkv": (8, 4 * bh * d * (2 * sq + 4 * sk) + 8 * bh * sq)}[kind]
    t_ops, t_bytes = mult * bh * sq * sk * d / FP32_PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def worker(tree: str, sections) -> int:
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

    def randn(lead, d, dtype=dt):
        x = torch.randn((*lead, d), generator=gen, device="cuda").to(dtype)
        return F.pad(x, (0, -d % 64)) if d % 64 else x

    def sdpa_fwd_ms(qt, kt, vt, iters: int = 10):  # None where no backend takes the head dim
        try:
            return _device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
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

    def kernels():
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

    def fp32():
        """All six kernels in fp32 at EDIT_SHAPES: device time against the
        fp32 bound, the plain version's time and SDPA's fp32 time (efficient
        backend pinned: its forward for K1/K4a, its whole backward for the
        K2+K3 and K4b+K4c pairs), each output against its plain version."""
        from torch.nn.attention import SDPBackend, sdpa_kernel

        def pinned(fn, backends=("EFFICIENT_ATTENTION",)):
            """``fn()`` (an SDPA time) with SDPA pinned to the first of
            ``backends`` that takes the call, and that backend's name; (None,
            None) where none does."""
            for name in backends:
                try:
                    with sdpa_kernel([getattr(SDPBackend, name)]):
                        ms = fn()
                except RuntimeError:
                    ms = None
                if ms is not None:
                    return ms, name
            return None, None

        for name, sq, sk, h, d, rows in EDIT_SHAPES:
            scale = d**-0.5
            q, do = randn((rows, sq, h), d, torch.float32), randn((rows, sq, h), d, torch.float32)
            k, v = randn((rows, sk, h), d, torch.float32), randn((rows, sk, h), d, torch.float32)
            if d <= 128:
                ids = ("k1", "k2", "k3")
                fwd, bwd_dq, bwd_dkv = fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv
                plain = (fa.flash_attention_reference, fa.bwd_dq_reference, fa.bwd_dkv_reference)
            else:
                ids = ("k4a", "k4b", "k4c")
                fwd, bwd_dq, bwd_dkv = (kg.flash_attention_kgrid_fwd, kg.flash_attention_kgrid_bwd_dq,
                                        kg.flash_attention_kgrid_bwd_dkv)
                plain = (kg.flash_attention_kgrid_reference, kg.kgrid_bwd_dq_reference, kg.kgrid_bwd_dkv_reference)
            o, lse = fwd(q, k, v, scale)
            dq, delta = bwd_dq(q, k, v, o, lse, do, scale)
            dk, dv = bwd_dkv(q, k, v, lse, delta, do, scale)
            torch.cuda.synchronize()
            # the plain versions cut the splits as the wrappers chose them for fp32
            want = (plain[0](q, k, v, scale), plain[1](q, k, v, o, lse, do, scale),
                    plain[2](q, k, v, lse, delta, do, scale))
            row = dict(tree=tree, kind="fp32", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                       padded_head_dim=q.shape[-1])
            pick = getattr(fa, "pick_k1_splits", None)  # a tree before the 3xTF32 K1 has no K1 split
            row[f"{ids[0]}_splits"] = (pick(rows * h, sq, sk, torch.float32) if pick else 1) if d <= 128 else \
                kg.pick_splits(rows * h, sq, sk, torch.float32)
            for kern, got, ref in zip(ids, ((o, lse), (dq, delta), (dk, dv)), want):
                row[f"{kern}_err"] = max((x - w).abs().max().item() for x, w in zip(got, ref))
                row[f"{kern}_tol"] = 1e-4 * max(1.0, max(w.abs().max().item() for w in ref))
            del dq, dk, dv, want
            iters = 10 if sq * sk >= 1 << 24 else 50
            calls = (lambda: fwd(q, k, v, scale), lambda: bwd_dq(q, k, v, o, lse, do, scale),
                     lambda: bwd_dkv(q, k, v, lse, delta, do, scale))
            plain_calls = (lambda: plain[0](q, k, v, scale), lambda: plain[1](q, k, v, o, lse, do, scale),
                           lambda: plain[2](q, k, v, lse, delta, do, scale))
            bh = rows * h
            for kern, fn, plain_fn, kind in zip(ids, calls, plain_calls, ("fwd", "dq", "dkv")):
                row[f"{kern}_ms"] = _event_ms(torch, fn, iters)
                row[f"{kern}_device_ms"] = _device_ms(torch, fn, iters)
                row[f"{kern}_plain_ms"] = _event_ms(torch, plain_fn, 3)
                row[f"{kern}_bound_ms"], row[f"{kern}_bound_by"] = fp32_bound(kind, bh, sq, sk, d)
                dev = row[f"{kern}_device_ms"]
                row[f"{kern}_share_of_bound"] = row[f"{kern}_bound_ms"] / dev if dev else None
            qt, kt, vt = (x[..., :d].transpose(1, 2) for x in (q, k, v))
            row["sdpa_fwd_device_ms"] = pinned(lambda: sdpa_fwd_ms(qt, kt, vt))[0]
            row["sdpa_bwd_device_ms"] = pinned(lambda: sdpa_bwd_ms(q, k, v, do, d))[0]
            pair = [row[f"{kern}_device_ms"] for kern in ids[1:]]
            row["bwd_pair_device_ms"] = sum(pair) if all(pair) else None
            for key, ms, lib in (("fwd_over_sdpa", row[f"{ids[0]}_device_ms"], row["sdpa_fwd_device_ms"]),
                                 ("bwd_pair_over_sdpa", row["bwd_pair_device_ms"], row["sdpa_bwd_device_ms"])):
                row[key] = ms / lib if ms and lib else None
            print(json.dumps(row), flush=True)
            del q, k, v, o, lse, do, delta
            torch.cuda.empty_cache()

        for name, sq, sk, h, d, rows in FP32_VAE_SHAPES:
            scale = d**-0.5
            q, k, v = (randn((rows, s, h), d, torch.float32) for s in (sq, sk, sk))
            fwd = lambda: kg.flash_attention_kgrid_fwd(q, k, v, scale)  # noqa: E731
            got, want = fwd(), kg.flash_attention_kgrid_reference(q, k, v, scale)
            row = dict(tree=tree, kind="fp32_vae", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                       k4a_splits=kg.pick_splits(rows * h, sq, sk, torch.float32),
                       k4a_err=max((x - w).abs().max().item() for x, w in zip(got, want)),
                       k4a_tol=1e-4 * max(1.0, max(w.abs().max().item() for w in want)))
            del got, want
            row["k4a_ms"] = _event_ms(torch, fwd, 3)
            row["k4a_device_ms"] = _device_ms(torch, fwd, 3)
            row["k4a_plain_ms"] = _event_ms(torch, lambda: kg.flash_attention_kgrid_reference(q, k, v, scale), 2)
            row["k4a_bound_ms"], row["k4a_bound_by"] = fp32_bound("fwd", rows * h, sq, sk, d)
            dev = row["k4a_device_ms"]
            row["k4a_share_of_bound"] = row["k4a_bound_ms"] / dev if dev else None
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["sdpa_fwd_device_ms"], row["sdpa_backend"] = pinned(lambda: sdpa_fwd_ms(qt, kt, vt, 3),
                                                                    ("EFFICIENT_ATTENTION", "MATH"))
            lib = row["sdpa_fwd_device_ms"]
            row["fwd_over_sdpa"] = dev / lib if dev and lib else None
            print(json.dumps(row), flush=True)
            del q, k, v
            torch.cuda.empty_cache()

    def edit():
        """One null-text inner step (the full-width SD1.5 UNet in fp32,
        seeded weights, a 64x64 latent: forward with the null embedding as
        the leaf, the loss, its gradient) under the profiler: wall ms,
        device busy ms, each kernel's share of it; the launches of one
        forward and one inner step, and of a demo-default edit. Then the
        tree's chip_smoke.py load and edit phases (their own JSON rows)."""
        import tempfile

        from sliders_conceptmod_tpu_torch.models import factory
        from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
        from torch.profiler import ProfilerActivity, profile

        wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                    kg.flash_attention_kgrid_fwd, kg.flash_attention_kgrid_bwd_dq, kg.flash_attention_kgrid_bwd_dkv)
        counts = lambda: [w.launches for w in wrappers]  # noqa: E731
        unet = factory.build_module(lambda: UNet2DConditionModel(UNetConfig.sd15()), "cuda", torch.float32, 1)
        g = torch.Generator(device="cuda").manual_seed(2)
        lat = torch.randn((1, 4, 64, 64), generator=g, device="cuda")
        emb = torch.randn((1, 77, 768), generator=g, device="cuda")

        def inner_step():
            leaf = emb.detach().requires_grad_(True)
            loss = torch.mean(unet(lat, 500, leaf).float() ** 2)
            return torch.autograd.grad(loss, [leaf])[0]

        before = counts()
        with torch.no_grad():
            unet(lat, 500, emb)
        per_forward = [a - b for a, b in zip(counts(), before)]
        before = counts()
        inner_step()
        torch.cuda.synchronize()
        per_inner = [a - b for a, b in zip(counts(), before)]
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            inner_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            inner_step()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        # kernel names by substring, as chip_smoke.py's profiles read them
        groups = {"k1": ("flash_fwd_kernel", "flash_fwd_tc_kernel", "flash_fwd_tf32_kernel", "flash_fwd_merge_kernel"),
                  "k2": ("flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dq_tf32_kernel",
                         "flash_dq_merge_kernel"),
                  "k3": ("flash_bwd_dkv_kernel", "flash_bwd_dkv_tc_kernel", "flash_bwd_dkv_tf32_kernel",
                         "flash_dkv_merge_kernel"),
                  "k4a": ("kgrid_fwd_kernel", "kgrid_fwd_tc_kernel", "kgrid_fwd_tf32_kernel", "kgrid_merge_kernel"),
                  "k4b": ("kgrid_bwd_dq_kernel", "kgrid_bwd_dq_tc_kernel", "kgrid_bwd_dq_tf32_kernel",
                          "kgrid_dq_merge_kernel"),
                  "k4c": ("kgrid_bwd_dkv_kernel", "kgrid_bwd_dkv_tc_kernel", "kgrid_bwd_dkv_tf32_kernel",
                          "kgrid_dkv_merge_kernel")}
        row = dict(tree=tree, kind="edit_inner_step", model="SD1.5 UNet, fp32, 64x64 latent, seeded weights",
                   wall_ms=sorted(walls)[1], device_busy_ms=busy if busy else "not measured",
                   launches_per_forward=dict(zip(groups, per_forward)),
                   launches_per_inner_step=dict(zip(groups, per_inner)))
        for key, names in groups.items():
            ms = sum(v for n, v in by_name.items() if any(x in n for x in names))
            row[f"{key}_ms"] = ms
            row[f"{key}_share_of_busy"] = ms / busy if busy else "not measured"
        row["top_kernels"] = [dict(name=n[:100], ms=v) for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]
        # a demo-default edit: the inversion's 50 forwards; per null-text step a conditional
        # forward, at most 10 inner steps (each a forward and a backward) and a guided
        # forward; 2 x 50 forwards per scale; one VAE encode and one decode per scale run
        # K4a once each
        inner, forwards = EDIT_STEPS * EDIT_INNER_STEPS, EDIT_STEPS * (3 + 2 * EDIT_SCALES)
        row["launches_per_default_edit"] = {
            key: (forwards + inner) * f + inner * (i - f) + (1 + EDIT_SCALES if key == "k4a" else 0)
            for key, f, i in zip(groups, per_forward, per_inner)}
        print(json.dumps(row), flush=True)
        del unet
        torch.cuda.empty_cache()

        import chip_smoke  # the tree's own smoke

        torch.backends.cudnn.allow_tf32 = False  # as the smoke's main sets it: its controller checks read fp32
        with tempfile.TemporaryDirectory() as tmp:
            sd_dir = chip_smoke.phase_load(Path(tmp))
            chip_smoke.phase_edit(Path(tmp), sd_dir)

    def smoke():
        import chip_smoke  # the tree's own smoke

        gen = torch.Generator(device="cuda").manual_seed(0)  # as the smoke's main seeds these phases
        for phase in (chip_smoke.phase_kernel, chip_smoke.phase_kernel_kgrid):
            torch.cuda.synchronize()
            t = time.perf_counter()
            phase(gen)
            torch.cuda.synchronize()
            print(json.dumps(dict(tree=tree, kind="smoke_phase", phase=phase.__name__,
                                  seconds=time.perf_counter() - t)), flush=True)

    def digest(dtype) -> str:
        """SHA-256 of K1, K2, K3, K4a, K4b and K4c's outputs in ``dtype`` on
        fixed inputs: two trees whose kernels compute the same bits print
        the same digest."""
        gen = torch.Generator(device="cuda").manual_seed(1)
        sha = hashlib.sha256()

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        def add(*tensors):
            for t in tensors:
                sha.update(t.float().cpu().contiguous().numpy().tobytes())

        for b, sq, sk, h, d in ((2, 300, 77, 3, 64), (1, 1024, 1024, 10, 64), (1, 256, 256, 8, 128)):
            q, do, k, v = rand(b, sq, h, d), rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
            o, lse = fa.flash_attention_fwd(q, k, v)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, d**-0.5)
            add(o, lse, dq, delta, *fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, d**-0.5))
        # K4a: the ragged JAX-test shape, one 512px image's encode (split 3 ways), d 192
        for b, sq, sk, h, d in ((2, 300, 77, 2, 512), (1, 4096, 4096, 1, 512), (1, 256, 77, 8, 192)):
            add(*kg.flash_attention_kgrid_fwd(rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)))
        # K4b and K4c: the ragged JAX-test shape at d 512 (K4c split 2 ways), SD1.5's 256x77 and 256^2 at d 192
        for b, sq, sk, h, d in ((2, 300, 77, 2, 512), (1, 256, 77, 8, 192), (1, 256, 256, 8, 192)):
            q, do, k, v = rand(b, sq, h, d), rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
            o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
            add(*kg.flash_attention_kgrid_bwd(q, k, v, o, lse, do, d**-0.5))
        return sha.hexdigest()

    if "kernels" in sections:
        kernels()
    if "fp32" in sections:
        fp32()
    if "edit" in sections:
        edit()
    if "smoke" in sections:
        smoke()
    if "digest" in sections:
        print(json.dumps(dict(tree=tree, fp32_sha256=digest(torch.float32), bf16_sha256=digest(torch.bfloat16))),
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="checkout root (repeatable; default: this one)")
    ap.add_argument("--rounds", type=int, default=1, help="with two trees: 2 runs A B B A")
    ap.add_argument("--sections", default="kernels,fp32,digest",
                    help=f"comma-separated, of {','.join(SECTIONS)} (default: kernels,fp32,digest)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    if set(sections) - set(SECTIONS):
        ap.error(f"unknown section in {args.sections!r}; choose from {SECTIONS}")
    if args.worker:
        return worker(args.worker, sections)
    trees = args.tree or [str(Path(__file__).resolve().parents[1])]
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", tree,
                             "--sections", args.sections], env=env).returncode
        if rc != 0:
            return rc
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
