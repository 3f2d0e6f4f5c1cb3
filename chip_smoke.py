#!/usr/bin/env python3
"""Smoke of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build        — compile K1 (csrc/flash_attention_fwd.cu), K2/K3
                  (csrc/flash_attention_bwd.cu) and K4a
                  (csrc/flash_attention_kgrid.cu) with nvcc for sm_90a, one
                  nvcc per source, started together; seconds, registers and
                  spills per kernel, card name and power limit.
2. kernel       — K1 against its plain PyTorch version on the card at the four
                  attention shapes of 1024px SDXL serving with CFG (one
                  request, 2 rows), in bf16 and in fp32; max-abs error,
                  kernel_ms, plain_ms, library_ms (F.scaled_dot_product_attention,
                  timed as a yardstick only), bound_ms.
3. kernel_bwd   — K2 (dQ) and K3 (dK, dV) against their plain versions at the
                  four attention shapes of 512px SDXL training (batch 1), bf16
                  and fp32, plus ragged (Sq 65; Sk 77, 129) and strided-dO
                  cases; error per gradient, kernel_ms, plain_ms, bound_ms and
                  library_ms (SDPA's backward: forward+backward minus forward).
                  K1's out and lse, which K2/K3 take, are held against the
                  plain version at the same shapes, at batch 1 (warm-up and
                  student) and 3 (the teacher's rows).
4. kernel_kgrid — K4a (O and lse) against its plain version at the VAE
                  mid-block's shapes (one head, d 512): 16384² at rows 1 and 2
                  (the 1024px decode of serving), 4096² at rows 4 (the 512px
                  encode of one image folder) and rows 1, bf16 and fp32; ragged
                  Sq 300 × Sk 77 (B 2, H 2, d 64 and 512); the key-range split
                  forced to 1 and to more than 1. Times the kernel, its plain
                  version and SDPA (a yardstick) at every path shape in bf16.
5. parity       — the tiny-xl sampler on the card (K1 inside every UNet
                  attention) against the same weights and inputs on the CPU.
6. train_parity — one tiny-xl ESD step on the card (K1/K2/K3 inside) against
                  the same step on the CPU: weights, LoRA factors, draws, fp32.
7. imageslider_parity — the image bank through the full SDXL VAE at 64px (K4a
                  in the encoder's mid-block) and one tiny-xl image-pair step
                  (K1/K2/K3) on the card against the same on the CPU, fp32.
8. serve        — full-width SDXL (random weights from a seed) at 1024px, 25 DDIM
                  steps: a rank-4 slider made with create_sites, written with the
                  port's .safetensors writer and loaded through add_slider; four
                  requests (scale 0, +2, and -2/+1 concurrently in one micro-batch);
                  K1's launch count per sampler call and K4a's per decode;
                  latency, images/s, peak memory.
9. http         — one /generate through make_handler on localhost.
10. profile     — one more request under torch.profiler: device busy time,
                  the idle share, and the kernels that take the device time.
11. train       — full-width SDXL ESD slider training at 512px through
                  trainer.train from data/config-xl.yaml + data/prompts-xl.yaml
                  (only train.iterations and save.path overridden): finite
                  losses, moving factors, the saved file's keys, K1/K2/K3
                  launch counts per step, steps/s, first-step seconds, peak
                  memory; then one more step under torch.profiler.
12. imageslider — full-width SDXL image-pair slider training at 512px through
                  cli/train_lora_scale.train from the same YAML files, four
                  folders of four synthetic PNGs at scales -2, -1, 1, 2: bank
                  build seconds, K4a launches at the bank build, K1/K2/K3 per
                  step, losses, moving factors, saved keys, steps/s, first
                  step, peak memory; then one more step under torch.profiler.
13. kernels     — every ported kernel with its launches on its paths (serving:
                  phases 8 and 9; training: phase 11; image-pair training:
                  phase 12; each counted from 0 just before it). On every
                  path the plain attention versions ran 0 times on the card.

Then the card as nvidia-smi names it, and the result line.
"""

from __future__ import annotations

import copy
import functools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sliders_conceptmod_tpu_torch.adapters import lora
from sliders_conceptmod_tpu_torch.cli import train_lora_scale
from sliders_conceptmod_tpu_torch.core.config import load_config_from_yaml
from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings, load_prompts_from_yaml
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.infer.generate import sample_loop_scales
from sliders_conceptmod_tpu_torch.io.png import decode_png, encode_png
from sliders_conceptmod_tpu_torch.io.safetensors import load_file
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from sliders_conceptmod_tpu_torch.serve import SliderService, make_handler
from sliders_conceptmod_tpu_torch.train import esd, imageslider, trainer
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# K1 and K4a vs their fp32 plain versions. fp32: the same math up to
# summation order (1e-4 flat; at most the 1e-4·max(1, max|ref|) asked of K4a).
# bf16: rounding the output alone costs up to 2^-8·|out|, so the bound is
# 2e-2 of the reference's largest value (and never above 3e-2). At 4096² with
# N(0,1) inputs the output's typical value is ~sqrt(e/4096) ≈ 0.026 and this
# bound ~10× smaller, so a dropped K tile or a wrong P·V fails it.
FP32_TOL, BF16_REL, BF16_TOL = 1e-4, 2e-2, 3e-2
LSE_TOL = 1e-3
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
IMAGE_SIZE, STEPS = 1024, 25
# (name, Sq, Sk, heads): the attention calls of one SDXL UNet forward at 1024px
PATH_SHAPES = [
    ("self_4096", 4096, 4096, 10),
    ("cross_4096x77", 4096, 77, 10),
    ("self_1024", 1024, 1024, 20),
    ("cross_1024x77", 1024, 77, 20),
]
# ... and at 512px, the training resolution of data/config-xl.yaml
TRAIN_SHAPES = [
    ("self_1024", 1024, 1024, 10),
    ("cross_1024x77", 1024, 77, 10),
    ("self_256", 256, 256, 20),
    ("cross_256x77", 256, 77, 20),
]
TRAIN_ITERATIONS = 6
# (name, rows, tokens): K4a's calls on the paths, the VAE mid-block attention
# (one head, head dim = channels = 512)
KGRID_D = 512
KGRID_PATH_SHAPES = [
    ("decode_16384", 1, 16384),  # serving: the decode of one 1024px image
    ("decode_16384", 2, 16384),  # serving: the concurrent pair's decode
    ("encode_4096", 4, 4096),  # image-pair training: one folder of four 512px images
    ("encode_4096", 1, 4096),  # one image: the launcher splits the key range
]
# image-pair training: folder i holds the renders at IMAGE_SCALES[i]
IMAGE_FOLDERS = ["minus2", "minus1", "plus1", "plus2"]
IMAGE_SCALES = [-2.0, -1.0, 1.0, 2.0]
IMAGES_PER_FOLDER = 4
REPO = Path(__file__).resolve().parent


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(info: dict) -> list:
    """Registers and spill bytes per compiled kernel, from nvcc's -Xptxas -v."""
    out = []
    for lib in info.values():
        fn = None
        for line in lib.get("ptxas", "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                out.append(dict(kernel=fn, spill_stores=int(m.group(1)), spill_loads=int(m.group(2))))
            m = re.search(r"Used (\d+) registers", line)
            if m and out and out[-1]["kernel"] == fn:
                out[-1]["registers"] = int(m.group(1))
    return out


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(rows: int, sq: int, sk: int, h: int, d: int, dtype) -> tuple:
    """Least time the card needs for one call: max(flops / peak, bytes / HBM rate)."""
    flops = 4 * rows * h * sq * sk * d
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * rows * h * d * (2 * sq + 2 * sk) + 4 * rows * h * sq  # q,k,v,o + lse
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_bound(kind: str, sq: int, sk: int, h: int, d: int, dtype) -> tuple:
    """Least time for K2 ("dq": 6·BH·Sq·Sk·D flops) or K3 ("dkv": 8·BH·Sq·Sk·D):
    max(flops / peak, bytes / HBM rate), batch 1; bytes are the kernel's
    inputs (q, k, v, o, dO, lse, δ) read once and its outputs written once."""
    item = torch.empty((), dtype=dtype).element_size()
    if kind == "dq":  # q, o, dO in, dQ out; k, v in; lse in, δ out
        flops, nbytes = 6 * h * sq * sk * d, item * h * d * (4 * sq + 2 * sk) + 8 * h * sq
    else:  # q, dO in; k, v in, dK, dV out; lse, δ in
        flops, nbytes = 8 * h * sq * sk * d, item * h * d * (2 * sq + 4 * sk) + 8 * h * sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def grad_tol(ref: torch.Tensor, dtype) -> float:
    """K2/K3 vs their fp32 plain version. fp32 as K1. bf16: rounding the
    gradient alone costs up to 2^-8 of its value, so 2e-2 of the largest —
    with no 3e-2 cap, since gradients are not bounded as softmax outputs are
    (bf16 rounding alone passes 3e-2 once |dK| or |dV| is above ~8) — and
    never below the fp32 bound. The same bound as tests/test_torch_cuda.py."""
    m = ref.abs().max().item()
    return FP32_TOL * max(1.0, m) if dtype == torch.float32 else max(FP32_TOL, BF16_REL * m)


def check_fwd(name: str, kernel, plain, q, k, v, what: str) -> dict:
    """A forward kernel (K1 or K4a) against its plain version on q, k, v in
    fp32; raises on disagreement. Returns (out, lse) and the errors with their
    bounds."""
    d = q.shape[-1]
    out, lse = kernel(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = plain(q.float(), k.float(), v.float(), d**-0.5)
    err = (out.float() - ref_out).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ref_max = ref_out.abs().max().item()
    tol = min(BF16_TOL, BF16_REL * ref_max) if q.dtype == torch.bfloat16 else FP32_TOL
    if not err <= tol or not lse_err <= LSE_TOL:
        raise AssertionError(f"{name} disagrees with its plain version at {what}: {err} > {tol} (lse {lse_err})")
    return dict(out=out, lse=lse, max_abs_err=err, ref_max_abs=ref_max, tol=tol, lse_max_abs_err=lse_err,
                lse_tol=LSE_TOL)


def check_k1(q, k, v, what: str) -> dict:
    return check_fwd("K1", fa.flash_attention_fwd, fa.flash_attention_reference, q, k, v, what)


def check_k4a(q, k, v, what: str, splits=None) -> dict:
    """K4a with ``splits`` (None: the launcher's choice) against its plain
    version cut into the same key ranges."""
    return check_fwd("K4a", functools.partial(kg.flash_attention_kgrid_fwd, splits=splits),
                     functools.partial(kg.flash_attention_kgrid_reference, splits=splits), q, k, v, what)


def sdpa_backward_ms(q, k, v, do, iters: int) -> float:
    """SDPA's backward (dQ, dK, dV together): forward+backward minus forward."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return cuda_ms(fwd_bwd, iters) - cuda_ms(fwd, iters)


def phase_kernel_bwd(gen: torch.Generator) -> tuple:
    """K1 (out and lse) and K2/K3 vs their plain versions at the training
    path's shapes: K1 at batch 1 (warm-up, student) and 3 (the teacher's
    [positive, neutral, negative] rows), K2/K3 at batch 1 (the student);
    ragged and strided-dO checks. Returns the K2/K3 rows (one per shape and
    dtype) and the K1 rows."""
    d = 64
    rows, k1_rows = [], []
    cases = [(n, sq, sk, h, dt) for dt in (torch.bfloat16, torch.float32) for n, sq, sk, h in TRAIN_SHAPES]
    for name, sq, sk, h, dtype in cases:
        q3, k3, v3 = (torch.randn((3, s, h, d), generator=gen, device="cuda").to(dtype) for s in (sq, sk, sk))
        teacher = check_k1(q3, k3, v3, f"{name} rows=3 {dtype}")
        q, do = (torch.randn((1, sq, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((1, sk, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
        student = check_k1(q, k, v, f"{name} rows=1 {dtype}")
        o, lse = student["out"], student["lse"]
        for n_rows, c in ((1, student), (3, teacher)):
            k1_rows.append(dict(shape=name, rows=n_rows, dtype=str(dtype),
                                **{key: val for key, val in c.items() if key not in ("out", "lse")}))
        scale = d**-0.5
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
        errs = {g: (got.float() - want).abs().max().item() for g, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        tols = {g: grad_tol(want, dtype) for g, want in zip(("dq", "dk", "dv"), ref)}
        iters = 20 if sk > 77 else 50
        row = dict(
            phase="kernel_bwd", shape=name, rows=1, sq=sq, sk=sk, heads=h, head_dim=d, dtype=str(dtype),
            max_abs_err=errs, tol=tols,
            k2_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale), iters),
            k3_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale), iters),
            k2_plain_ms=cuda_ms(lambda: fa.bwd_dq_reference(q, k, v, o, lse, do, scale), 5),
            k3_plain_ms=cuda_ms(lambda: fa.bwd_dkv_reference(q, k, v, lse, delta, do, scale), 5),
            library_ms=sdpa_backward_ms(q, k, v, do, iters),
        )
        (row["k2_bound_ms"], row["k2_bound_by"]), (row["k3_bound_ms"], row["k3_bound_by"]) = (
            bwd_bound("dq", sq, sk, h, d, dtype), bwd_bound("dkv", sq, sk, h, d, dtype))
        emit(row)
        bad = [g for g in errs if not errs[g] <= tols[g]]
        if bad:
            raise AssertionError(f"K2/K3 disagree with their plain versions at {name} {dtype}: {bad} {errs} > {tols}")
        rows.append(row)

    # ragged tails and a strided dO (a head slice of a wider tensor), both dtypes
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for sk in (77, 129):
            b, sq, h = 2, 65, 3
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
            wide = torch.randn((b, sq, 2 * h, d), generator=gen, device="cuda").to(dtype)
            do = wide[:, :, 1::2]
            o, lse = fa.flash_attention_fwd(q, k, v)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), d**-0.5)
            ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                                   d**-0.5)
            errs = [(x.float() - w).abs().max().item() for x, w in zip(got, ref)]
            tols = [grad_tol(w, dtype) for w in ref]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            checks.append(dict(dtype=str(dtype), sq=sq, sk=sk, strided_do=True, max_abs_err=errs, tol=tols,
                               strided_equals_contiguous=same))
            if not same or any(not e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"K2/K3 ragged/strided check failed: {checks[-1]}")
    emit(dict(phase="kernel_bwd", ragged_and_strided=checks))
    emit(dict(phase="kernel_bwd", k1_at_training_shapes=k1_rows))
    return rows, k1_rows


def phase_kernel(gen: torch.Generator) -> list:
    """K1 vs plain at the path's shapes; returns one row per shape."""
    rows, d = 2, 64  # one 1024px request with CFG
    results = []
    cases = [(n, sq, sk, h, torch.bfloat16) for n, sq, sk, h in PATH_SHAPES]
    cases += [(n + "_fp32", sq, sk, h, torch.float32) for n, sq, sk, h in PATH_SHAPES]
    for name, sq, sk, h, dtype in cases:
        q, k, v = (torch.randn((rows, s, h, d), generator=gen, device="cuda").to(dtype) for s in (sq, sk, sk))
        c = check_k1(q, k, v, name)
        iters = 20 if sk > 77 else 50
        kernel_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, d**-0.5), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        bound_ms, bound_by = bound(rows, sq, sk, h, d, dtype)
        row = dict(
            phase="kernel", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d, dtype=str(dtype),
            **{key: val for key, val in c.items() if key not in ("out", "lse")},
            kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        )
        emit(row)
        results.append(row)
    return results


def sdpa_ms(q, k, v, iters: int):
    """F.scaled_dot_product_attention on the same BSHD tensors, or None when
    no backend takes them."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
    except RuntimeError:
        return None


def phase_kernel_kgrid(gen: torch.Generator) -> tuple:
    """K4a vs its plain version at the VAE's path shapes (bf16 and fp32,
    timed in bf16), ragged shapes and forced split counts. Returns the timed
    rows and every check's error."""
    d = KGRID_D
    rows_out, errors = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, s in KGRID_PATH_SHAPES:
            q, k, v = (torch.randn((rows, s, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
            c = check_k4a(q, k, v, f"{name} rows={rows} {dtype}")
            row = dict(phase="kernel_kgrid", shape=name, rows=rows, sq=s, sk=s, heads=1, head_dim=d,
                       dtype=str(dtype), splits=kg.pick_splits(rows, s, s),
                       **{key: val for key, val in c.items() if key not in ("out", "lse")})
            del c
            errors.append(row["max_abs_err"])
            if dtype == torch.bfloat16:
                row.update(kernel_ms=cuda_ms(lambda: kg.flash_attention_kgrid_fwd(q, k, v), 5),
                           plain_ms=cuda_ms(lambda: kg.flash_attention_kgrid_reference(q, k, v, d**-0.5), 2),
                           library_ms=sdpa_ms(q, k, v, 5))
                row["bound_ms"], row["bound_by"] = bound(rows, s, s, 1, d, dtype)
                rows_out.append(row)
            emit(row)
            del q, k, v
            torch.cuda.empty_cache()

    # the split forced to 1 and to more than 1: at one 512px image (the
    # launcher picks 3) and at the JAX test's ragged shape (3 key tiles)
    checks = []
    cases = [(1, 4096, 4096, 1, 512, sp) for sp in (1, 6)]
    cases += [(2, 300, 77, 2, dd, sp) for dd in (64, 512) for sp in (1, 3)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, h, dd, splits in cases:
            q = torch.randn((b, sq, h, dd), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, sk, h, dd), generator=gen, device="cuda").to(dtype) for _ in range(2))
            c = check_k4a(q, k, v, f"B {b} Sq {sq} Sk {sk} H {h} d {dd} splits {splits} {dtype}", splits=splits)
            checks.append(dict(dtype=str(dtype), b=b, sq=sq, sk=sk, heads=h, head_dim=dd, splits=splits,
                               max_abs_err=c["max_abs_err"], tol=c["tol"], lse_max_abs_err=c["lse_max_abs_err"]))
            errors.append(c["max_abs_err"])
    emit(dict(phase="kernel_kgrid", forced_splits_and_ragged=checks))
    return rows_out, errors


def phase_parity() -> None:
    """tiny-xl sampler: card (K1 in every UNet attention) vs CPU (plain)."""
    _, _, unet_cpu, sched, _ = factory.load_models_xl("tiny-xl", scheduler_name="ddim", device="cpu", with_vae=True)
    unet_gpu = copy.deepcopy(unet_cpu).to("cuda")
    sites = lora.create_sites(unet_cpu, rank=2, train_method="full")
    g = torch.Generator().manual_seed(1)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    schedule = sched.set_timesteps(3)
    lat = torch.randn((2, 4, 8, 8), generator=g)
    emb = torch.randn((4, 77, 32), generator=g)
    added = {"text_embeds": torch.randn((4, 32), generator=g), "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 4)}

    def run(unet, device):
        lp_d = {n: {k: t.to(device) for k, t in leaf.items()} for n, leaf in lp.items()}
        return sample_loop_scales(
            unet, sites, lp_d, [0.0, 1.5], 1, sched, schedule, lat.to(device), emb.to(device),
            guidance_scale=7.5, added_cond_kwargs={k: v.to(device) for k, v in added.items()},
        ).cpu()

    before = fa.flash_attention_fwd.launches
    got, want = run(unet_gpu, "cuda"), run(unet_cpu, "cpu")
    launches = fa.flash_attention_fwd.launches - before
    err = (got - want).abs().max().item()
    emit(dict(phase="parity", model="tiny-xl", steps=3, max_abs_err=err, tol=1e-3, k1_launches=launches))
    if not err <= 1e-3:
        raise AssertionError(f"tiny-xl sampler on the card differs from the CPU by {err}")
    if launches != 3 * unet_gpu.config.attention_calls_per_forward():
        raise AssertionError(f"tiny-xl sampler launched K1 {launches} times")


KERNEL_WRAPPERS = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                   kg.flash_attention_kgrid_fwd)  # K1, K2, K3, K4a
PLAIN_FORWARDS = (fa.flash_attention_reference, kg.flash_attention_kgrid_reference)


def counts() -> tuple:
    """Launches of K1, K2, K3, K4a."""
    return tuple(fn.launches for fn in KERNEL_WRAPPERS)


def plain_calls() -> tuple:
    """Calls of the plain forwards (K1's, K4a's) on CUDA tensors."""
    return tuple(fn.cuda_calls for fn in PLAIN_FORWARDS)


def reset_counts() -> None:
    """Every launch count and plain-call count to 0, just before a path."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in PLAIN_FORWARDS:
        fn.cuda_calls = 0


def check_no_plain(path: str) -> None:
    if plain_calls() != (0, 0):
        raise AssertionError(f"{path}: a plain attention version ran on the card {plain_calls()} times")


def phase_train_parity() -> None:
    """One tiny-xl ESD step, fp32: card (K1/K2/K3 in every attention) vs CPU
    (plain versions), same weights, factors, prompt embeddings and draws."""
    _, tes, unet_cpu, sched = factory.load_models_xl("tiny-xl", scheduler_name="euler_a", device="cpu")
    unet_gpu = copy.deepcopy(unet_cpu).to("cuda")
    sites = lora.create_sites(unet_cpu, rank=2, train_method="full")
    g = torch.Generator().manual_seed(2)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    settings = [PromptSettings.from_dict(dict(target="person", positive="person, smiling", unconditional="person",
                                              neutral="person", action="enhance", guidance_scale=3, resolution=64))]
    bank = esd.build_prompt_bank(settings, lambda p: tuple(t[0] for t in factory.encode_prompts_xl(tes, [p])))
    schedule = sched.set_timesteps(3)
    t_to = 2
    lat0 = torch.randn((1, 4, 8, 8), generator=g) * schedule.init_noise_sigma
    noise = torch.randn((t_to, 1, 4, 8, 8), generator=g)
    cfg = esd.ESDConfig(max_denoising_steps=3, height=64, width=64)

    def run(unet, device):
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        bank_d = esd.PromptBank(bank.text.to(device), bank.guidance, bank.sign, bank.pooled.to(device))
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10), grad_clip_norm=0.2)
        step = esd.make_esd_train_step(unet, sites, lp_d, sched, schedule, opt, cfg,
                                       add_time_ids=torch.from_numpy(get_add_time_ids(64, 64)).to(device))
        m = step(opt.init(flat_params(sites, lp_d)), bank_d,
                 draws=esd.Draws(0, t_to, lat0.to(device), noise.to(device)))
        return float(m["loss"]), float(m["grad_norm"]), lora.state_dict_numpy(sites, lp_d)

    before = counts()
    got = run(unet_gpu, "cuda")
    launches = [a - b for a, b in zip(counts(), before)]
    want = run(unet_cpu, "cpu")
    per_fwd = unet_gpu.config.attention_calls_per_forward()
    loss_err = abs(got[0] - want[0])
    factor_err = max(float(np.abs(got[2][k] - want[2][k]).max()) for k in want[2])
    emit(dict(phase="train_parity", model="tiny-xl", timesteps_to=t_to, loss_card=got[0], loss_cpu=want[0],
              loss_abs_err=loss_err, grad_norm_card=got[1], grad_norm_cpu=want[1], factor_max_abs_err=factor_err,
              tol=1e-3, launches_k1_k2_k3_k4a=launches))
    if not (loss_err <= 1e-3 * max(1.0, abs(want[0])) and factor_err <= 1e-3):
        raise AssertionError(f"tiny-xl ESD step on the card differs from the CPU: loss {loss_err}, factors {factor_err}")
    if launches != [(t_to + 2) * per_fwd, per_fwd, per_fwd, 0]:
        raise AssertionError(f"tiny-xl ESD step launched K1/K2/K3/K4a {launches} times")


def write_image_folders(root: Path, folders, names, size: int, seed: int) -> None:
    """Paired synthetic PNGs: every folder holds the same file names; image
    ``name`` is one smooth random pattern per name, a brightness step
    brighter in each next folder (the 'concept' the slider learns)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for name in names:
        freq, phase = rng.uniform(1, 4, (2, 3)), rng.uniform(0, 2 * np.pi, (3,))
        base = np.stack([np.sin(2 * np.pi * freq[0, c] * xx + phase[c]) * np.cos(2 * np.pi * freq[1, c] * yy)
                         for c in range(3)], -1) * 50 + 128 + rng.normal(0, 6, (size, size, 3))
        for i, folder in enumerate(folders):
            (root / folder).mkdir(parents=True, exist_ok=True)
            img = np.clip(base + 30 * (i - (len(folders) - 1) / 2), 0, 255).astype(np.uint8)
            (root / folder / name).write_bytes(encode_png(img))


def phase_imageslider_parity(tmp: Path) -> None:
    """The image bank through the full SDXL VAE at 64px (K4a in the encoder's
    mid-block, 8×8 tokens × d 512) and one tiny-xl image-pair step (K1/K2/K3),
    fp32: card vs CPU, same weights, factors, prompts and draws."""
    _, tes, unet_cpu, sched, vae_cpu = factory.load_models_xl("tiny-xl", scheduler_name="euler_a", device="cpu",
                                                              with_vae=True)
    unet_gpu, vae_gpu = copy.deepcopy(unet_cpu).to("cuda"), copy.deepcopy(vae_cpu).to("cuda")
    root = tmp / "parity_images"
    write_image_folders(root, IMAGE_FOLDERS, ["a.png", "b.png"], 64, seed=3)
    sites = lora.create_sites(unet_cpu, rank=2, train_method="full")
    g = torch.Generator().manual_seed(5)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    text, pooled = {}, {}
    for role, prompt in (("positive", "a photo of a person, smiling"), ("neutral", "a photo of a person")):
        t, p = factory.encode_prompts_xl(tes, [prompt])
        text[role], pooled[role] = t[0].clone(), p[0].clone()
    cfg = imageslider.ImageSliderConfig(max_denoising_steps=4, scaling_factor=vae_cpu.config.scaling_factor)
    draws = imageslider.Draws(pair=1, image=1, timesteps_to=2, posterior_noise=torch.randn((4, 8, 8), generator=g),
                              noise=torch.randn((1, 4, 8, 8), generator=g))

    def run(unet, vae, device):
        bank = imageslider.build_image_bank(str(root), IMAGE_FOLDERS, IMAGE_SCALES, vae.encode, 64, device=device)
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10))
        step = imageslider.make_image_slider_step(
            unet, sites, lp_d, sched, sched.set_timesteps(cfg.max_denoising_steps), opt, cfg,
            text["positive"].to(device), text["neutral"].to(device),
            pooled={r: p.to(device) for r, p in pooled.items()},
            add_time_ids=torch.from_numpy(get_add_time_ids(64, 64)).to(device))
        d = imageslider.Draws(draws.pair, draws.image, draws.timesteps_to, draws.posterior_noise.to(device),
                              draws.noise.to(device))
        m = step(opt.init(flat_params(sites, lp_d)), bank, draws=d)
        return bank, float(m["loss"]), lora.state_dict_numpy(sites, lp_d)

    reset_counts()
    bank, loss, factors = run(unet_gpu, vae_gpu, "cuda")
    launches = list(counts())
    check_no_plain("imageslider_parity")
    want_bank, want_loss, want_factors = run(unet_cpu, vae_cpu, "cpu")
    moment_err = max((bank.mean.cpu() - want_bank.mean).abs().max().item(),
                     (bank.logvar.cpu() - want_bank.logvar).abs().max().item())
    moment_tol = 1e-3 * max(1.0, want_bank.mean.abs().max().item(), want_bank.logvar.abs().max().item())
    loss_err = abs(loss - want_loss)
    factor_err = max(float(np.abs(factors[k] - want_factors[k]).max()) for k in want_factors)
    per_fwd = unet_gpu.config.attention_calls_per_forward()
    want_launches = [per_fwd, per_fwd, per_fwd, len(IMAGE_FOLDERS)]
    emit(dict(phase="imageslider_parity", model="tiny-xl + SDXL VAE", image_size=64, bank_shape=list(bank.mean.shape),
              pair_table=bank.pair_table, moment_max_abs_err=moment_err, moment_tol=moment_tol, loss_card=loss,
              loss_cpu=want_loss, loss_abs_err=loss_err, factor_max_abs_err=factor_err, tol=1e-3,
              launches_k1_k2_k3_k4a=launches))
    if not (moment_err <= moment_tol and loss_err <= 1e-3 * max(1.0, abs(want_loss)) and factor_err <= 1e-3):
        raise AssertionError(f"the image-pair bank or step on the card differs from the CPU: moments {moment_err}, "
                             f"loss {loss_err}, factors {factor_err}")
    if bank.pair_table != want_bank.pair_table or launches != want_launches:
        raise AssertionError(f"image-pair parity: pair table {bank.pair_table}, launches {launches} "
                             f"(expected {want_launches})")


def device_profile(fn) -> dict:
    """Run ``fn`` under torch.profiler: wall, device busy seconds (sum of
    kernel durations on the one stream), idle share, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    by_name: dict = {}
    n_kernels = 0
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and evt.time_range.elapsed_us() > 0:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e6
            n_kernels += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = dict(wall_seconds_profiled=wall, device_kernels=n_kernels, device_busy_seconds=busy if by_name else "not measured",
               idle_share=1 - busy / wall if by_name else "not measured",
               top_kernels=[dict(name=n[:120], seconds=v, share_of_busy=v / busy) for n, v in top])
    for key, kernel in (("k1", "flash_fwd_kernel"), ("k2", "flash_bwd_dq_kernel"), ("k3", "flash_bwd_dkv_kernel"),
                        ("k4a", "kgrid_")):
        secs = sum(v for k, v in by_name.items() if kernel in k)
        out[f"{key}_seconds"] = secs
        out[f"{key}_share_of_busy"] = secs / busy if busy else "not measured"
    return out


def xl_train_config(save_dir: Path):
    """data/config-xl.yaml as it is, but for train.iterations and save.path."""
    cfg = load_config_from_yaml(str(REPO / "data" / "config-xl.yaml"))
    cfg.prompts_file = str(REPO / cfg.prompts_file)
    cfg.train.iterations = TRAIN_ITERATIONS
    cfg.save.path = str(save_dir)
    return cfg, load_prompts_from_yaml(cfg.prompts_file)


def trained_summary(cfg, res) -> dict:
    """The saved ``_last.safetensors`` against the reference key schema for
    the config's sites, and how many LoRA ``up`` factors are still at their
    0 start."""
    saved = load_file(str(Path(cfg.save.path) / f"{cfg.save.name}_last.safetensors"))
    with torch.device("meta"):
        meta_unet = UNet2DConditionModel(UNetConfig.sdxl())
    ref_sites = lora.create_sites(meta_unet, rank=cfg.network.rank, alpha=cfg.network.alpha,
                                  train_method=cfg.network.training_method)
    want_keys = {f"{s.lora_name}.{k}" for s in ref_sites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    ups_zero = [n for n, leaf in res.lora_params.items() if not leaf["up"].detach().abs().max().item() > 0]
    return dict(saved_keys=len(saved), saved_keys_match_reference=set(saved) == want_keys,
                up_factors_still_zero=len(ups_zero))


def check_trained(what: str, res, summary: dict, launches, want_launches) -> None:
    if not all(np.isfinite(res.losses)) or len(res.losses) != TRAIN_ITERATIONS:
        raise AssertionError(f"{what}: losses {res.losses}")
    if summary["up_factors_still_zero"]:
        raise AssertionError(f"{what}: {summary['up_factors_still_zero']} LoRA up factors are still zero")
    if not summary["saved_keys_match_reference"]:
        raise AssertionError(f"{what}: the saved slider's keys are not the reference schema")
    if launches != want_launches:
        raise AssertionError(f"{what} launched K1/K2/K3/K4a {launches} times, expected {want_launches}")


def phase_train(tmp: Path) -> tuple:
    """Full-width SDXL ESD training at 512px through trainer.train."""
    cfg, prompts = xl_train_config(tmp / "train")
    per_fwd = UNetConfig.sdxl().attention_calls_per_forward()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count the training path only
    t0 = time.time()
    res = trainer.train(cfg, prompts, rank=cfg.network.rank, device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain("train")
    t_to = [row["timesteps_to"] for row in res.metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = trained_summary(cfg, res)
    want_launches = [sum(t + 2 for t in t_to) * per_fwd, TRAIN_ITERATIONS * per_fwd, TRAIN_ITERATIONS * per_fwd, 0]
    row = dict(
        phase="train", model=cfg.pretrained_model.name_or_path, image_size=prompts[0].resolution,
        scheduler=cfg.train.noise_scheduler, max_denoising_steps=cfg.train.max_denoising_steps,
        precision=cfg.train.precision, lora_sites=len(res.sites), iterations=TRAIN_ITERATIONS,
        losses=res.losses, grad_norms=[r["grad_norm"] for r in res.metrics], timesteps_to=t_to,
        steps_per_sec_after_first=res.steps_per_sec, first_step_seconds=res.first_step_seconds,
        setup_seconds_models_and_prompt_bank=res.setup_seconds, wall_seconds=wall,
        max_memory_allocated_gib=peak, launches_k1_k2_k3_k4a=launches, expected_launches=want_launches,
        **summary,
    )
    emit(row)
    check_trained("training", res, summary, launches, want_launches)

    profiled = {}
    prof = device_profile(lambda: profiled.update(res.next_step()))
    emit(dict(phase="train_profile", timesteps_to=profiled["timesteps_to"], **prof))
    return launches, row


def phase_imageslider(tmp: Path) -> list:
    """Full-width SDXL image-pair slider training at 512px through
    cli/train_lora_scale.train: four folders of paired PNGs, two |scale| pairs."""
    cfg, prompts = xl_train_config(tmp / "imageslider")
    root = tmp / "image_pairs"
    write_image_folders(root, IMAGE_FOLDERS, [f"{i:03d}.png" for i in range(IMAGES_PER_FOLDER)],
                        train_lora_scale.XL_RESOLUTION, seed=6)
    per_fwd = UNetConfig.sdxl().attention_calls_per_forward()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count the image-pair training path only
    t0 = time.time()
    res = train_lora_scale.train(cfg, prompts, str(root), IMAGE_FOLDERS, IMAGE_SCALES, rank=cfg.network.rank,
                                 device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain("imageslider")
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = trained_summary(cfg, res)
    # K1/K2/K3 once per attention of the one 2-row student call; K4a once per folder's encode
    want_launches = [TRAIN_ITERATIONS * per_fwd] * 3 + [len(IMAGE_FOLDERS)]
    row = dict(
        phase="imageslider", model=cfg.pretrained_model.name_or_path, image_size=train_lora_scale.XL_RESOLUTION,
        folders=IMAGE_FOLDERS, scales=IMAGE_SCALES, images_per_folder=IMAGES_PER_FOLDER,
        scheduler=cfg.train.noise_scheduler, max_denoising_steps=cfg.train.max_denoising_steps,
        precision=cfg.train.precision, lora_sites=len(res.sites), iterations=TRAIN_ITERATIONS,
        losses=res.losses, loss_high=[r["loss_high"] for r in res.metrics],
        loss_low=[r["loss_low"] for r in res.metrics], grad_norms=[r["grad_norm"] for r in res.metrics],
        pair_scales=[r["scale"] for r in res.metrics], timesteps_to=[r["timesteps_to"] for r in res.metrics],
        bank_build_seconds=res.bank_seconds, steps_per_sec_after_first=res.steps_per_sec,
        first_step_seconds=res.first_step_seconds, setup_seconds_models_prompts_bank=res.setup_seconds,
        wall_seconds=wall, max_memory_allocated_gib=peak, launches_k1_k2_k3_k4a=launches,
        expected_launches=want_launches, **summary,
    )
    emit(row)
    check_trained("image-pair training", res, summary, launches, want_launches)

    profiled = {}
    prof = device_profile(lambda: profiled.update(res.next_step()))
    emit(dict(phase="imageslider_profile", timesteps_to=profiled["timesteps_to"], scale=profiled["scale"], **prof))
    return launches


def make_slider(path: Path) -> None:
    """Rank-4 noxattn/c3lier slider over the SDXL module tree, non-zero up."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sdxl())
    targets = lora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + lora.UNET_TARGET_REPLACE_MODULE_CONV
    sites = lora.create_sites(unet, rank=4, alpha=1.0, target_replace=targets, train_method="noxattn")
    g = torch.Generator().manual_seed(4)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    lora.save_weights(str(path), sites, lp)


def phase_serve(tmp: Path) -> SliderService:
    path = tmp / "smoke_noxattn_rank4_alpha1.safetensors"
    make_slider(path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    svc = SliderService(SDXL, str(path), image_size=IMAGE_SIZE, steps=STEPS, device="cuda", batch_window_ms=50.0)
    load_s = time.time() - t0
    svc.add_slider("smoke", str(path))
    per_call = STEPS * svc.unet.config.attention_calls_per_forward()
    batcher = svc._batcher
    reset_counts()  # count the serving path only
    requests = []

    def timed(scale, seed):
        t = time.time()
        png = svc.generate("a photo of a person", scale, seed, 7.5, slider="smoke")
        return png, time.time() - t

    images = {}
    for scale in (0.0, 2.0):
        (l0, *_, d0), b0 = counts(), batcher.total_batches
        png, secs = timed(scale, 7)
        images[scale] = decode_png(png)
        requests.append(dict(scale=scale, seconds=secs, batch=batcher.batch_sizes[-1],
                             k1_launches=fa.flash_attention_fwd.launches - l0,
                             k4a_launches=kg.flash_attention_kgrid_fwd.launches - d0,
                             sampler_calls=batcher.total_batches - b0))

    (l0, *_, d0), b0 = counts(), batcher.total_batches
    pair: dict = {}
    errors: list = []

    def client(scale, seed):
        try:
            pair[scale] = timed(scale, seed)
        except Exception as e:  # noqa: BLE001 — re-raised below on the main thread
            errors.append(e)

    t = time.time()
    threads = [threading.Thread(target=client, args=(s, 11)) for s in (-2.0, 1.0)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    pair_wall = time.time() - t
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or len(pair) != 2:
        raise AssertionError("concurrent requests did not finish")
    pair_calls = batcher.total_batches - b0
    for scale, (png, secs) in pair.items():
        images[scale] = decode_png(png)
        requests.append(dict(scale=scale, seconds=secs, batch=2, concurrent=True))
    pair_launches = fa.flash_attention_fwd.launches - l0
    pair_k4a = kg.flash_attention_kgrid_fwd.launches - d0

    for scale, img in images.items():
        if img.dtype != np.uint8 or img.shape != (IMAGE_SIZE, IMAGE_SIZE, 3):
            raise AssertionError(f"scale {scale}: image {img.dtype} {img.shape}")
    if np.array_equal(images[0.0], images[2.0]):
        raise AssertionError("scale 0 and scale +2 gave the same image")
    if pair_calls != 1 or list(batcher.batch_sizes)[-1] != 2:
        raise AssertionError(f"the concurrent pair took {pair_calls} sampler calls")
    for r in requests[:2]:
        if r["k1_launches"] != per_call or r["k4a_launches"] != 1 or r["sampler_calls"] != 1:
            raise AssertionError(f"request {r}: expected {per_call} K1 launches and one K4a (the VAE decode) in "
                                 "one sampler call")
    if pair_launches != per_call or pair_k4a != 1:
        raise AssertionError(f"the pair's sampler call launched K1 {pair_launches} times, not {per_call}, and K4a "
                             f"{pair_k4a} times, not 1")
    solo = [r["seconds"] for r in requests[:2]]
    emit(dict(
        phase="serve", model=SDXL, image_size=IMAGE_SIZE, steps=STEPS, weights="random, seeded per module, bf16",
        slider_sites=len(svc.sites), load_seconds=load_s, requests=requests,
        k1_launches_per_sampler_call=per_call, k1_launches=fa.flash_attention_fwd.launches,
        k4a_launches_per_decode=1, k4a_launches=kg.flash_attention_kgrid_fwd.launches, pair_k4a_launches=pair_k4a,
        solo_seconds_first=solo[0], solo_seconds_second=solo[1],
        pair_wall_seconds=pair_wall, pair_images_per_second=2 / pair_wall,
        images_per_second_solo=1 / solo[1],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        scale0_vs_scale2_max_abs=int(np.abs(images[0.0].astype(int) - images[2.0]).max()),
    ))
    return svc


def phase_http(svc: SliderService) -> int:
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
        sliders = json.loads(urllib.request.urlopen(f"{base}/sliders", timeout=60).read())
        l0, d0 = fa.flash_attention_fwd.launches, kg.flash_attention_kgrid_fwd.launches
        t = time.time()
        with urllib.request.urlopen(f"{base}/generate?prompt=a+photo+of+a+cat&scale=1.5&seed=3&slider=smoke",
                                    timeout=600) as resp:
            status, png = resp.status, resp.read()
        secs = time.time() - t
        img = decode_png(png)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    launches = fa.flash_attention_fwd.launches - l0
    k4a = kg.flash_attention_kgrid_fwd.launches - d0
    emit(dict(phase="http", status=status, seconds=secs, shape=list(img.shape), healthz=health["status"],
              sliders=[s["name"] for s in sliders["sliders"]], k1_launches=launches, k4a_launches=k4a))
    if status != 200 or img.shape != (IMAGE_SIZE, IMAGE_SIZE, 3) or health["status"] != "ok":
        raise AssertionError("HTTP /generate failed")
    if k4a != 1:
        raise AssertionError(f"the HTTP request's decode launched K4a {k4a} times, not once")
    return launches


def phase_profile(svc: SliderService) -> None:
    """One solo request under torch.profiler."""
    prof = device_profile(lambda: svc.generate("a photo of a person", 1.0, 5, 7.5, slider="smoke"))
    emit(dict(phase="profile", **{k: v for k, v in prof.items() if not k.startswith(("k2", "k3"))}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke runs only on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    t0 = time.time()
    fa.build()
    libraries = {n: {k: v for k, v in info.items() if k != "ptxas"} for n, info in fa.build_info.items()}
    emit(dict(phase="build", seconds=time.time() - t0, libraries=libraries, kernels=ptxas_summary(fa.build_info),
              card=card, torch=torch.__version__, cuda=torch.version.cuda))

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = phase_kernel(gen)
    bwd_rows, k1_train_rows = phase_kernel_bwd(gen)
    kgrid_rows, kgrid_errors = phase_kernel_kgrid(gen)
    phase_parity()
    phase_train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        phase_imageslider_parity(Path(tmp))
        svc = phase_serve(Path(tmp))  # sets every count to 0 before it serves
        try:
            phase_http(svc)
            serve = counts()
            check_no_plain("serve")
            phase_profile(svc)
        finally:
            svc.close()
        del svc
        torch.cuda.empty_cache()
        train_launches, _ = phase_train(Path(tmp))  # sets every count to 0 before it trains
        torch.cuda.empty_cache()
        image_launches = phase_imageslider(Path(tmp))  # and so does the image-pair trainer

    # each kernel ran on each path that runs it (K1 and K4a serving, K1-K3
    # training, all four image-pair training)
    ran = [serve[0], serve[3], *train_launches[:3], *image_launches]
    if min(ran) <= 0:
        raise AssertionError(f"a kernel was not launched on its path: serve {serve}, train {train_launches}, "
                             f"imageslider {image_launches}")
    main_row = k1_rows[0]  # 4096x4096 self-attention: the largest share of K1's serving time
    bwd_main = bwd_rows[0]  # 1024x1024 self-attention, bf16: the largest share of K2/K3's time
    kgrid_main = kgrid_rows[0]  # the 1024px decode of one image: K4a's serving call
    at_bwd = f"{bwd_main['shape']} rows=1 heads={bwd_main['heads']} d={bwd_main['head_dim']} bf16"

    def launches(i: int, paths) -> dict:
        """Kernel i's launches on the paths that run it, and their sum."""
        every = {"serve": serve[i], "train": train_launches[i], "imageslider": image_launches[i]}
        return dict(launches=sum(every[p] for p in paths), launches_by_path={p: every[p] for p in paths})

    rows = [
        dict(
            name="flash_attention_fwd",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:62",
            **launches(0, ("serve", "train", "imageslider")),
            max_abs_err=max(r["max_abs_err"] for r in k1_rows + k1_train_rows),
            ms=main_row["kernel_ms"],
            plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            at=f"{main_row['shape']} rows={main_row['rows']} heads={main_row['heads']} d={main_row['head_dim']} bf16",
        ),
        dict(
            name="flash_attention_bwd_dq",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:107",
            **launches(1, ("train", "imageslider")),
            max_abs_err=max(r["max_abs_err"]["dq"] for r in bwd_rows),
            ms=bwd_main["k2_ms"],
            plain_ms=bwd_main["k2_plain_ms"],
            bound_ms=bwd_main["k2_bound_ms"],
            bound_by=bwd_main["k2_bound_by"],
            library_ms=bwd_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            at=at_bwd,
        ),
        dict(
            name="flash_attention_bwd_dkv",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:139",
            **launches(2, ("train", "imageslider")),
            max_abs_err=max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]) for r in bwd_rows),
            ms=bwd_main["k3_ms"],
            plain_ms=bwd_main["k3_plain_ms"],
            bound_ms=bwd_main["k3_bound_ms"],
            bound_by=bwd_main["k3_bound_by"],
            library_ms=bwd_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            at=at_bwd,
        ),
        dict(
            name="flash_attention_kgrid_fwd",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_kgrid.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention_kgrid.py:77",
            **launches(3, ("serve", "imageslider")),
            max_abs_err=max(kgrid_errors),
            ms=kgrid_main["kernel_ms"],
            plain_ms=kgrid_main["plain_ms"],
            bound_ms=kgrid_main["bound_ms"],
            bound_by=kgrid_main["bound_by"],
            library_ms=kgrid_main["library_ms"],
            at=f"{kgrid_main['shape']} rows={kgrid_main['rows']} heads=1 d={kgrid_main['head_dim']} bf16",
        ),
    ]
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
