#!/usr/bin/env python3
"""Smoke of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build        — compile K1 (csrc/flash_attention_fwd.cu) and K2/K3
                  (csrc/flash_attention_bwd.cu) with nvcc for sm_90a, one
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
4. parity       — the tiny-xl sampler on the card (K1 inside every UNet
                  attention) against the same weights and inputs on the CPU.
5. train_parity — one tiny-xl ESD step on the card (K1/K2/K3 inside) against
                  the same step on the CPU: weights, LoRA factors, draws, fp32.
6. serve        — full-width SDXL (random weights from a seed) at 1024px, 25 DDIM
                  steps: a rank-4 slider made with create_sites, written with the
                  port's .safetensors writer and loaded through add_slider; four
                  requests (scale 0, +2, and -2/+1 concurrently in one micro-batch);
                  K1's launch count per sampler call; latency, images/s, peak memory.
7. http         — one /generate through make_handler on localhost.
8. profile      — one more request under torch.profiler: device busy time,
                  the idle share, and the kernels that take the device time.
9. train        — full-width SDXL ESD slider training at 512px through
                  trainer.train from data/config-xl.yaml + data/prompts-xl.yaml
                  (only train.iterations and save.path overridden): finite
                  losses, moving factors, the saved file's keys, K1/K2/K3
                  launch counts per step, steps/s, first-step seconds, peak
                  memory; then one more step under torch.profiler.
10. kernels     — every ported kernel with its launches on its paths (serving:
                  phases 6 and 7, counted from 0 just before phase 6;
                  training: phase 9, counted from 0 just before it).

Then the card as nvidia-smi names it, and the result line.
"""

from __future__ import annotations

import copy
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
from sliders_conceptmod_tpu_torch.core.config import load_config_from_yaml
from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings, load_prompts_from_yaml
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.infer.generate import sample_loop_scales
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.io.safetensors import load_file
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.serve import SliderService, make_handler
from sliders_conceptmod_tpu_torch.train import esd, trainer
from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# K1 vs its fp32 plain version. fp32: the same math up to summation order.
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


def check_k1(q, k, v, what: str) -> dict:
    """K1 against its fp32 plain version on q, k, v; raises on disagreement.
    Returns (out, lse) and the errors with their bounds."""
    d = q.shape[-1]
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), d**-0.5)
    err = (out.float() - ref_out).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ref_max = ref_out.abs().max().item()
    tol = min(BF16_TOL, BF16_REL * ref_max) if q.dtype == torch.bfloat16 else FP32_TOL
    if not err <= tol or not lse_err <= LSE_TOL:
        raise AssertionError(f"K1 disagrees with its plain version at {what}: {err} > {tol} (lse {lse_err})")
    return dict(out=out, lse=lse, max_abs_err=err, ref_max_abs=ref_max, tol=tol, lse_max_abs_err=lse_err,
                lse_tol=LSE_TOL)


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


def counts() -> tuple:
    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)


def reset_counts() -> None:
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd_dq.launches = fa.flash_attention_bwd_dkv.launches = 0


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
              tol=1e-3, launches_k1_k2_k3=launches))
    if not (loss_err <= 1e-3 * max(1.0, abs(want[0])) and factor_err <= 1e-3):
        raise AssertionError(f"tiny-xl ESD step on the card differs from the CPU: loss {loss_err}, factors {factor_err}")
    if launches != [(t_to + 2) * per_fwd, per_fwd, per_fwd]:
        raise AssertionError(f"tiny-xl ESD step launched K1/K2/K3 {launches} times")


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
    for key, kernel in (("k1", "flash_fwd_kernel"), ("k2", "flash_bwd_dq_kernel"), ("k3", "flash_bwd_dkv_kernel")):
        secs = sum(v for k, v in by_name.items() if kernel in k)
        out[f"{key}_seconds"] = secs
        out[f"{key}_share_of_busy"] = secs / busy if busy else "not measured"
    return out


def phase_train(tmp: Path) -> tuple:
    """Full-width SDXL ESD training at 512px through trainer.train."""
    cfg = load_config_from_yaml(str(REPO / "data" / "config-xl.yaml"))
    cfg.prompts_file = str(REPO / cfg.prompts_file)
    cfg.train.iterations = TRAIN_ITERATIONS
    cfg.save.path = str(tmp / "train")
    prompts = load_prompts_from_yaml(cfg.prompts_file)
    per_fwd = UNetConfig.sdxl().attention_calls_per_forward()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count the training path only
    t0 = time.time()
    res = trainer.train(cfg, prompts, rank=cfg.network.rank, device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    t_to = [row["timesteps_to"] for row in res.metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30

    saved = load_file(str(Path(cfg.save.path) / f"{cfg.save.name}_last.safetensors"))
    with torch.device("meta"):
        meta_unet = UNet2DConditionModel(UNetConfig.sdxl())
    ref_sites = lora.create_sites(meta_unet, rank=cfg.network.rank, alpha=cfg.network.alpha,
                                  train_method=cfg.network.training_method)
    want_keys = {f"{s.lora_name}.{k}" for s in ref_sites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    ups_zero = [n for n, leaf in res.lora_params.items() if not leaf["up"].detach().abs().max().item() > 0]
    want_launches = [sum(t + 2 for t in t_to) * per_fwd, TRAIN_ITERATIONS * per_fwd, TRAIN_ITERATIONS * per_fwd]
    row = dict(
        phase="train", model=cfg.pretrained_model.name_or_path, image_size=prompts[0].resolution,
        scheduler=cfg.train.noise_scheduler, max_denoising_steps=cfg.train.max_denoising_steps,
        precision=cfg.train.precision, lora_sites=len(res.sites), iterations=TRAIN_ITERATIONS,
        losses=res.losses, grad_norms=[r["grad_norm"] for r in res.metrics], timesteps_to=t_to,
        steps_per_sec_after_first=res.steps_per_sec, first_step_seconds=res.first_step_seconds,
        setup_seconds_models_and_prompt_bank=res.setup_seconds, wall_seconds=wall,
        max_memory_allocated_gib=peak, launches_k1_k2_k3=launches, expected_launches=want_launches,
        saved_keys=len(saved), saved_keys_match_reference=set(saved) == want_keys,
    )
    emit(row)
    if not all(np.isfinite(res.losses)) or len(res.losses) != TRAIN_ITERATIONS:
        raise AssertionError(f"training losses {res.losses}")
    if ups_zero:
        raise AssertionError(f"{len(ups_zero)} LoRA up factors are still zero after training, e.g. {ups_zero[0]}")
    if set(saved) != want_keys:
        raise AssertionError("the saved slider's keys are not the reference schema")
    if launches != want_launches:
        raise AssertionError(f"training launched K1/K2/K3 {launches} times, expected {want_launches}")

    profiled = {}
    prof = device_profile(lambda: profiled.update(res.next_step()))
    emit(dict(phase="train_profile", timesteps_to=profiled["timesteps_to"], **prof))
    return launches, row


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
    fa.flash_attention_fwd.launches = 0  # count the main path only
    requests = []

    def timed(scale, seed):
        t = time.time()
        png = svc.generate("a photo of a person", scale, seed, 7.5, slider="smoke")
        return png, time.time() - t

    images = {}
    for scale in (0.0, 2.0):
        l0, b0 = fa.flash_attention_fwd.launches, batcher.total_batches
        png, secs = timed(scale, 7)
        images[scale] = decode_png(png)
        requests.append(dict(scale=scale, seconds=secs, batch=batcher.batch_sizes[-1],
                             k1_launches=fa.flash_attention_fwd.launches - l0,
                             sampler_calls=batcher.total_batches - b0))

    l0, b0 = fa.flash_attention_fwd.launches, batcher.total_batches
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

    for scale, img in images.items():
        if img.dtype != np.uint8 or img.shape != (IMAGE_SIZE, IMAGE_SIZE, 3):
            raise AssertionError(f"scale {scale}: image {img.dtype} {img.shape}")
    if np.array_equal(images[0.0], images[2.0]):
        raise AssertionError("scale 0 and scale +2 gave the same image")
    if pair_calls != 1 or list(batcher.batch_sizes)[-1] != 2:
        raise AssertionError(f"the concurrent pair took {pair_calls} sampler calls")
    for r in requests[:2]:
        if r["k1_launches"] != per_call or r["sampler_calls"] != 1:
            raise AssertionError(f"request {r}: expected {per_call} K1 launches in one sampler call")
    if pair_launches != per_call:
        raise AssertionError(f"the pair's sampler call launched K1 {pair_launches} times, not {per_call}")
    solo = [r["seconds"] for r in requests[:2]]
    emit(dict(
        phase="serve", model=SDXL, image_size=IMAGE_SIZE, steps=STEPS, weights="random, seeded per module, bf16",
        slider_sites=len(svc.sites), load_seconds=load_s, requests=requests,
        k1_launches_per_sampler_call=per_call, k1_launches=fa.flash_attention_fwd.launches,
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
        l0 = fa.flash_attention_fwd.launches
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
    emit(dict(phase="http", status=status, seconds=secs, shape=list(img.shape), healthz=health["status"],
              sliders=[s["name"] for s in sliders["sliders"]], k1_launches=launches))
    if status != 200 or img.shape != (IMAGE_SIZE, IMAGE_SIZE, 3) or health["status"] != "ok":
        raise AssertionError("HTTP /generate failed")
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
    phase_parity()
    phase_train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        svc = phase_serve(Path(tmp))  # sets K1's count to 0 before it serves
        try:
            phase_http(svc)
            serve_k1 = fa.flash_attention_fwd.launches
            phase_profile(svc)
        finally:
            svc.close()
        del svc
        torch.cuda.empty_cache()
        train_launches, _ = phase_train(Path(tmp))  # sets every count to 0 before it trains

    if min(serve_k1, *train_launches) <= 0:
        raise AssertionError(f"a kernel was not launched on its path: serve K1 {serve_k1}, train {train_launches}")
    main_row = k1_rows[0]  # 4096x4096 self-attention: the largest share of K1's serving time
    bwd_main = bwd_rows[0]  # 1024x1024 self-attention, bf16: the largest share of K2/K3's time
    at_bwd = f"{bwd_main['shape']} rows=1 heads={bwd_main['heads']} d={bwd_main['head_dim']} bf16"
    emit({"kernels": [
        dict(
            name="flash_attention_fwd",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:62",
            launches=serve_k1 + train_launches[0],
            launches_by_path={"serve": serve_k1, "train": train_launches[0]},
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
            launches=train_launches[1],
            launches_by_path={"train": train_launches[1]},
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
            launches=train_launches[2],
            launches_by_path={"train": train_launches[2]},
            max_abs_err=max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]) for r in bwd_rows),
            ms=bwd_main["k3_ms"],
            plain_ms=bwd_main["k3_plain_ms"],
            bound_ms=bwd_main["k3_bound_ms"],
            bound_by=bwd_main["k3_bound_by"],
            library_ms=bwd_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            at=at_bwd,
        ),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
