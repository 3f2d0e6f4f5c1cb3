"""The arithmetic of the fp32 K1 and K4a kernels, emulated on the CPU.

On the card fp32 K1 (``flash_fwd_tf32_kernel``) and K4a
(``kgrid_fwd_tf32_kernel``) run one forward body (``csrc/hopper_tc.cuh``:
``fwd_tf32``): Q times scale·log2(e) and each K and V tile are split once
into TF32 halves (x = big + small, ``tf32_split``), every product is
``mma.sync`` m16n8k8 TF32 issued three times (small·big, big·small, big·big)
into a fresh fp32 sum per 8-deep k step that is then added to the
accumulator; S = QKᵀ is summed over the head-dim columns in the column parts
of the warps that share a slab (one part up to d 64 in K4a and d 128 in K1,
two at d 128 in K4a, four above), in part order; the online softmax runs in base 2 over
tiles of 16 or 8 keys; O = acc / l and lse = (m + log₂ l)·ln 2; a split
key range writes (acc, m·ln 2, l) per split and the merge combines them.
This file emulates that in plain PyTorch (each TF32 product exact in fp64,
each addition rounded to fp32) at the kernels' tiles, column parts and
splits, and holds it to the card's fp32 bound, 1e-4·max(1, |ref|) on O and
on lse, against the plain fp32 versions (``flash_attention_reference``,
``flash_attention_kgrid_reference``) and against the JAX package's Pallas
kernels in interpret mode (``flash_attention`` at d 64 and 128, the k-grid
kernel at d 192 and 512), with ragged Sq and Sk and logits large enough that
the softmax is peaked. One TF32 pass misses that bound for the forward too.
The kernels themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.flash_attention import _flash_fwd_impl as jax_flash_fwd
from sliders_conceptmod_tpu.ops.flash_attention_kgrid import _flash_fwd_impl as jax_kgrid_fwd
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from test_torch_tf32x3 import FP32_BOUND, K_STEP, tf32_split
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)
MASKED = -1e30
SPLIT_KEYS = 32  # both kernels split the key range in 32-key units


def k1_cfg(d):
    """(keys per tile, column parts) of flash_fwd_tf32_kernel
    (csrc/flash_attention_fwd.cu: tf32::Cfg)."""
    return 16, 1


def k4a_cfg(d):
    """The same of kgrid_fwd_tf32_kernel (csrc/flash_attention_kgrid.cu: tf32::Cfg)."""
    return (16 if d <= 320 else 8), (1 if d <= 64 else 2 if d <= 128 else 4)


def mm_steps(a, b, passes=3):
    """``a @ b`` ([..., M, K] @ [..., K, N], fp32) as the kernels compute it:
    per 8-deep k step a fresh fp32 sum of three exact TF32 products
    (small·big, big·small, big·big; or big·big alone with ``passes`` 1),
    then added to the accumulator with one rounding."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big))[3 - passes:]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        step = torch.zeros_like(acc)
        for x, y in terms:
            step = (step.double() + x[..., k0:k0 + K_STEP].double() @ y[..., k0:k0 + K_STEP, :].double()).float()
        acc = acc + step
    return acc


def emulated_fwd(q, k, v, scale, tile, parts, splits=1, passes=3):
    """fwd_tf32 over ``splits`` ranges of the key axis (32-key units), then
    fwd_merge when split; BSHD fp32 in, ``(O, lse [B·H, Sq])`` out."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = q.permute(0, 2, 1, 3) * torch.tensor(np.float32(scale) * LOG2E)  # [B, H, Sq, D], base 2
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    dc = d // parts
    ms, ls, accs = [], [], []
    for lo, hi in fa.split_ranges(sk, splits, SPLIT_KEYS):
        m = torch.full((b, h, sq, 1), MASKED)
        l = torch.zeros((b, h, sq, 1))
        acc = torch.zeros((b, h, sq, d))
        for k0 in range(lo, hi, tile):
            # the tile's keys at or past the split's end are zero rows, masked below
            kt = torch.zeros((b, h, tile, d))
            vt = torch.zeros((b, h, tile, d))
            n = min(tile, hi - k0)
            kt[:, :, :n], vt[:, :, :n] = kh[:, :, k0:k0 + n], vh[:, :, k0:k0 + n]
            s = None
            for p in range(parts):
                cols = slice(p * dc, (p + 1) * dc)
                part = mm_steps(qs[..., cols], kt[..., cols].transpose(-1, -2), passes)
                s = part if s is None else s + part
            s[..., n:] = MASKED
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            pr = torch.exp2(s - m_new)
            l = l * corr + pr.sum(-1, keepdim=True)
            acc = acc * corr + mm_steps(pr, vt, passes)
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    if splits == 1:
        out, lse = accs[0] * (1 / ls[0]), (ms[0] + torch.log2(ls[0])) * LN2
    else:
        ms = [torch.where(m == MASKED, m, m * LN2) for m in ms]  # the partials' m in natural-log units
        m_all = torch.stack(ms)
        m_star = m_all.amax(0)
        w = torch.exp(m_all - m_star)
        l_star = (torch.stack(ls) * w).sum(0)
        out = (torch.stack(accs) * w).sum(0) * (1 / l_star)
        lse = m_star + torch.log(l_star)
    return out.permute(0, 2, 1, 3), lse.reshape(b * h, sq)


def _inputs(b, sq, sk, h, d, seed, q_scale=4.0):
    """numpy draws from a seed; q scaled up so that the logits have standard
    deviation ``q_scale`` and the softmax is peaked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32) * np.float32(q_scale)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _rel_err(got, want) -> float:
    want = torch.as_tensor(np.array(want))  # a copy: JAX's arrays are read-only
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _jax_k1(q, k, v, scale):
    out, residuals = jax_flash_fwd(*map(jnp.asarray, (q, k, v)), scale, True)
    return np.asarray(out), np.asarray(residuals[-1])[:, : q.shape[1], 0]


def _jax_k4a(q, k, v, scale):
    out, residuals = jax_kgrid_fwd(*map(jnp.asarray, (q, k, v)), scale, True)
    return np.asarray(out), np.asarray(residuals[-1])[:, : q.shape[1], 0]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,splits", [(65, 77, 1), (129, 300, 1), (129, 300, 3), (1, 33, 2)])
def test_emulated_k1_is_within_the_fp32_bound_of_plain_and_jax(sq, sk, splits, d):
    """fp32 K1's arithmetic at its tiles, ragged on both axes, unsplit and
    split (the merge included), against the plain version and JAX's Pallas
    forward (interpret mode)."""
    q, k, v = _inputs(2, sq, sk, 2, d, seed=sq + sk + d + splits)
    scale = d**-0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = emulated_fwd(tq, tk, tv, scale, *k1_cfg(d), splits=splits)
    want_out, want_lse = fa.flash_attention_reference(tq, tk, tv, scale)
    jax_out, jax_lse = _jax_k1(q, k, v, scale)
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse), ("jax out", out, jax_out),
                            ("jax lse", lse, jax_lse)):
        assert _rel_err(got, want) <= FP32_BOUND, name


@pytest.mark.parametrize("d", [192, 512])
@pytest.mark.parametrize("sq,sk,splits", [(65, 77, 1), (33, 129, 1), (33, 129, 3)])
def test_emulated_k4a_is_within_the_fp32_bound_of_plain_and_jax(sq, sk, splits, d):
    """fp32 K4a's arithmetic at its tiles and column parts (four at d 192
    and 512), ragged, unsplit and split, against the plain version cut
    into the same key ranges and JAX's k-grid Pallas kernel (interpret
    mode)."""
    q, k, v = _inputs(1, sq, sk, 2, d, seed=sq + sk + d + splits)
    scale = d**-0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = emulated_fwd(tq, tk, tv, scale, *k4a_cfg(d), splits=splits)
    want_out, want_lse = kg.flash_attention_kgrid_reference(tq, tk, tv, scale, splits=splits)
    jax_out, jax_lse = _jax_k4a(q, k, v, scale)
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse), ("jax out", out, jax_out),
                            ("jax lse", lse, jax_lse)):
        assert _rel_err(got, want) <= FP32_BOUND, name


@pytest.mark.parametrize("d", [64, 512])
def test_one_tf32_pass_breaks_the_fp32_bound_in_the_forward(d):
    """The same forward with one TF32 pass per product (big·big): O or lse
    misses 1e-4·max(1, |ref|), so the kernels take three."""
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 256, 2, d, seed=d + 11))
    scale = d**-0.5
    cfg = k1_cfg(d) if d <= 128 else k4a_cfg(d)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, scale)
    one = emulated_fwd(q, k, v, scale, *cfg, passes=1)
    three = emulated_fwd(q, k, v, scale, *cfg)
    assert max(_rel_err(g, w) for g, w in zip(three, (want_out, want_lse))) <= FP32_BOUND
    assert max(_rel_err(g, w) for g, w in zip(one, (want_out, want_lse))) > FP32_BOUND


def test_k1_split_rule_at_the_edit_shapes():
    """fp32 K1 splits its key range only where its 128-row q tiles leave
    SMs idle (fewer than 132 blocks): of a null-text inner step's shapes (8
    heads) only 1024² (64 blocks, 5 splits); bf16 K1 never splits. K4a's fp32
    rule is unchanged by the redesign (32-row q tiles, 32-key units)."""
    assert [fa.pick_k1_splits(8, sq, sk) for sq, sk in ((4096, 4096), (4096, 77), (1024, 1024), (1024, 77))] == [
        1, 1, 5, 1]
    assert all(fa.pick_k1_splits(8, 1024, 1024, dt) == n for dt, n in ((torch.float32, 5), (torch.bfloat16, 1)))
    assert [kg.pick_splits(8, sq, sk, torch.float32) for sq, sk in ((256, 256), (256, 77), (64, 64), (64, 77))] == [
        2, 1, 1, 1]
    assert kg.pick_splits(1, 16384, 16384, torch.float32) == 1 and kg.pick_splits(1, 4096, 4096, torch.float32) == 3


def test_cpu_k1_takes_the_plain_version_whatever_the_split():
    """On the CPU the wrapper takes the plain version, which needs no split
    (a split changes only the summation order)."""
    q, k, v = map(torch.from_numpy, _inputs(1, 40, 90, 2, 64, seed=3))
    want = fa.flash_attention_reference(q, k, v, 0.125)
    for splits in (None, 1, 3):
        got = fa.flash_attention_fwd(q, k, v, 0.125, splits=splits)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
