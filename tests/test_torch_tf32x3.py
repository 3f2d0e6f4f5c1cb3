"""The arithmetic of the fp32 K2 and K3 kernels, emulated on the CPU.

On the card fp32 K2 (dQ) and K3 (dK, dV) run every product on the tensor
cores as ``mma.sync`` m16n8k8 TF32, three times per product over operands
split into TF32 halves (``csrc/hopper_tc.cuh``: ``tf32_split``,
``mma_tf32x3``): x = big + small, big = x rounded to TF32 to nearest (ties
away from zero, ``cvt.rna``: the low 13 of the 23 mantissa bits cleared),
small = the exact residual rounded again, and a·b ≈ a_small·b_big +
a_big·b_small + a_big·b_big accumulated in fp32, one 8-deep k step at a
time. This file emulates that in plain PyTorch (each TF32 product exact in
fp64, each ``mma`` rounding its sum into the fp32 accumulator) and holds the
emulated K2/K3 to the card's fp32 bound, 1e-4·max(1, |ref|), against the
plain fp32 K2/K3 (``bwd_dq_reference``, ``bwd_dkv_reference``) at head dims
64 and 128, with logits large enough that the softmax is peaked. One TF32
pass alone misses that bound: that is why the kernels take three. The
kernels themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

fp32 K4b (the k-grid dQ) and K4c (dK, dV) run the same loops at head dims
64…512 (``csrc/flash_attention_kgrid_bwd.cu``): two or four warps share a
16-row slab above d 64, each taking the slab's S and dP over the whole head
dim and a slice of the gradient columns, and the key range (K4b) or query
range (K4c) is split into 32-row units whose fp32 partials are summed in
split order. Their emulation here takes each warp's column slice apart and
sums the splits as the merge kernels do, at SD1.5's d 160 run at 192 and at
d 512, with peaked logits, one key and one query row, against the plain
fp32 ``kgrid_bwd_dq_reference`` / ``kgrid_bwd_dkv_reference`` over the same
splits.
"""

import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

FP32_BOUND = 1e-4
K_STEP = 8  # the depth of one mma.sync m16n8k8


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the dropped range added to
    the magnitude's bits, then the low 13 cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    big = to_tf32(x)
    return big, to_tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` (fp32, [..., M, K] @ [..., K, N]) as the kernels compute it:
    per 8-deep k step three TF32 products (small·big, big·small, big·big; or
    big·big alone with ``passes`` 1), each exact and added to the fp32
    accumulator with one rounding."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big))[3 - passes:]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        for x, y in terms:
            acc = (acc.double() + x[..., k0:k0 + K_STEP].double() @ y[..., k0:k0 + K_STEP, :].double()).float()
    return acc


def emulated_k2(q, k, v, o, lse, do, scale, passes=3):
    """K2 (one split) with the kernel's products: S = QKᵀ, P = exp(scale·S −
    lse), dP = dO·Vᵀ, dS = P∘(dP − δ), dQ = scale·dS·K; BSHD in, BSHD out."""
    b, sq, h, _ = q.shape
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))  # [B, H, S, D]
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    p = torch.exp(mm_3xtf32(qh, kh.transpose(-1, -2), passes) * scale - lse.reshape(b, h, sq, 1))
    ds = p * (mm_3xtf32(gh, vh.transpose(-1, -2), passes) - delta)
    return (mm_3xtf32(ds, kh, passes) * scale).permute(0, 2, 1, 3)


def emulated_k3(q, k, v, lse, delta, do, scale, passes=3):
    """K3 (one split) with the kernel's products: Sᵀ = KQᵀ, Pᵀ, dV = Pᵀ·dO,
    dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − δ), dK = scale·dSᵀ·Q."""
    b, sq, h, _ = q.shape
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    pt = torch.exp(mm_3xtf32(kh, qh.transpose(-1, -2), passes) * scale - lse.reshape(b, h, 1, sq))
    dv = mm_3xtf32(pt, gh, passes)
    dst = pt * (mm_3xtf32(vh, gh.transpose(-1, -2), passes) - delta.reshape(b, h, 1, sq))
    dk = mm_3xtf32(dst, qh, passes) * scale
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _inputs(sq, sk, h, d, seed, q_scale=4.0):
    """numpy draws from a seed; q scaled up so that |q·k|·scale is large and
    the softmax peaked (logits of standard deviation ``q_scale``)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, h, d)).astype(np.float32) * np.float32(q_scale)
    k, v = (rng.standard_normal((1, sk, h, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((1, sq, h, d)).astype(np.float32)
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_reference(q, k, v, d**-0.5)
    return q, k, v, o, lse, do


def _rel_err(got, want) -> float:
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest on the low 13 mantissa bits, ties away from zero;
    TF32 values pass unchanged; the residual is exact."""
    one = 1.0
    half_ulp = 2.0**-11  # half of TF32's ulp at 1
    x = torch.tensor([one, one + half_ulp, one + half_ulp / 2, -(one + half_ulp), 3.0, 1e-30, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one + 2 * half_ulp, one, -(one + 2 * half_ulp), 3.0, 1e-30, -0.0])
    got = to_tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert got[6].item() == 0.0 and torch.signbit(got[6])
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = tf32_split(r)
    assert torch.equal(to_tf32(big), big) and torch.equal(to_tf32(small), small)
    assert (big + (r - big) == r).all()  # the residual is exact in fp32
    # big + small carries about 21 of fp32's 24 bits
    assert ((big + small - r).abs() <= r.abs() * 2.0**-20).all()


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_product_keeps_fp32_accuracy(d):
    """One product at the kernels' depths (a head dim; 256 keys) against
    fp64: three passes err like fp32, one pass about 2^-11 of the terms."""
    rng = np.random.default_rng(d)
    a = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((d, 256)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max().item()
    fp32 = ((a @ b).double() - exact).abs().max().item() / scale
    three = (mm_3xtf32(a, b).double() - exact).abs().max().item() / scale
    one = (mm_3xtf32(a, b, passes=1).double() - exact).abs().max().item() / scale
    assert three <= 4 * max(fp32, 2.0**-24)
    assert one > 2.0**-14 > 16 * three


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(128, 256), (65, 77)])
def test_emulated_3xtf32_k2_is_within_the_fp32_bound(sq, sk, d):
    q, k, v, o, lse, do = _inputs(sq, sk, 2, d, seed=sq + sk + d)
    want, _ = fa.bwd_dq_reference(q, k, v, o, lse, do, d**-0.5, splits=1)
    got = emulated_k2(q, k, v, o, lse, do, d**-0.5)
    assert _rel_err(got, want) <= FP32_BOUND


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(256, 128), (77, 65)])
def test_emulated_3xtf32_k3_is_within_the_fp32_bound(sq, sk, d):
    q, k, v, o, lse, do = _inputs(sq, sk, 2, d, seed=sq + sk + d + 1)
    _, delta = fa.bwd_dq_reference(q, k, v, o, lse, do, d**-0.5, splits=1)
    want = fa.bwd_dkv_reference(q, k, v, lse, delta, do, d**-0.5, splits=1)
    got = emulated_k3(q, k, v, lse, delta, do, d**-0.5)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert _rel_err(g, w) <= FP32_BOUND, name


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_pass_breaks_the_fp32_bound(d):
    """The same K2 and K3 with one TF32 pass per product (big·big): at
    least one gradient misses 1e-4·max(1, |ref|), so the kernels take three."""
    q, k, v, o, lse, do = _inputs(128, 256, 2, d, seed=d + 7)
    scale = d**-0.5
    want_dq, delta = fa.bwd_dq_reference(q, k, v, o, lse, do, scale, splits=1)
    want_dk, want_dv = fa.bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits=1)
    one = (emulated_k2(q, k, v, o, lse, do, scale, passes=1), *emulated_k3(q, k, v, lse, delta, do, scale, passes=1))
    errs = [_rel_err(g, w) for g, w in zip(one, (want_dq, want_dk, want_dv))]
    assert max(errs) > FP32_BOUND, errs


def _heads(*xs):
    return [x.permute(0, 2, 1, 3) for x in xs]  # BSHD -> [B, H, S, D]


def emulated_k4b(q, k, v, o, lse, do, scale, splits, warps_per_slab):
    """fp32 K4b with the kernel's products: per split of the key range (32-key
    units) S = QKᵀ, P = exp(scale·S − lse), dP = dO·Vᵀ, dS = P∘(dP − δ) over
    the whole head dim, and each of a slab's ``warps_per_slab`` warps its
    slice of the unscaled partial dS·K; the partials summed in split order
    from zero (an empty split adds zeros), then scaled."""
    b, sq, h, d = q.shape
    qh, kh, vh, gh = _heads(q, k, v, do)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    dc = d // warps_per_slab
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32)
    for lo, hi in kg.split_ranges(k.shape[1], splits):
        if lo == hi:
            continue
        kk, vv = kh[:, :, lo:hi], vh[:, :, lo:hi]
        p = torch.exp(mm_3xtf32(qh, kk.transpose(-1, -2)) * scale - lse.reshape(b, h, sq, 1))
        ds = p * (mm_3xtf32(gh, vv.transpose(-1, -2)) - delta)
        acc = acc + torch.cat([mm_3xtf32(ds, kk[..., c:c + dc]) for c in range(0, d, dc)], dim=-1)
    return (acc * scale).permute(0, 2, 1, 3)


def emulated_k4c(q, k, v, lse, delta, do, scale, splits, warps_per_slab):
    """fp32 K4c with the kernel's products: per split of the query range Sᵀ =
    KQᵀ, Pᵀ, dPᵀ = V·dOᵀ, dSᵀ over the whole head dim, each warp's column
    slice of dV = Pᵀ·dO and dK = scale·dSᵀ·Q (scaled in the partial); the
    partials summed in split order."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh, kh, vh, gh = _heads(q, k, v, do)
    lse4, delta4 = lse.reshape(b, h, 1, sq), delta.reshape(b, h, 1, sq)
    dc = d // warps_per_slab
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32)
    dv = torch.zeros((b, h, sk, d), dtype=torch.float32)
    for lo, hi in kg.split_ranges(sq, splits):
        if lo == hi:
            continue
        qq, gg = qh[:, :, lo:hi], gh[:, :, lo:hi]
        pt = torch.exp(mm_3xtf32(kh, qq.transpose(-1, -2)) * scale - lse4[..., lo:hi])
        dst = pt * (mm_3xtf32(vh, gg.transpose(-1, -2)) - delta4[..., lo:hi])
        cols = range(0, d, dc)
        dv = dv + torch.cat([mm_3xtf32(pt, gg[..., c:c + dc]) for c in cols], dim=-1)
        dk = dk + torch.cat([mm_3xtf32(dst, qq[..., c:c + dc]) * scale for c in cols], dim=-1)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _kgrid_inputs(sq, sk, h, d, d_pad, seed, q_scale=4.0):
    """``_inputs`` at head dim ``d`` zero-padded to ``d_pad`` (as
    ops/attention.py pads d 160 to 192), with K4a's plain O and lse."""
    rng = np.random.default_rng(seed)
    pad = [(0, 0)] * 3 + [(0, d_pad - d)]
    q = np.pad(rng.standard_normal((1, sq, h, d)).astype(np.float32) * np.float32(q_scale), pad)
    k, v = (np.pad(rng.standard_normal((1, sk, h, d)).astype(np.float32), pad) for _ in range(2))
    do = np.pad(rng.standard_normal((1, sq, h, d)).astype(np.float32), pad)
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    o, lse = kg.flash_attention_kgrid_reference(q, k, v, d**-0.5, splits=1)
    return q, k, v, o, lse, do


# (d, padded d, warps per 16-row slab): SD1.5's 160 run at 192, its columns
# split between two warps; d 512, one slab a block, four warps
K4_CONFIGS = [(160, 192, 2), (512, 512, 4)]
# (Sq, Sk): ragged on both axes (100 keys or queries are four 32-row units,
# so 2 and 3 splits cut 64 + 36 and 32 + 32 + 36), one key, one query row
K4_SHAPES = [(77, 100), (100, 77), (65, 1), (1, 65)]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("sq,sk", K4_SHAPES)
@pytest.mark.parametrize("d,d_pad,warps", K4_CONFIGS)
def test_emulated_3xtf32_k4b_is_within_the_fp32_bound(d, d_pad, warps, sq, sk, splits):
    q, k, v, o, lse, do = _kgrid_inputs(sq, sk, 2, d, d_pad, seed=sq + 3 * sk + d + splits)
    scale = d**-0.5
    want, _ = kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale, splits=splits)
    got = emulated_k4b(q, k, v, o, lse, do, scale, splits, warps)
    assert _rel_err(got, want) <= FP32_BOUND
    # the column split only hands out the columns: one warp's products are the same bits
    assert torch.equal(got, emulated_k4b(q, k, v, o, lse, do, scale, splits, 1))


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("sq,sk", K4_SHAPES)
@pytest.mark.parametrize("d,d_pad,warps", K4_CONFIGS)
def test_emulated_3xtf32_k4c_is_within_the_fp32_bound(d, d_pad, warps, sq, sk, splits):
    q, k, v, o, lse, do = _kgrid_inputs(sq, sk, 2, d, d_pad, seed=sq + 3 * sk + d + splits + 1)
    scale = d**-0.5
    _, delta = kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale, splits=1)
    want = kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, scale, splits=splits)
    got = emulated_k4c(q, k, v, lse, delta, do, scale, splits, warps)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert _rel_err(g, w) <= FP32_BOUND, name
