"""Kernels K1, K2, K3, K4a, K4b and K4c on the card: edge shapes, strided
views (dO from autograd included), the dispatch's head-dim padding and
routes, gradients through the autograd Functions, K4a's key-range and K4c's
query-range splits, determinism, input checks and the launch counts; SD3's
joint lengths (K1 at 1357 and 4429, K2/K3 at 1357, 24 heads of 64) and the
tiny MMDiT and SD3 sampler against the CPU; Stable Cascade's prior
attentions (K1 at 144×229 and 36×121, rows 2 and 4; K2/K3 at rows 2; 32
heads of 64) and the tiny prior and an ESD step against the CPU; an fp32
null-text optimisation step and the attention controllers' launches; the
baselines' token growth and K/V patch against the CPU; fp32 K2/K3 on the
tensor cores (3xTF32) at every shape of a null-text inner step, ragged,
strided and unaligned, with forced splits and bit-equal repeats; fp32 K1
and K4a on the tensor cores at every forward shape of a null-text inner
step and every head dim they are built for, ragged, strided and unaligned,
with forced splits and bit-equal repeats; fp32 K4b and K4c on the tensor
cores at every 1280-channel shape of a null-text inner step and every head
dim they are built for, ragged down to one row and one key, strided and
unaligned, with forced splits and bit-equal repeats. Marked
``cuda``; every test
skips where there is no CUDA device (this file imports no JAX, so it runs on
the GPU machine as it is):

    python -m pytest tests/test_torch_cuda.py -q
"""

import copy

import pytest
import torch

from sliders_conceptmod_tpu_torch.ops import attention as attn
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


EDGE = [
    # (B, Sq, Sk, H, D): one row / one key, ragged tails around the 64 tile,
    # several K tiles, the 128 head dim, many (batch, head) blocks
    (1, 1, 1, 1, 64),
    (1, 1, 300, 2, 64),
    (2, 65, 63, 3, 64),
    (1, 64, 64, 1, 128),
    (2, 129, 129, 2, 128),
    (3, 200, 77, 5, 64),
    (1, 16, 1, 40, 64),
]


@pytest.mark.parametrize("shape", EDGE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(gen, shape, dtype):
    b, sq, sk, h, d = shape
    q = _rand(gen, (b, sq, h, d), dtype, scale=3.0)  # large logits: the online max must hold
    k = _rand(gen, (b, sk, h, d), dtype)
    v = _rand(gen, (b, sk, h, d), dtype)
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), d**-0.5)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (b * h, sq)
    # bf16: output rounding costs up to 2^-8·|out|; bound it relative to the
    # reference's largest value, never above 3e-2
    tol = 1e-4 if dtype == torch.float32 else min(3e-2, 2e-2 * ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * max(1.0, ref_lse.abs().max().item())


def test_strided_views_give_the_contiguous_result(gen):
    """BSHD views of a packed qkv tensor and of a BHSD tensor run without a
    copy and give bit-identical outputs to contiguous copies."""
    b, s, h, d = 2, 130, 4, 64
    qkv = _rand(gen, (b, s, 3, h, d), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v)
    out_c, lse_c = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    bhsd = _rand(gen, (b, h, s, d), torch.float32)
    out_t, _ = fa.flash_attention_fwd(bhsd.transpose(1, 2), bhsd.transpose(1, 2), bhsd.transpose(1, 2))
    out_tc, _ = fa.flash_attention_fwd(*(bhsd.transpose(1, 2).contiguous(),) * 3)
    assert torch.equal(out_t, out_tc)


@pytest.mark.parametrize("d", [40, 64, 80, 128])
def test_dispatch_runs_the_kernel_for_every_head_dim_up_to_128(gen, d):
    q, k, v = (_rand(gen, (2, s, 3, d), torch.float32) for s in (97, 77, 77))
    before = fa.flash_attention_fwd.launches
    got = attn.dot_product_attention(q, k, v)
    assert fa.flash_attention_fwd.launches == before + 1
    want, _ = fa.flash_attention_reference(q, k, v, d**-0.5)
    assert got.shape == q.shape
    assert (got - want).abs().max().item() <= 1e-4


def test_head_dims_129_to_512_run_k4a_and_above_raise(gen):
    """No attention on the card reaches a plain version: d 129..512 runs K4a
    (padded to a multiple of 64), d > 512 raises."""
    plain = lambda: (fa.flash_attention_reference.cuda_calls, kg.flash_attention_kgrid_reference.cuda_calls)
    for d in (200, 512):
        q, k, v = (_rand(gen, (2, s, 1, d), torch.float32) for s in (97, 77, 77))
        before, before_plain = (fa.flash_attention_fwd.launches, kg.flash_attention_kgrid_fwd.launches), plain()
        got = attn.dot_product_attention(q, k, v)
        assert (fa.flash_attention_fwd.launches, kg.flash_attention_kgrid_fwd.launches) == (before[0], before[1] + 1)
        assert plain() == before_plain
        want, _ = kg.flash_attention_kgrid_reference(q, k, v, d**-0.5)
        assert got.shape == q.shape and (got - want).abs().max().item() <= 1e-4
    q = _rand(gen, (1, 16, 1, 576), torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attn.dot_product_attention(q, q, q)


KGRID_EDGE = [
    # (B, Sq, Sk, H, D): one row / one key, the JAX test's ragged shape at
    # D 64 and 512, ragged tails around the 32 tiles, every D class, long keys
    (1, 1, 1, 1, 512),
    (2, 300, 77, 2, 64),
    (2, 300, 77, 2, 512),
    (1, 65, 33, 1, 192),
    (3, 100, 130, 2, 256),
    (1, 40, 1000, 1, 448),
    (2, 64, 64, 1, 128),
]


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("shape", KGRID_EDGE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kgrid_kernel_matches_plain_version(gen, shape, dtype, splits):
    b, sq, sk, h, d = shape
    q = _rand(gen, (b, sq, h, d), dtype, scale=3.0)  # large logits: the online max must hold
    k = _rand(gen, (b, sk, h, d), dtype)
    v = _rand(gen, (b, sk, h, d), dtype)
    before = kg.flash_attention_kgrid_fwd.launches
    out, lse = kg.flash_attention_kgrid_fwd(q, k, v, splits=splits)
    torch.cuda.synchronize()
    assert kg.flash_attention_kgrid_fwd.launches == before + 1
    ref, ref_lse = kg.flash_attention_kgrid_reference(q.float(), k.float(), v.float(), d**-0.5, splits=splits)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (b * h, sq)
    tol = 1e-4 if dtype == torch.float32 else min(3e-2, 2e-2 * ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * max(1.0, ref_lse.abs().max().item())


def test_kgrid_empty_splits_and_strided_views(gen):
    """More splits than key tiles (empty splits merge to nothing, no NaN),
    and BSHD views of packed tensors give bit-identical results to copies."""
    b, s, h, d = 2, 130, 2, 512
    qkv = _rand(gen, (b, s, 3, h, d), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    for splits in (1, 7):  # 130 keys are 3 of the bf16 kernel's 64-key units: splits 3 to 6 are empty
        out, lse = kg.flash_attention_kgrid_fwd(q, k, v, splits=splits)
        out_c, lse_c = kg.flash_attention_kgrid_fwd(q.contiguous(), k.contiguous(), v.contiguous(), splits=splits)
        assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    one, _ = kg.flash_attention_kgrid_fwd(q, k, v, splits=1)
    assert (out.float() - one.float()).abs().max().item() <= 2e-2 * one.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kgrid_unaligned_views_match_contiguous_copies(gen, dtype):
    """Views whose rows do not start on 16 bytes (an offset of one element,
    a row stride of d + 1) are copied once by the wrapper, whose 16-byte loads
    (TMA in bf16) need aligned rows: the contiguous copies' bits."""
    b, s, h, d = 2, 70, 2, 512
    q, k, v = (_rand(gen, (b, s, h, d + 1), dtype)[..., 1:] for _ in range(3))
    for splits in (1, 3):
        out, lse = kg.flash_attention_kgrid_fwd(q, k, v, splits=splits)
        out_c, lse_c = kg.flash_attention_kgrid_fwd(q.contiguous(), k.contiguous(), v.contiguous(), splits=splits)
        assert torch.equal(out, out_c) and torch.equal(lse, lse_c)


def test_kgrid_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = _rand(gen, (1, 8, 1, 512), torch.float32)
    before = kg.flash_attention_kgrid_fwd.launches
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_fwd(*(_rand(gen, (1, 8, 1, 200), torch.float32),) * 3)  # head dim
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_fwd(q.half(), q.half(), q.half())  # dtype
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_fwd(q, q, q, splits=65)
    assert kg.flash_attention_kgrid_fwd.launches == before
    # an input that requires grad takes the autograd Function (K4b/K4c backward), one K4a launch
    out, lse = kg.flash_attention_kgrid_fwd(q.clone().requires_grad_(True), q, q)
    assert out.requires_grad and not lse.requires_grad
    assert kg.flash_attention_kgrid_fwd.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = _rand(gen, (1, 8, 2, 64), torch.float32)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(*(_rand(gen, (1, 8, 2, 96), torch.float32),) * 3)  # head dim
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())  # dtype
    strided = _rand(gen, (1, 8, 2, 128), torch.float32)[..., ::2]
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(strided, strided, strided)  # head-dim stride
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q.cpu(), q)  # devices
    leaf = q.clone().requires_grad_(True)
    with torch.no_grad():
        fa.flash_attention_fwd(leaf, q, q)
    assert fa.flash_attention_fwd.launches == before + 1
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, q, torch.zeros(2, 8, device="cuda"), q.half(), 0.125)  # dO dtype


def _bwd_inputs(gen, shape, dtype):
    b, sq, sk, h, d = shape
    # N(0,1) as on the training path: with larger logits |dK| reaches 8 and
    # more, where bf16's own rounding (2^-8 of the value) passes the 3e-2 cap
    q, do = (_rand(gen, (b, sq, h, d), dtype) for _ in range(2))
    k, v = (_rand(gen, (b, sk, h, d), dtype) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    return q, k, v, o, lse, do


def _grad_tol(ref, dtype):
    # fp32: the same math up to summation order. bf16: rounding the gradient
    # alone costs up to 2^-8 of its value, so 2e-2 of the largest — with no
    # 3e-2 cap, since gradients are not bounded as softmax outputs are (with
    # one key dV is the sum of the dO rows, |dV| up to ~14 here) — and never
    # below the fp32 bound: with one key dQ is 0 in exact math (δ = dO·v) and
    # only summation order is left on either side
    m = ref.abs().max().item()
    return 1e-4 * max(1.0, m) if dtype == torch.float32 else max(1e-4, 2e-2 * m)


@pytest.mark.parametrize("shape", EDGE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_version(gen, shape, dtype):
    q, k, v, o, lse, do = _bwd_inputs(gen, shape, dtype)
    b0, b1 = fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (b0 + 1, b1 + 1)
    want = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                            shape[-1] ** -0.5)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        err = (g.float() - w).abs().max().item()
        assert err <= _grad_tol(w, dtype), (name, err, w.abs().max().item())


def test_backward_takes_strided_do_and_views(gen):
    """dO as a non-contiguous view (a head slice of a wider tensor) and q/k/v
    as views of a packed tensor give bit-identical gradients to contiguous
    copies."""
    b, s, h, d = 2, 130, 3, 64
    qkv = _rand(gen, (b, s, 3, h, d), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = fa.flash_attention_fwd(q, k, v)
    wide = _rand(gen, (b, s, 2 * h, d), torch.bfloat16)
    do = wide[:, :, 1::2]
    assert not do.is_contiguous() and not q.is_contiguous()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    want = fa.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do.contiguous(), 0.125)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", [40, 64, 128])
def test_autograd_through_the_dispatch_runs_k1_k2_k3(gen, d):
    """Gradients of the dispatch (head dims padded to 64/128 through F.pad)
    against torch autograd through the plain version, fp32."""
    q, k, v = (_rand(gen, (2, s, 3, d), torch.float32).requires_grad_(True) for s in (97, 77, 77))
    w = _rand(gen, (2, 97, 3, d), torch.float32)
    counts = lambda: (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)
    before = counts()
    (attn.dot_product_attention(q, k, v) * w).sum().backward()
    assert counts() == tuple(c + 1 for c in before)
    got = [x.grad.clone() for x in (q, k, v)]
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    (fa.flash_attention_reference(qr, kr, vr, d**-0.5)[0] * w).sum().backward()
    for g, x in zip(got, (qr, kr, vr)):
        assert (g - x.grad).abs().max().item() <= 1e-4 * max(1.0, x.grad.abs().max().item())


KGRID_BWD_EDGE = [
    # (B, Sq, Sk, H, D): one row / one key, the JAX test's ragged shape at D
    # 64 and 512, ragged tails around the 32 tiles, the 16-row blocks above
    # D 256, SD1.5's d-160 (padded to 192) training shapes, long keys
    (1, 1, 1, 1, 512),
    (2, 300, 77, 2, 64),
    (2, 300, 77, 2, 512),
    (1, 65, 33, 3, 192),
    (3, 100, 130, 2, 256),
    (1, 40, 1000, 1, 448),
    (1, 256, 77, 8, 192),
    (2, 64, 64, 8, 192),
]


def _kgrid_bwd_inputs(gen, shape, dtype):
    b, sq, sk, h, d = shape
    q, do = (_rand(gen, (b, sq, h, d), dtype) for _ in range(2))
    k, v = (_rand(gen, (b, sk, h, d), dtype) for _ in range(2))
    o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("shape", KGRID_BWD_EDGE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kgrid_backward_kernels_match_plain_version(gen, shape, dtype, splits):
    """K4b (dQ, δ) and K4c (dK, dV, over ``splits`` query ranges) against
    their plain versions on the same inputs and K4a's O and lse."""
    q, k, v, o, lse, do = _kgrid_bwd_inputs(gen, shape, dtype)
    scale = shape[-1] ** -0.5
    b0, b1 = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
    dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
    torch.cuda.synchronize()
    assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == (b0 + 1, b1 + 1)
    wdq, wdelta = kg.kgrid_bwd_dq_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
    wdk, wdv = kg.kgrid_bwd_dkv_reference(q.float(), k.float(), v.float(), lse, wdelta, do.float(), scale, splits)
    assert (delta - wdelta).abs().max().item() <= 1e-4 * max(1.0, wdelta.abs().max().item())
    for name, g, w, x in zip(("dq", "dk", "dv"), (dq, dk, dv), (wdq, wdk, wdv), (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - w).abs().max().item()
        assert err <= _grad_tol(w, dtype), (name, err, w.abs().max().item())


def test_kgrid_backward_views_are_bit_identical_and_deterministic(gen):
    """dO as a head slice of a wider tensor and q/k/v as views of a packed
    tensor give the contiguous copies' gradients bit for bit; views whose rows
    do not start on 16 bytes (element staging) too; and two identical calls
    with the query range split give the same bits (no atomics)."""
    b, s, h, d = 2, 130, 3, 192
    qkv = _rand(gen, (b, s, 3, h, d), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
    do = _rand(gen, (b, s, 2 * h, d), torch.bfloat16)[:, :, 1::2]
    assert not do.is_contiguous() and not q.is_contiguous()
    for splits in (1, 3):
        got = kg.flash_attention_kgrid_bwd(q, k, v, o, lse, do, d**-0.5, splits=splits)
        again = kg.flash_attention_kgrid_bwd(q, k, v, o, lse, do, d**-0.5, splits=splits)
        want = kg.flash_attention_kgrid_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                                            do.contiguous(), d**-0.5, splits=splits)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a) and torch.equal(g, w)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (_rand(gen, (b, s, h, d + 1), dtype)[..., 1:] for _ in range(4))
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
        got = kg.flash_attention_kgrid_bwd(q, k, v, o, lse, do, d**-0.5, splits=2)
        want = kg.flash_attention_kgrid_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                                            do.contiguous(), d**-0.5, splits=2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("d", [160, 200, 512])
def test_autograd_through_the_dispatch_runs_k4a_k4b_k4c(gen, d):
    """Gradients of the dispatch at head dims 129..512 (160 and 200 padded to
    192 and 256 through F.pad) against torch autograd through the plain
    forward, fp32; one launch of each k-grid kernel and none of a plain
    version on the card."""
    q, k, v = (_rand(gen, (2, s, 2, d), torch.float32).requires_grad_(True) for s in (97, 77, 77))
    w = _rand(gen, (2, 97, 2, d), torch.float32)
    counts = lambda: (kg.flash_attention_kgrid_fwd.launches, kg.flash_attention_kgrid_bwd_dq.launches,  # noqa: E731
                      kg.flash_attention_kgrid_bwd_dkv.launches)
    plain = lambda: (kg.kgrid_bwd_dq_reference.cuda_calls, kg.kgrid_bwd_dkv_reference.cuda_calls,  # noqa: E731
                     kg.flash_attention_kgrid_reference.cuda_calls)
    before, before_plain = counts(), plain()
    (attn.dot_product_attention(q, k, v) * w).sum().backward()
    assert counts() == tuple(c + 1 for c in before) and plain() == before_plain
    got = [x.grad.clone() for x in (q, k, v)]
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    (fa.flash_attention_reference(qr, kr, vr, d**-0.5)[0] * w).sum().backward()
    for g, x in zip(got, (qr, kr, vr)):
        assert (g - x.grad).abs().max().item() <= 1e-4 * max(1.0, x.grad.abs().max().item())


def test_kgrid_backward_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = _rand(gen, (1, 8, 1, 512), torch.float32)
    lse = torch.zeros((1, 8), device="cuda")
    before = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
    odd = _rand(gen, (1, 8, 1, 200), torch.float32)
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_bwd_dq(odd, odd, odd, odd, lse, odd, 0.1)  # head dim
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_bwd_dq(q, q, q, q, lse, q.half(), 0.1)  # dO dtype
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_bwd_dkv(q, q, q, lse, lse, _rand(gen, (1, 8, 1, 1024), torch.float32)[..., ::2],
                                         0.1)  # dO head-dim stride
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_bwd_dkv(q, q, q, lse, lse, q, 0.1, splits=65)
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_bwd_dkv(q, q, q.cpu(), lse, lse, q, 0.1)  # devices
    assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == before


# --- the tensor-core kernels: K1 (wgmma, TMA) and K3 (mma.sync, cp.async) on bf16


def _fwd_tol(ref):
    return min(3e-2, 2e-2 * ref.abs().max().item())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 77, 129, 4097])
def test_tensor_core_k1_on_ragged_lengths(gen, d, s):
    """bf16 K1 with Sq and Sk around its 128-row tiles (TMA zero-fills the
    box past the end; padded keys are masked before the max)."""
    for sq, sk in ((s, s), (s, 77), (77, s)):
        q = _rand(gen, (2, sq, 3, d), torch.bfloat16, scale=3.0)
        k, v = (_rand(gen, (2, sk, 3, d), torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), d**-0.5)
        assert (out.float() - ref).abs().max().item() <= _fwd_tol(ref), (sq, sk)
        assert (lse - ref_lse).abs().max().item() <= 1e-4 * max(1.0, ref_lse.abs().max().item()), (sq, sk)


@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_kernels_take_head_slices_and_unaligned_views(gen, d):
    """q/k/v/dO as head slices of a wider tensor (the TMA maps and cp.async
    read their strides) give the contiguous copies' results bit for bit; a
    view whose rows do not start on 16 bytes is copied once by the wrapper
    (as the sources' headers say) and gives the same bits too."""
    b, s, h = 2, 200, 3
    wide = [_rand(gen, (b, s, 2 * h, d), torch.bfloat16)[:, :, 1::2] for _ in range(4)]
    odd = [_rand(gen, (b, s, h, d + 8), torch.bfloat16)[..., 1:d + 1] for _ in range(4)]
    for q, k, v, do in (wide, odd):
        assert not q.is_contiguous()
        out, lse = fa.flash_attention_fwd(q, k, v)
        out_c, lse_c = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
        assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, d**-0.5)
        want = fa.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse, do.contiguous(),
                                      d**-0.5)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(1, 300, 77, 2, 64), (1, 256, 77, 8, 128), (2, 65, 129, 3, 64)])
def test_tensor_core_k3_forced_splits_match_plain_version(gen, shape):
    """K3 bf16 with the query range split 1, 2 and 64 ways (empty splits
    included) against the plain version over the same splits; a repeated call
    gives the same bits (partials summed in split order, no atomics); the
    fp32 kernel splits as well (its own cases: test_fp32_k2_k3_forced_splits_...)."""
    q, k, v, o, lse, do = _bwd_inputs(gen, shape, torch.bfloat16)
    scale = shape[-1] ** -0.5
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    for splits in (1, 2, fa.MAX_SPLITS):
        before = fa.flash_attention_bwd_dkv.launches
        got = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
        again = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
        torch.cuda.synchronize()
        assert fa.flash_attention_bwd_dkv.launches == before + 2
        want = fa.bwd_dkv_reference(q.float(), k.float(), v.float(), lse, delta, do.float(), scale, splits=splits)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            assert (g.float() - w).abs().max().item() <= _grad_tol(w, torch.bfloat16), splits
    f = [x.float() for x in (q, k, v, do)]
    got = fa.flash_attention_bwd_dkv(f[0], f[1], f[2], lse, delta, f[3], scale, splits=2)
    want = fa.bwd_dkv_reference(f[0], f[1], f[2], lse, delta, f[3], scale, splits=2)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= _grad_tol(w, torch.float32)


def test_tensor_core_k3_is_deterministic_at_the_split_shapes(gen):
    """SDXL's 1024x77 cross attention (10 heads: 4 splits by the rule) and
    1024² (2 splits): two calls, the same bits."""
    for sk, want_splits in ((77, 4), (1024, 2)):
        q, k, v, o, lse, do = _bwd_inputs(gen, (1, 1024, sk, 10, 64), torch.bfloat16)
        assert fa.pick_k3_splits(10, 1024, sk) == want_splits
        first = fa.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
        second = fa.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d", [40, 64, 80, 128])
def test_autograd_through_the_dispatch_in_bf16(gen, d):
    """bf16 through ops/attention.py (head dims padded to 64/128): K1 forward,
    K2 + K3 backward, one launch each and no plain version on the card;
    gradients against fp32 torch autograd through the plain forward within
    the bf16 gradient bound."""
    q, k, v = (_rand(gen, (2, s, 3, d), torch.bfloat16).requires_grad_(True) for s in (300, 77, 77))
    w = _rand(gen, (2, 300, 3, d), torch.bfloat16)
    counts = lambda: (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,  # noqa: E731
                      fa.flash_attention_bwd_dkv.launches)
    plain = lambda: (fa.flash_attention_reference.cuda_calls, fa.bwd_dq_reference.cuda_calls,  # noqa: E731
                     fa.bwd_dkv_reference.cuda_calls)
    before, before_plain = counts(), plain()
    (attn.dot_product_attention(q, k, v).float() * w.float()).sum().backward()
    assert counts() == tuple(c + 1 for c in before) and plain() == before_plain
    got = [x.grad.float() for x in (q, k, v)]
    qr, kr, vr = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    (fa.flash_attention_reference(qr, kr, vr, d**-0.5)[0] * w.float()).sum().backward()
    for g, x in zip(got, (qr, kr, vr)):
        assert g.shape == x.shape
        assert (g - x.grad).abs().max().item() <= _grad_tol(x.grad, torch.bfloat16)


# --- the tensor-core kernels K2 (mma.sync, cp.async) and K4a (wgmma, TMA) on bf16


def _kernel_names(fn):
    """Names of the kernels ``fn`` runs on the card (torch.profiler): the
    union over three windows of one call each. The profiler now and then
    drops some or all of a window's kernel events (a window with no event at
    all; one that held K4c's merge but not K4c), never adds one."""
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names |= {e.name for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")}
    return names


def _check_k2(q, k, v, o, lse, do, scale, splits=None):
    """K2 against its plain version over the same key splits; δ within the
    fp32 bound (the same products, summed in another order). Returns
    (dQ, δ)."""
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=splits)
    torch.cuda.synchronize()
    b, sq, h, _ = q.shape
    used = fa.pick_k2_splits(b * h, sq, k.shape[1], q.dtype) if splits is None else splits
    want, want_delta = fa.bwd_dq_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale, used)
    assert dq.dtype == q.dtype and dq.shape == q.shape and delta.shape == (b * h, sq)
    assert (dq.float() - want).abs().max().item() <= _grad_tol(want, q.dtype), (tuple(q.shape), k.shape[1], used)
    assert (delta - want_delta).abs().max().item() <= 1e-4 * max(1.0, want_delta.abs().max().item())
    return dq, delta


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 77, 129, 4097])
def test_tensor_core_k2_on_ragged_lengths(gen, d, s):
    """bf16 K2 with Sq and Sk around its 64-row q tiles and 64-key tiles
    (cp.async zero-fills rows past the end; keys past Sk get P = 0), with the
    split the rule picks."""
    for sq, sk in ((s, s), (s, 77), (77, s)):
        b, h = 2, 3
        q, do = (_rand(gen, (b, sq, h, d), torch.bfloat16) for _ in range(2))
        k, v = (_rand(gen, (b, sk, h, d), torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v)
        _check_k2(q, k, v, o, lse, do, d**-0.5)


@pytest.mark.parametrize("shape", [(1, 1024, 1024, 10, 64), (1, 1024, 77, 10, 64), (2, 300, 129, 3, 128),
                                   (1, 65, 4097, 2, 64)])
def test_tensor_core_k2_forced_splits_match_plain_version(gen, shape):
    """K2 bf16 with the key range split 1, 2 and 64 ways (empty splits
    included) against the plain version over the same splits; a repeated
    call gives the same bits (partials summed in split order, no atomics);
    δ is the same bits whatever the split (split 0 writes it); the fp32
    kernel splits as well."""
    q, k, v, o, lse, do = _bwd_inputs(gen, shape, torch.bfloat16)
    scale = shape[-1] ** -0.5
    deltas = []
    for splits in (1, 2, fa.MAX_SPLITS):
        before = fa.flash_attention_bwd_dq.launches
        got, delta = _check_k2(q, k, v, o, lse, do, scale, splits)
        again, delta_again = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=splits)
        torch.cuda.synchronize()
        assert fa.flash_attention_bwd_dq.launches == before + 2
        assert torch.equal(got, again) and torch.equal(delta, delta_again)
        deltas.append(delta)
    assert all(torch.equal(deltas[0], x) for x in deltas[1:])
    f = [x.float() for x in (q, k, v, o, do)]
    got, _ = fa.flash_attention_bwd_dq(*f[:4], lse, f[4], scale, splits=2)
    want, _ = fa.bwd_dq_reference(*f[:4], lse, f[4], scale, splits=2)
    assert (got - want).abs().max().item() <= _grad_tol(want, torch.float32)


def test_tensor_core_k2_takes_strided_do_head_slices_and_unaligned_views(gen):
    """q, k, v, o and dO as head slices of wider tensors (autograd's strided
    dO among them) and as views off 16 bytes (copied once by the wrapper):
    the contiguous copies' bits, with one K2 launch each."""
    b, sq, sk, h, d = 2, 200, 77, 3, 64
    for make in (lambda s: _rand(gen, (b, s, 2 * h, d), torch.bfloat16)[:, :, 1::2],
                 lambda s: _rand(gen, (b, s, h, d + 8), torch.bfloat16)[..., 1:d + 1]):
        q, k, v, do = make(sq), make(sk), make(sk), make(sq)
        o = make(sq)
        o.copy_(fa.flash_attention_fwd(q, k, v)[0])
        _, lse = fa.flash_attention_fwd(q, k, v)
        assert not (q.is_contiguous() or o.is_contiguous() or do.is_contiguous())
        before = fa.flash_attention_bwd_dq.launches
        got = _check_k2(q, k, v, o, lse, do, d**-0.5)
        want = fa.flash_attention_bwd_dq(*(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous(), d**-0.5)
        assert fa.flash_attention_bwd_dq.launches == before + 2
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_k2_and_k4a_route_bf16_to_the_tensor_cores_and_fp32_to_the_simt_kernels(gen):
    """The kernels that run, by name: bf16 K2 is flash_bwd_dq_tc_kernel and
    fp32 K2 the 3xTF32 flash_bwd_dq_tf32_kernel (each with its merge when
    split); bf16 K4a is kgrid_fwd_tc_kernel, fp32 K4a the 3xTF32
    kgrid_fwd_tf32_kernel (the SIMT kernels are gone)."""
    for dtype, want_k2, want_k4a in ((torch.bfloat16, "flash_bwd_dq_tc_kernel", "kgrid_fwd_tc_kernel"),
                                     (torch.float32, "flash_bwd_dq_tf32_kernel", "kgrid_fwd_tf32_kernel")):
        q, k, v, o, lse, do = _bwd_inputs(gen, (1, 1024, 1024, 10, 64), dtype)
        names = _kernel_names(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, 0.125))
        assert any(want_k2 in n for n in names), names
        assert any("flash_dq_merge_kernel" in n for n in names), names  # 2 splits
        if dtype == torch.float32:
            assert not any("_tc_" in n for n in names), names
        x = _rand(gen, (1, 1024, 1, 512), dtype)
        names = _kernel_names(lambda: kg.flash_attention_kgrid_fwd(x, x, x))
        assert any(want_k4a in n for n in names), names
        if dtype == torch.float32:
            assert not any("_tc_" in n for n in names), names


# --- fp32 K2 and K3 on the tensor cores (3xTF32 mma.sync m16n8k8)

# null-text inversion editing (SD1.5 at 512px, fp32, rows 1, 8 heads): every
# K2/K3 shape of an inner step, (Sq, Sk, unpadded head dim)
EDIT_K23_SHAPES = [(4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80), (1024, 77, 80)]


def _padded_fp32_inputs(gen, b, sq, sk, h, d):
    """fp32 inputs zero-padded in the head dim to 64 or 128, as
    ops/attention.py pads them, with K1's O and lse."""
    pad = -d % 64
    q, do = (torch.nn.functional.pad(_rand(gen, (b, sq, h, d), torch.float32), (0, pad)) for _ in range(2))
    k, v = (torch.nn.functional.pad(_rand(gen, (b, sk, h, d), torch.float32), (0, pad)) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, d**-0.5)
    return q, k, v, o, lse, do


def _check_fp32_k2_k3(q, k, v, o, lse, do, scale, splits=None, dq_splits=None):
    """fp32 K2 then K3 against their plain versions over the same splits,
    each within 1e-4·max(1, |ref|), δ too; a repeated call gives the same
    bits. Returns (dQ, δ, dK, dV)."""
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=dq_splits)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
    again = (*fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=dq_splits),
             *fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits))
    torch.cuda.synchronize()
    want_dq, want_delta = fa.bwd_dq_reference(q, k, v, o, lse, do, scale, dq_splits)
    want_dk, want_dv = fa.bwd_dkv_reference(q, k, v, lse, want_delta, do, scale, splits)
    got = (dq, delta, dk, dv)
    for name, g, w in zip(("dq", "delta", "dk", "dv"), got, (want_dq, want_delta, want_dk, want_dv)):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert (g - w).abs().max().item() <= _grad_tol(w, torch.float32), (name, tuple(q.shape), k.shape[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("sq,sk,d", EDIT_K23_SHAPES, ids=lambda x: str(x))
def test_fp32_k2_k3_at_the_edit_shapes(gen, sq, sk, d):
    """fp32 K2 and K3 at every shape of a null-text inner step (the splits
    their rules pick: 3 at 1024², 16 query splits at 4096x77 in K3), against
    the plain versions within the fp32 bound; repeats bit-equal; no plain
    version on the card."""
    q, k, v, o, lse, do = _padded_fp32_inputs(gen, 1, sq, sk, 8, d)
    before = (fa.bwd_dq_reference.cuda_calls, fa.bwd_dkv_reference.cuda_calls)
    launches = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, d**-0.5)
    fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, d**-0.5)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_reference.cuda_calls, fa.bwd_dkv_reference.cuda_calls) == before
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == tuple(x + 1 for x in launches)
    _check_fp32_k2_k3(q, k, v, o, lse, do, d**-0.5)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(65, 77), (77, 65), (1, 300), (300, 1), (129, 4097)])
def test_fp32_k2_k3_on_ragged_lengths(gen, d, sq, sk):
    """fp32 K2/K3 with Sq and Sk off their 64-row blocks and 64/16-row tiles
    (cp.async zero-fills rows past the end; keys and q rows past it get P =
    0), with large logits (q x 3: a peaked softmax)."""
    b, h = 2, 3
    q = _rand(gen, (b, sq, h, d), torch.float32, scale=3.0)
    do = _rand(gen, (b, sq, h, d), torch.float32)
    k, v = (_rand(gen, (b, sk, h, d), torch.float32) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    _check_fp32_k2_k3(q, k, v, o, lse, do, d**-0.5)


@pytest.mark.parametrize("shape", [(1, 1024, 1024, 8, 64), (1, 1024, 77, 8, 128), (2, 300, 129, 3, 128),
                                   (1, 65, 4097, 2, 64)])
def test_fp32_k2_k3_forced_splits_are_right_and_deterministic(gen, shape):
    """fp32 K2's key split and K3's query split forced to 1, 2 and 64
    (empty splits included) against the plain versions over the same
    splits; repeats bit-equal; δ the same bits at every split count."""
    q, k, v, o, lse, do = _bwd_inputs(gen, shape, torch.float32)
    scale = shape[-1] ** -0.5
    deltas = [_check_fp32_k2_k3(q, k, v, o, lse, do, scale, splits, splits)[1] for splits in (1, 2, fa.MAX_SPLITS)]
    assert all(torch.equal(deltas[0], x) for x in deltas[1:])


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_k2_k3_take_head_slices_strided_do_and_unaligned_views(gen, d):
    """fp32 q, k, v, o and dO as head slices of wider tensors (autograd's
    strided dO among them) and as views off 16 bytes (copied once by the
    wrapper): the contiguous copies' bits, one launch each."""
    b, sq, sk, h = 2, 200, 77, 3
    for make in (lambda s: _rand(gen, (b, s, 2 * h, d), torch.float32)[:, :, 1::2],
                 lambda s: _rand(gen, (b, s, h, d + 4), torch.float32)[..., 1:d + 1]):
        q, k, v, do, o = make(sq), make(sk), make(sk), make(sq), make(sq)
        out, lse = fa.flash_attention_fwd(q, k, v)
        o.copy_(out)
        assert not (q.is_contiguous() or o.is_contiguous() or do.is_contiguous())
        before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
        got = _check_fp32_k2_k3(q, k, v, o, lse, do, d**-0.5)
        assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == tuple(
            x + 2 for x in before)
        c = [x.contiguous() for x in (q, k, v, o, do)]
        dq, delta = fa.flash_attention_bwd_dq(*c[:4], lse, c[4], d**-0.5)
        want = (dq, delta, *fa.flash_attention_bwd_dkv(*c[:3], lse, delta, c[4], d**-0.5))
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_fp32_k2_k3_run_the_tf32_kernels(gen):
    """By name: fp32 K2 is flash_bwd_dq_tf32_kernel and K3
    flash_bwd_dkv_tf32_kernel, with their merges when split; no SIMT
    backward kernel exists any more."""
    q, k, v, o, lse, do = _padded_fp32_inputs(gen, 1, 4096, 77, 8, 40)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, 40**-0.5)
    names = _kernel_names(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, 40**-0.5))
    assert any("flash_bwd_dq_tf32_kernel" in n for n in names), names
    names = _kernel_names(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, 40**-0.5))
    assert any("flash_bwd_dkv_tf32_kernel" in n for n in names), names
    assert any("flash_dkv_merge_kernel" in n for n in names), names  # 16 query splits at 4096x77
    assert not any("_tc_" in n for n in names), names


def _check_k4a(q, k, v, splits=None):
    """K4a against its plain version cut into the same key ranges; returns (O, lse)."""
    out, lse = kg.flash_attention_kgrid_fwd(q, k, v, splits=splits)
    torch.cuda.synchronize()
    d = q.shape[-1]
    ref, ref_lse = kg.flash_attention_kgrid_reference(q.float(), k.float(), v.float(), d**-0.5, splits=splits,
                                                      cut_as=q.dtype)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = 1e-4 if q.dtype == torch.float32 else _fwd_tol(ref)
    assert (out.float() - ref).abs().max().item() <= tol, (tuple(q.shape), k.shape[1], splits)
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * max(1.0, ref_lse.abs().max().item())
    return out, lse


@pytest.mark.parametrize("d", [64, 192, 320, 512])
@pytest.mark.parametrize("s", [1, 63, 65, 77, 129, 4097])
def test_tensor_core_k4a_on_ragged_lengths(gen, d, s):
    """bf16 K4a with Sq and Sk around its 64-row q tiles and 32/64-key tiles
    (TMA zero-fills the box past the end; keys past Sk are masked before the
    max) at one and at two consumer warpgroups, with the split the rule
    picks."""
    for sq, sk in ((s, s), (s, 77), (77, s)):
        q = _rand(gen, (2, sq, 2, d), torch.bfloat16, scale=3.0)  # large logits: the online max must hold
        k, v = (_rand(gen, (2, sk, 2, d), torch.bfloat16) for _ in range(2))
        _check_k4a(q, k, v)


@pytest.mark.parametrize("d", [64, 192, 320, 512])
def test_tensor_core_k4a_forced_splits_are_right_and_deterministic(gen, d):
    """K4a bf16 with the key range split 1, 2 and 64 ways (empty splits
    included) against the plain version over the same 64-key units; a
    repeated call gives the same bits."""
    q = _rand(gen, (1, 1000, 2, d), torch.bfloat16, scale=3.0)
    k, v = (_rand(gen, (1, 4100, 2, d), torch.bfloat16) for _ in range(2))
    for splits in (1, 2, fa.MAX_SPLITS):
        out, lse = _check_k4a(q, k, v, splits)
        again = kg.flash_attention_kgrid_fwd(q, k, v, splits=splits)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("d", [192, 512])
def test_tensor_core_k4a_takes_head_slices_and_unaligned_views(gen, d):
    """q, k, v as head slices of wider tensors (the TMA maps read their
    strides) and as views off 16 bytes (copied once by the wrapper): the
    contiguous copies' bits, one K4a launch each."""
    b, s, h = 2, 300, 2
    wide = [_rand(gen, (b, s, 2 * h, d), torch.bfloat16)[:, :, 1::2] for _ in range(3)]
    odd = [_rand(gen, (b, s, h, d + 8), torch.bfloat16)[..., 1:d + 1] for _ in range(3)]
    for q, k, v in (wide, odd):
        assert not q.is_contiguous()
        before = kg.flash_attention_kgrid_fwd.launches
        out, lse = _check_k4a(q, k, v)
        out_c, lse_c = kg.flash_attention_kgrid_fwd(q.contiguous(), k.contiguous(), v.contiguous())
        assert kg.flash_attention_kgrid_fwd.launches == before + 2
        assert torch.equal(out, out_c) and torch.equal(lse, lse_c)


# --- fp32 K1 and K4a on the tensor cores (3xTF32 mma.sync; K1 splits its operands once per
# block, in K4a each warp splits the operands it reads)

# null-text inversion editing (SD1.5 at 512px, fp32, rows 1, 8 heads): every
# forward of an inner step, (Sq, Sk, unpadded head dim); d 40/80 run K1 at
# 64/128, d 160 K4a at 192
EDIT_FWD_SHAPES = EDIT_K23_SHAPES + [(256, 256, 160), (256, 77, 160), (64, 64, 160), (64, 77, 160)]


def _fp32_fwd(q, k, v, splits=None, scale=None):
    """fp32 K1 (d <= 128) or K4a against its plain version (K4a's cut into
    the same key ranges), O and lse each within 1e-4·max(1, |ref|); a
    repeated call gives the same bits. Returns (O, lse)."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    if d <= 128:
        got = fa.flash_attention_fwd(q, k, v, scale, splits=splits)
        again = fa.flash_attention_fwd(q, k, v, scale, splits=splits)
        want = fa.flash_attention_reference(q, k, v, scale)
    else:
        got = kg.flash_attention_kgrid_fwd(q, k, v, scale, splits=splits)
        again = kg.flash_attention_kgrid_fwd(q, k, v, scale, splits=splits)
        want = kg.flash_attention_kgrid_reference(q, k, v, scale, splits=splits)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "lse"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        tol = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol, (name, tuple(q.shape), k.shape[1], splits)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("sq,sk,d", EDIT_FWD_SHAPES, ids=lambda x: str(x))
def test_fp32_k1_k4a_at_the_edit_shapes(gen, sq, sk, d):
    """fp32 K1 and K4a at every forward shape of a null-text inner step, on
    inputs zero-padded as ops/attention.py pads them, with the splits their
    rules pick (K1 5 at 1024², K4a 2 at 256²): one launch, no plain version
    on the card, within the fp32 bound."""
    pad = -d % 64
    q, k, v = (torch.nn.functional.pad(_rand(gen, (1, s, 8, d), torch.float32), (0, pad)) for s in (sq, sk, sk))
    wrapper = fa.flash_attention_fwd if d + pad <= 128 else kg.flash_attention_kgrid_fwd
    plain = (fa.flash_attention_reference.cuda_calls, kg.flash_attention_kgrid_reference.cuda_calls)
    before = wrapper.launches
    wrapper(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert (fa.flash_attention_reference.cuda_calls, kg.flash_attention_kgrid_reference.cuda_calls) == plain
    _fp32_fwd(q, k, v, scale=d**-0.5)


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_k1_on_ragged_lengths_with_forced_splits(gen, d):
    """fp32 K1 with Sq and Sk off its 128-row q tiles and 16-key tiles, one
    query and one key, large logits (q x 3: a peaked softmax), the key range
    split 1, 2 and 64 ways (empty splits included)."""
    for sq, sk in ((65, 77), (65, 129), (1, 300), (300, 1), (1, 1), (129, 4097)):
        q = _rand(gen, (2, sq, 3, d), torch.float32, scale=3.0)
        k, v = (_rand(gen, (2, sk, 3, d), torch.float32) for _ in range(2))
        for splits in (1, 2, fa.MAX_SPLITS):
            _fp32_fwd(q, k, v, splits)


@pytest.mark.parametrize("d", kg.KGRID_HEAD_DIMS)
def test_fp32_k4a_at_every_head_dim_ragged_with_forced_splits(gen, d):
    """fp32 K4a at every head dim it is built for (one, two and four warps a
    slab; 32-, 16- and 8-key tiles) with Sq and Sk off its tiles, one query
    and one key, large logits, the key range split 1, 2 and 64 ways."""
    for sq, sk in ((65, 77), (65, 129), (1, 300), (300, 1), (1, 1)):
        q = _rand(gen, (2, sq, 2, d), torch.float32, scale=3.0)
        k, v = (_rand(gen, (2, sk, 2, d), torch.float32) for _ in range(2))
        for splits in (1, 2, fa.MAX_SPLITS):
            _fp32_fwd(q, k, v, splits)


@pytest.mark.parametrize("d", [64, 128, 192, 512])
def test_fp32_k1_k4a_take_head_slices_and_unaligned_views(gen, d):
    """fp32 q, k, v as head slices of wider tensors (read with their
    strides) and as views off 16 bytes (copied once by the wrapper): the
    contiguous copies' bits, one launch each."""
    wrapper = fa.flash_attention_fwd if d <= 128 else kg.flash_attention_kgrid_fwd
    b, h = 2, 2
    for make in (lambda s: _rand(gen, (b, s, 2 * h, d), torch.float32)[:, :, 1::2],
                 lambda s: _rand(gen, (b, s, h, d + 4), torch.float32)[..., 1:d + 1]):
        q, k, v = make(200), make(77), make(77)
        assert not q.is_contiguous()
        before = wrapper.launches
        got = _fp32_fwd(q, k, v)
        assert wrapper.launches == before + 2  # the check's call and its repeat
        want = wrapper(q.contiguous(), k.contiguous(), v.contiguous())
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_fp32_k1_k4a_run_the_tf32_kernels(gen):
    """By name: fp32 K1 is flash_fwd_tf32_kernel (with flash_fwd_merge_kernel
    when split: 5 splits at 1024² with 8 heads) and fp32 K4a
    kgrid_fwd_tf32_kernel (with kgrid_merge_kernel: 3 splits at 4096², one
    head); no tensor-core bf16 kernel runs and no SIMT forward exists any
    more."""
    x = _rand(gen, (1, 1024, 8, 128), torch.float32)
    names = _kernel_names(lambda: fa.flash_attention_fwd(x, x, x))
    assert any("flash_fwd_tf32_kernel" in n for n in names), names
    assert any("flash_fwd_merge_kernel" in n for n in names), names
    assert not any("_tc_" in n for n in names), names
    y = _rand(gen, (1, 4096, 1, 512), torch.float32)
    names = _kernel_names(lambda: kg.flash_attention_kgrid_fwd(y, y, y))
    assert any("kgrid_fwd_tf32_kernel" in n for n in names), names
    assert any("kgrid_merge_kernel" in n for n in names), names
    assert not any("_tc_" in n for n in names), names


def test_bf16_k1_refuses_a_forced_split(gen):
    """The bf16 K1 kernel does not split its key range: a forced count above
    1 raises before any launch."""
    q = _rand(gen, (1, 64, 2, 64), torch.bfloat16)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q, splits=2)
    fa.flash_attention_fwd(q, q, q, splits=1)
    assert fa.flash_attention_fwd.launches == before + 1


# --- the tensor-core kernels K4b and K4c (mma.sync, cp.async) on bf16


def _check_k4b_k4c(q, k, v, o, lse, do, splits=None, dq_splits=None, scale=None):
    """K4b and K4c against their plain versions over the same key and query
    ranges (None: the rules' for q's dtype), δ within the fp32 bound.
    Returns (dQ, δ, dK, dV)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale, splits=dq_splits)
    dk, dv = kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, o, do)]
    wdq, wdelta = kg.kgrid_bwd_dq_reference(*f[:4], lse, f[4], scale, dq_splits, cut_as=q.dtype)
    wdk, wdv = kg.kgrid_bwd_dkv_reference(*f[:3], lse, wdelta, f[4], scale, splits, cut_as=q.dtype)
    assert (delta - wdelta).abs().max().item() <= 1e-4 * max(1.0, wdelta.abs().max().item())
    for name, g, w, x in zip(("dq", "dk", "dv"), (dq, dk, dv), (wdq, wdk, wdv), (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        err = (g.float() - w).abs().max().item()
        assert err <= _grad_tol(w, q.dtype), (name, err, tuple(q.shape), k.shape[1], splits, dq_splits)
    return dq, delta, dk, dv


@pytest.mark.parametrize("d", [64, 192, 256, 320, 512])
@pytest.mark.parametrize("s", [1, 63, 65, 77, 129])
def test_tensor_core_k4b_k4c_on_ragged_lengths(gen, d, s):
    """bf16 K4b and K4c with Sq and Sk around their 32-row tiles and 64- or
    32-row blocks (cp.async zero-fills rows past the end; keys past Sk and
    query rows past Sq get P = 0), at one, two and four warps per 16-row
    slab, with the splits the rules pick."""
    for sq, sk in ((s, s), (s, 77), (77, s)):
        q, do = (_rand(gen, (2, sq, 2, d), torch.bfloat16) for _ in range(2))
        k, v = (_rand(gen, (2, sk, 2, d), torch.bfloat16) for _ in range(2))
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
        _check_k4b_k4c(q, k, v, o, lse, do)


@pytest.mark.parametrize("shape", [(1, 256, 256, 8, 192), (1, 256, 77, 8, 192), (2, 64, 77, 8, 192),
                                   (1, 300, 129, 2, 512), (2, 100, 70, 3, 64)])
def test_tensor_core_k4b_k4c_forced_splits_match_plain_version(gen, shape):
    """K4b's key range and K4c's query range split 1, 2 and 64 ways (empty
    splits included) against the plain versions over the same 32-row units;
    repeated calls give the same bits (partials summed in split order, no
    atomics) and δ the same bits at every split (split 0 writes it); the
    fp32 kernels take the same forced splits (held at every head dim by the
    fp32 tests below)."""
    b, sq, sk, h, d = shape
    q, do = (_rand(gen, (b, sq, h, d), torch.bfloat16) for _ in range(2))
    k, v = (_rand(gen, (b, sk, h, d), torch.bfloat16) for _ in range(2))
    o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
    deltas = []
    for splits in (1, 2, fa.MAX_SPLITS):
        before = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
        got = _check_k4b_k4c(q, k, v, o, lse, do, splits, splits)
        dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, d**-0.5, splits=splits)
        dk, dv = kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, d**-0.5, splits=splits)
        assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == (
            before[0] + 2, before[1] + 2)
        assert all(torch.equal(a, x) for a, x in zip(got, (dq, delta, dk, dv))), splits
        deltas.append(delta)
    assert all(torch.equal(deltas[0], x) for x in deltas[1:])
    f = [x.float() for x in (q, k, v, o, do)]
    _check_k4b_k4c(*f[:4], lse, f[4], 2, 2)


@pytest.mark.parametrize("d", [192, 512])
def test_tensor_core_k4b_k4c_take_head_slices_and_unaligned_views(gen, d):
    """q, k, v, O and dO as head slices of wider tensors (autograd's strided
    dO among them; cp.async reads their strides) and as views off 16 bytes
    (copied once by the wrappers): the contiguous copies' bits, with one K4b
    and one K4c launch each."""
    b, sq, sk, h = 2, 200, 77, 2
    for make in (lambda s: _rand(gen, (b, s, 2 * h, d), torch.bfloat16)[:, :, 1::2],
                 lambda s: _rand(gen, (b, s, h, d + 8), torch.bfloat16)[..., 1:d + 1]):
        q, k, v, o, do = make(sq), make(sk), make(sk), make(sq), make(sq)
        out, lse = kg.flash_attention_kgrid_fwd(q, k, v)
        o.copy_(out)
        assert not (q.is_contiguous() or o.is_contiguous() or do.is_contiguous())
        before = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
        got = _check_k4b_k4c(q, k, v, o, lse, do)
        dq, delta = kg.flash_attention_kgrid_bwd_dq(*(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous(),
                                                    d**-0.5)
        dk, dv = kg.flash_attention_kgrid_bwd_dkv(q.contiguous(), k.contiguous(), v.contiguous(), lse, delta,
                                                  do.contiguous(), d**-0.5)
        assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == (
            before[0] + 2, before[1] + 2)
        assert all(torch.equal(a, x) for a, x in zip(got, (dq, delta, dk, dv)))


def test_k4b_k4c_route_bf16_and_fp32_to_the_tensor_core_kernels(gen):
    """The kernels that run, by name, at SD1.5's 256² with 8 heads of 192
    (both rules split 2 ways in both dtypes): bf16 K4b is
    kgrid_bwd_dq_tc_kernel and kgrid_dq_merge_kernel, bf16 K4c
    kgrid_bwd_dkv_tc_kernel and kgrid_dkv_merge_kernel; fp32 K4b is
    kgrid_bwd_dq_tf32_kernel and K4c kgrid_bwd_dkv_tf32_kernel, with the same
    merges; no SIMT kernel (kgrid_bwd_dq_kernel, kgrid_bwd_dkv_kernel) runs."""
    for dtype, body in ((torch.bfloat16, "_tc_kernel"), (torch.float32, "_tf32_kernel")):
        q, do = (_rand(gen, (1, 256, 8, 192), dtype) for _ in range(2))
        k, v = (_rand(gen, (1, 256, 8, 192), dtype) for _ in range(2))
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
        dq_names = _kernel_names(lambda: kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, 0.1))
        _, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, 0.1)
        dkv_names = _kernel_names(lambda: kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, 0.1))
        assert kg.pick_k4b_splits(8, 256, 256, 192, dtype) == kg.pick_dkv_splits(8, 256, 256, 192, dtype) == 2
        assert any(f"kgrid_bwd_dq{body}" in n for n in dq_names), dq_names
        assert any("kgrid_dq_merge_kernel" in n for n in dq_names), dq_names
        assert any(f"kgrid_bwd_dkv{body}" in n for n in dkv_names), dkv_names
        assert any("kgrid_dkv_merge_kernel" in n for n in dkv_names), dkv_names
        names = dq_names | dkv_names
        assert not any("kgrid_bwd_dq_kernel" in n or "kgrid_bwd_dkv_kernel" in n for n in names), names


# --- fp32 K4b and K4c on the tensor cores (3xTF32 mma.sync): null-text
# inversion editing's backward at the 1280-channel level


def _check_fp32_k4b_k4c(q, k, v, o, lse, do, splits=None, dq_splits=None, scale=None):
    """fp32 K4b then K4c against their plain versions over the same key and
    query ranges (None: the fp32 rules'), dQ, δ, dK and dV each within
    1e-4·max(1, |ref|); a repeated call gives the same bits. Returns (dQ, δ,
    dK, dV)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    got = _check_k4b_k4c(q, k, v, o, lse, do, splits, dq_splits, scale)
    dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale, splits=dq_splits)
    again = (dq, delta, *kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 77), (64, 64), (64, 77)])
def test_fp32_k4b_k4c_at_the_edit_shapes(gen, sq, sk):
    """fp32 K4b and K4c at every 1280-channel shape of a null-text inner step
    (8 heads of 160 zero-padded to 192, K4a's O and lse; the splits their
    rules pick: 2 and 2 at 256²), within the fp32 bound; repeats bit-equal;
    one launch each and no plain version on the card."""
    q, do = (torch.nn.functional.pad(_rand(gen, (1, sq, 8, 160), torch.float32), (0, 32)) for _ in range(2))
    k, v = (torch.nn.functional.pad(_rand(gen, (1, sk, 8, 160), torch.float32), (0, 32)) for _ in range(2))
    o, lse = kg.flash_attention_kgrid_fwd(q, k, v, 160**-0.5)
    before = (kg.kgrid_bwd_dq_reference.cuda_calls, kg.kgrid_bwd_dkv_reference.cuda_calls)
    launches = (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches)
    dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, 160**-0.5)
    kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, 160**-0.5)
    torch.cuda.synchronize()
    assert (kg.kgrid_bwd_dq_reference.cuda_calls, kg.kgrid_bwd_dkv_reference.cuda_calls) == before
    assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == tuple(
        x + 1 for x in launches)
    _check_fp32_k4b_k4c(q, k, v, o, lse, do, scale=160**-0.5)


@pytest.mark.parametrize("d", list(kg.KGRID_HEAD_DIMS))
@pytest.mark.parametrize("sq,sk", [(1, 1), (1, 300), (300, 1), (65, 77), (77, 65), (129, 1000)])
def test_fp32_k4b_k4c_on_ragged_lengths(gen, d, sq, sk):
    """fp32 K4b/K4c at every head dim with Sq and Sk down to 1 and off their
    16-row tiles, 32-row split units and 16/32-row blocks (cp.async zero-fills
    rows past the end; keys and q rows past it get P = 0), with large logits
    (q x 3: a peaked softmax, where sums written straight into the
    accumulator by the tensor cores missed the bound)."""
    b, h = 2, 2
    q = _rand(gen, (b, sq, h, d), torch.float32, scale=3.0)
    do = _rand(gen, (b, sq, h, d), torch.float32)
    k, v = (_rand(gen, (b, sk, h, d), torch.float32) for _ in range(2))
    o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
    _check_fp32_k4b_k4c(q, k, v, o, lse, do)


@pytest.mark.parametrize("shape", [(1, 256, 256, 8, 192), (1, 256, 77, 8, 192), (2, 64, 77, 8, 192),
                                   (1, 300, 129, 2, 512), (2, 100, 70, 3, 64), (1, 65, 1000, 2, 320)])
def test_fp32_k4b_k4c_forced_splits_are_right_and_deterministic(gen, shape):
    """fp32 K4b's key split and K4c's query split forced to 1, 2 and 64
    (empty splits included) against the plain versions over the same 32-row
    units; repeats bit-equal; δ the same bits at every split count."""
    q, k, v, o, lse, do = _kgrid_bwd_inputs(gen, shape, torch.float32)
    deltas = [_check_fp32_k4b_k4c(q, k, v, o, lse, do, splits, splits)[1] for splits in (1, 2, fa.MAX_SPLITS)]
    assert all(torch.equal(deltas[0], x) for x in deltas[1:])


@pytest.mark.parametrize("d", list(kg.KGRID_HEAD_DIMS))
def test_fp32_k4b_k4c_take_head_slices_strided_do_and_unaligned_views(gen, d):
    """fp32 q, k, v, O and dO as head slices of wider tensors (autograd's
    strided dO among them) and as views off 16 bytes (copied once by the
    wrappers): the contiguous copies' bits, one launch of each kernel."""
    b, sq, sk, h = 2, 100, 77, 2
    for make in (lambda s: _rand(gen, (b, s, 2 * h, d), torch.float32)[:, :, 1::2],
                 lambda s: _rand(gen, (b, s, h, d + 4), torch.float32)[..., 1:d + 1]):
        q, k, v, o, do = make(sq), make(sk), make(sk), make(sq), make(sq)
        out, lse = kg.flash_attention_kgrid_fwd(q, k, v)
        o.copy_(out)
        assert not (q.is_contiguous() or o.is_contiguous() or do.is_contiguous())
        before = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
        got = _check_k4b_k4c(q, k, v, o, lse, do)
        assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == (
            before[0] + 1, before[1] + 1)
        c = [x.contiguous() for x in (q, k, v, o, do)]
        dq, delta = kg.flash_attention_kgrid_bwd_dq(*c[:4], lse, c[4], d**-0.5)
        want = (dq, delta, *kg.flash_attention_kgrid_bwd_dkv(*c[:3], lse, delta, c[4], d**-0.5))
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def _tiny_xl_unet_and_stack(device):
    """The tiny-xl UNet (seeded) and two noxattn sliders of ranks 1 and 4,
    stacked; the same weights and factors on every device."""
    from sliders_conceptmod_tpu_torch.adapters import lora
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    unet = factory.build_module(lambda: UNet2DConditionModel(UNetConfig.tiny_xl()), "cpu", torch.float32, seed=0)
    targets = lora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + lora.UNET_TARGET_REPLACE_MODULE_CONV
    g = torch.Generator().manual_seed(1)
    entries = []
    for rank, alpha in ((1, 4.0), (4, 1.0)):
        sites = lora.create_sites(unet, rank=rank, alpha=alpha, target_replace=targets, train_method="noxattn")
        lp = lora.init_lora_params(sites, generator=g)
        for leaf in lp.values():
            leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.3
        entries.append((sites, {n: {k: t.to(device) for k, t in leaf.items()} for n, leaf in lp.items()}))
    sites, stacked = lora.stack_adapters(entries, pad_to=4)
    return unet.to(device).eval(), lora.LoRAOverlay(unet.to(device), sites, stacked)


def test_indexed_overlay_on_the_card_matches_the_cpu(gen):
    """Three rows routed to two stacked adapters and a pad adapter: the card's
    fp32 UNet forward (K1 in its attentions) against the CPU's plain one."""
    g = torch.Generator().manual_seed(2)
    x, ctx = torch.randn((3, 4, 16, 16), generator=g), torch.randn((3, 77, 32), generator=g)
    added = {"text_embeds": torch.randn((3, 32), generator=g), "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 3)}
    t, scales, idx = torch.tensor([100.0, 500.0, 900.0]), torch.tensor([1.5, -2.0, 1.0]), torch.tensor([0, 1, 3])
    out = {}
    for device in ("cpu", "cuda"):
        unet, overlay = _tiny_xl_unet_and_stack(device)
        with torch.inference_mode(), torch.backends.cudnn.flags(allow_tf32=False), \
                overlay(scales.to(device), idx.to(device)):
            out[device] = unet(x.to(device), t.to(device), ctx.to(device),
                               added_cond_kwargs={k: v.to(device) for k, v in added.items()}).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=2e-4, rtol=0)


def test_merged_two_tower_encode_on_the_card_matches_the_cpu(gen, tmp_path):
    """A ``lora_te1`` + ``lora_te2`` slider over tiny-xl's towers, merged at
    −2 and 1.5: the card's fp32 embeddings and pooled outputs against the CPU's."""
    import copy
    import dataclasses

    from sliders_conceptmod_tpu_torch.adapters import lora, slider_file
    from sliders_conceptmod_tpu_torch.models import factory

    _, towers, _, _ = factory.load_models_xl("tiny-xl", device="cpu")
    g = torch.Generator().manual_seed(3)
    sd = {}
    for i, te in enumerate(towers):
        sites = lora.create_sites(te.model, rank=2, alpha=1.0, target_replace=["CLIPAttention"],
                                  prefix=f"lora_te{i + 1}", train_method="full",
                                  name_path_prefix=slider_file.CLIP_NAME_PATH_PREFIX)
        lp = lora.init_lora_params(sites, generator=g)
        for leaf in lp.values():
            leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.3
        sd.update(lora.state_dict_tensors(sites, lp))
    path = str(tmp_path / "te.safetensors")
    lora.write_state_dict(path, sd)
    out = {}
    for device in ("cpu", "cuda"):  # the CPU's seeded towers, copied to the card
        tes = [dataclasses.replace(te, model=copy.deepcopy(te.model).to(device)) for te in towers]
        parts = slider_file.load_slider_file(path, [te.model for te in tes])
        for scale in (-2.0, 1.5):
            with parts.merged_text_encoders(scale), torch.inference_mode():
                out[device, scale] = [t.cpu() for t in factory.encode_prompts_xl(tes, ["a photo of a person", ""])]
    for scale in (-2.0, 1.5):
        for got, want in zip(out["cuda", scale], out["cpu", scale]):
            torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_prodigy_step_on_the_card_matches_the_cpu(gen):
    """Three Prodigy steps (device-scalar d-estimates, a norm and a value
    clip) on the card against the CPU, fp32."""
    from sliders_conceptmod_tpu_torch.train import optim

    g = torch.Generator().manual_seed(4)
    init = [torch.randn(s, generator=g) for s in ((64, 320), (320, 64), (7,))]
    grads = [[torch.randn(p.shape, generator=g) * sc for p in init] for sc in (0.1, 2.0, 0.5)]
    out = {}
    for device in ("cpu", "cuda"):
        opt = optim.get_optimizer("prodigy", optim.get_lr_schedule("cosine_with_restarts", 1.0, 30),
                                  "use_bias_correction=true d0=0.01", grad_clip_norm=1.0, grad_clip_value=0.05)
        params = [p.clone().to(device) for p in init]
        state = opt.init(params)
        for gs in grads:
            opt.step(params, [x.to(device) for x in gs], state)
        assert state["d"].device.type == device
        out[device] = ([p.cpu() for p in params], float(state["d"]))
    for got, want in zip(*(out[d][0] for d in ("cuda", "cpu"))):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * out["cpu"][1]


def _tiny_xl_esd(device, knobs, int8=False):
    """A tiny-xl ESD step (seeded weights, factors with non-zero ups) on
    ``device`` with ESD knobs, its state and the prompt bank; ``int8``: every
    Linear int8, quantized on ``device``."""
    import copy

    from sliders_conceptmod_tpu_torch.adapters import lora, quant
    from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings
    from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.train import esd, optim

    _, tes, unet, sched = factory.load_models_xl("tiny-xl", device="cpu")
    settings = [PromptSettings.from_dict(dict(target="person", positive="person, smiling", neutral="person",
                                              unconditional="person", action="enhance", resolution=64))]
    bank = esd.build_prompt_bank(settings, lambda p: tuple(t[0] for t in factory.encode_prompts_xl(tes, [p])))
    bank = esd.PromptBank(bank.text.to(device), bank.guidance, bank.sign, bank.pooled.to(device))
    sites = lora.create_sites(unet, rank=2, train_method="full")
    g = torch.Generator().manual_seed(5)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    lp = {n: {k: t.to(device).requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
    opt = optim.get_optimizer("adamw", optim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    unet = copy.deepcopy(unet).to(device)
    if int8:
        quant.quantize_module(unet, min_elems=1)
    step = esd.make_esd_train_step(unet, sites, lp, sched, sched.set_timesteps(3), opt,
                                   esd.ESDConfig(max_denoising_steps=3, height=64, width=64, **knobs),
                                   add_time_ids=torch.from_numpy(get_add_time_ids(64, 64)).to(device))
    return step, opt.init(optim.flat_params(sites, lp)), bank, lp, sched.set_timesteps(3)


def test_fused_two_sample_step_on_the_card_matches_the_cpu(gen):
    """samples_per_step 2 on the row axis (with dynamic crops): the card's
    fp32 step (K1/K2/K3 inside) against the CPU's on the same draws."""
    from sliders_conceptmod_tpu_torch.train import esd

    g = torch.Generator().manual_seed(6)
    draws = esd.FusedDraws([0, 0], [2, 1], torch.randn((2, 4, 8, 8), generator=g) * 14.6,
                           torch.randn((2, 2, 4, 8, 8), generator=g),
                           torch.from_numpy(esd.draw_time_ids(0.3, 0.6, 0.1, 64, 64).repeat(2, 0)))
    out = {}
    for device in ("cpu", "cuda"):
        step, state, bank, lp, _ = _tiny_xl_esd(device, dict(samples_per_step=2, dynamic_crops=True))
        d = esd.FusedDraws(draws.pairs, draws.timesteps_to, draws.latents0.to(device), draws.warm_noise.to(device),
                           draws.time_ids.to(device))
        with torch.backends.cudnn.flags(allow_tf32=False):
            m = step(state, bank, draws=d)
        out[device] = (float(m["loss"]), [t.detach().cpu() for leaf in lp.values() for t in leaf.values()])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-3 * max(1.0, abs(out["cpu"][0]))
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def test_notrigger_step_on_the_card_matches_the_cpu(gen):
    """Two notrigger steps (both signs, DoRA, tower 1) on the card against the
    CPU, fp32: metrics and factors."""
    import copy

    import numpy as np

    from sliders_conceptmod_tpu_torch.adapters import dora
    from sliders_conceptmod_tpu_torch.adapters.slider_file import CLIP_NAME_PATH_PREFIX
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.train import notrigger as nt
    from sliders_conceptmod_tpu_torch.train import optim

    _, towers, _, _ = factory.load_models_xl("tiny-xl", device="cpu", with_unet=False)
    te = towers[1]
    ids = {p: torch.from_numpy(te.tokenizer([p]).astype(np.int64)) for p in ("", "smiling", "frowning")}
    out = {}
    for device in ("cpu", "cuda"):
        enc = copy.deepcopy(te.model).to(device)
        sites = dora.create_sites(enc, rank=2, target_replace=nt.CLIP_TARGET_REPLACE, prefix="lora_te2",
                                  train_method="full", name_path_prefix=CLIP_NAME_PATH_PREFIX)
        lp = dora.init_lora_params(sites, enc, generator=torch.Generator().manual_seed(7))
        for leaf in lp.values():
            leaf["up"] = leaf["up"] + 0.1
        lp = {n: {k: t.to(device).requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        x = {p: v.to(device) for p, v in ids.items()}
        with torch.no_grad():
            pos, neg, neu = (enc(x[p]).hidden_states[-1] for p in ("smiling", "frowning", ""))
        opt = optim.get_optimizer("sgd", optim.get_lr_schedule("constant_with_warmup", 10.0, 10), grad_clip_value=1.0)
        d1, d2 = nt.initial_distances(enc, sites, lp, x[""], pos, neg, merge_fn=dora.merge_lora_params)
        step = nt.make_notrigger_step(enc, sites, lp, opt, nt.NoTriggerConfig(), x[""], pos, neg, neu, d1, d2,
                                      merge_fn=dora.merge_lora_params)
        state = opt.init(optim.flat_params(sites, lp))
        ms = [{k: float(v) for k, v in step(state).items()} for _ in range(2)]
        out[device] = (ms, [t.detach().cpu() for leaf in lp.values() for t in leaf.values()])
    for mg, mw in zip(out["cuda"][0], out["cpu"][0]):
        for k in mw:
            assert abs(mg[k] - mw[k]) <= 2e-4 * max(1.0, abs(mw[k])), k
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# the int8 frozen base (adapters/quant.py) on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 320, 1280), (16, 64, 40), (17, 64, 40), (2, 77, 2048, 640), (8192, 640, 640)])
def test_int8_matmul_on_the_card_is_the_cpu_product(gen, shape):
    """``torch._int_mm`` on CUDA needs more than 16 rows: fewer are padded
    with zero rows and dropped again; the product is exact."""
    from sliders_conceptmod_tpu_torch.adapters import quant

    *lead, k, n = shape
    xq = torch.randint(-127, 128, (*lead, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    got = quant.int8_matmul(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (*lead, n)
    assert torch.equal(got.cpu(), quant.int8_matmul(xq.cpu(), wq.cpu()))


@pytest.mark.parametrize("act_quant", [False, True], ids=["weight_only", "w8a8"])
def test_quant_linear_on_the_card_matches_the_cpu(gen, act_quant):
    """fp32: the weight's codes and scales and the activation codes
    bit-equal (quantized on each device), the output and the input's
    gradient (weight-only) within 1e-5."""
    from sliders_conceptmod_tpu_torch.adapters import quant

    lin = torch.nn.Linear(640, 1280).requires_grad_(False)
    x = torch.randn((2, 33, 640), generator=gen, device="cuda")
    out = {}
    for device in ("cpu", "cuda"):
        mod = quant.QuantLinear.from_linear(torch.nn.Linear(640, 1280).to(device).requires_grad_(False),
                                            act_quant=act_quant)
        mod.set_weight(lin.weight.to(device))
        mod.bias.copy_(lin.bias.to(device))
        xi = x.to(device).requires_grad_(not act_quant)
        y = mod(xi)
        if not act_quant:
            (y**2).sum().backward()
        out[device] = (y.detach().cpu(), None if act_quant else xi.grad.cpu(), quant.quantize_activations(xi)[0].cpu(),
                       mod.weight_q.cpu(), mod.scale.cpu())
    assert torch.equal(out["cuda"][3], out["cpu"][3]) and torch.equal(out["cuda"][4], out["cpu"][4])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-5)
    if act_quant:
        assert torch.equal(out["cuda"][2], out["cpu"][2])
    else:
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-4)


def test_int8_esd_step_on_the_card_matches_the_cpu(gen):
    """A tiny-xl ESD step over an int8 base (every Linear int8, quantized on
    each device to the same codes; the student's backward through the
    QuantLinears) on the card against the CPU, fp32: the loss and the
    factors (K1/K2/K3 inside). W8A8 is held at the QuantLinear: its codes
    move where x/sx crosses a rounding midpoint, and the card's fp32 sums
    differ from the CPU's."""
    from sliders_conceptmod_tpu_torch.train import esd

    g = torch.Generator().manual_seed(8)
    draws = esd.Draws(0, 2, torch.randn((1, 4, 8, 8), generator=g) * 14.6, torch.randn((2, 1, 4, 8, 8), generator=g))
    out = {}
    for device in ("cpu", "cuda"):
        step, state, bank, lp, _ = _tiny_xl_esd(device, dict(student_overlay=True, overlay_warmup=True), int8=True)
        d = esd.Draws(draws.pair, draws.timesteps_to, draws.latents0.to(device), draws.warm_noise.to(device))
        with torch.backends.cudnn.flags(allow_tf32=False):
            m = step(state, bank, draws=d)
        out[device] = (float(m["loss"]), [t.detach().cpu() for leaf in lp.values() for t in leaf.values()])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-3 * max(1.0, abs(out["cpu"][0]))
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# SD3: the joint attention's ragged lengths, 24 heads of 64
# ---------------------------------------------------------------------------

SD3_JOINT = [(1357, 1), (1357, 2), (4429, 2)]  # 512px training (1024 + 333), 1024px serving (4096 + 333)


@pytest.mark.parametrize("s,rows", SD3_JOINT)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_at_sd3_joint_lengths(gen, s, rows, dtype):
    """K1 at SD3-Medium's joint sequences (not a multiple of any tile: 4429 =
    69·64 + 13), H 24, d 64, against its plain version."""
    q = _rand(gen, (rows, s, 24, 64), dtype, scale=3.0)
    k, v = (_rand(gen, (rows, s, 24, 64), dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), 64**-0.5)
    tol = 1e-4 if dtype == torch.float32 else _fwd_tol(ref)
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * max(1.0, ref_lse.abs().max().item())


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_at_sd3_training_length(gen, rows, dtype):
    """K2 (with the key split its rule picks at 24 heads) and K3 (its query
    split) at 1357², H 24, d 64, against their plain versions."""
    q, k, v, o, lse, do = _bwd_inputs(gen, (rows, 1357, 1357, 24, 64), dtype)
    scale = 64**-0.5
    if dtype == torch.bfloat16:
        _check_k2(q, k, v, o, lse, do, scale)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w).abs().max().item() <= _grad_tol(w, dtype), name


def _tiny_sd3():
    """The tiny MMDiT with seeded weights, made on the CPU (a CUDA generator
    draws other numbers)."""
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models.mmdit import MMDiTConfig, SD3Transformer2DModel

    return factory.build_module(lambda: SD3Transformer2DModel(MMDiTConfig.tiny()), "cpu", torch.float32, 5)


def test_tiny_mmdit_and_sd3_sampler_on_the_card_match_the_cpu(gen):
    """The tiny MMDiT forward and a 3-step SD3 flow sampler call with the
    slider through the overlay (K1 inside every joint attention), card vs
    CPU, fp32."""
    from sliders_conceptmod_tpu_torch.adapters import lora
    from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from sliders_conceptmod_tpu_torch.infer.generate_flow import sample_flow_loop

    g = torch.Generator().manual_seed(3)
    lat = torch.randn((2, 16, 8, 8), generator=g)
    text = torch.randn((4, 81, 32), generator=g)
    pooled = torch.randn((4, 32), generator=g)
    sched = FlowMatchScheduler().set_timesteps(3)
    out = {}
    cpu_model = _tiny_sd3()
    for device in ("cpu", "cuda"):
        model = cpu_model if device == "cpu" else copy.deepcopy(cpu_model).to(device)
        sites = lora.create_sites(model, rank=2, target_replace=["Attention"], delimiter="-")
        lp = lora.init_lora_params(sites, generator=torch.Generator().manual_seed(1))
        lp = {n: {k: (t + 0.1).to(device) for k, t in leaf.items()} for n, leaf in lp.items()}
        fwd = model(lat[:1].to(device), torch.tensor([500.0], device=device), text[:1].to(device),
                    pooled[:1].to(device))
        final = sample_flow_loop(model, 1, sched, lat.to(device), text.to(device), pooled.to(device),
                                 guidance_scale=7.0, overlay=lora.LoRAOverlay(model, sites, lp),
                                 row_scale=torch.tensor([1.5, -1.0, 1.5, -1.0], device=device))
        out[device] = (fwd.cpu(), final.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=2e-4, rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-3, rtol=0)


@pytest.mark.parametrize("rows", [2, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_k3_at_flux_joint_length(gen, rows, dtype):
    """Flux's joint attention at native d 128 (no padding), H 24, 1536² (512
    T5 + 1024 image tokens): K1 (out and lse), K2 with the key split its
    rule picks and K3 with its query split, against their plain versions, at
    the student's rows 2 and the teacher's 6."""
    q, k, v, o, lse, do = _bwd_inputs(gen, (rows, 1536, 1536, 24, 128), dtype)
    scale = 128**-0.5
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), scale)
    tol = 1e-4 if dtype == torch.float32 else _fwd_tol(ref)
    assert (o.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * max(1.0, ref_lse.abs().max().item())
    del ref, ref_lse
    if dtype == torch.bfloat16:
        _check_k2(q, k, v, o, lse, do, scale)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w).abs().max().item() <= _grad_tol(w, dtype), name


def _tiny_flux():
    """The tiny Flux transformer with seeded weights, made on the CPU."""
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models.flux import FluxConfig, FluxTransformer2DModel

    return factory.build_module(lambda: FluxTransformer2DModel(FluxConfig.tiny()), "cpu", torch.float32, 5)


def _flux_lora(model, device):
    from sliders_conceptmod_tpu_torch.adapters import lora

    sites = lora.create_sites(model, rank=2, target_replace=["Attention"], delimiter="-")
    lp = lora.init_lora_params(sites, generator=torch.Generator().manual_seed(1))
    return sites, {n: {k: (t + 0.1).to(device) for k, t in leaf.items()} for n, leaf in lp.items()}


def test_tiny_flux_and_packed_sampler_on_the_card_match_the_cpu(gen):
    """The tiny Flux forward and a 3-step packed sampler call with the slider
    through the overlay from step 1 (K1 inside every attention), card vs
    CPU, fp32."""
    from sliders_conceptmod_tpu_torch.adapters import lora
    from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from sliders_conceptmod_tpu_torch.infer.generate_flow import sample_packed_flow
    from sliders_conceptmod_tpu_torch.models.flux import prepare_latent_image_ids

    g = torch.Generator().manual_seed(3)
    tokens, text, pooled = (torch.randn(s, generator=g) for s in ((2, 16, 16), (2, 8, 32), (2, 32)))
    ids = torch.from_numpy(prepare_latent_image_ids(4, 4))
    sched = FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(3, mu=0.7)
    out = {}
    cpu_model = _tiny_flux()
    for device in ("cpu", "cuda"):
        model = cpu_model if device == "cpu" else copy.deepcopy(cpu_model).to(device)
        sites, lp = _flux_lora(model, device)
        args = [x.to(device) for x in (tokens, text, pooled)]
        fwd = model(args[0][:1], torch.tensor([0.5], device=device), args[1][:1], args[2][:1],
                    torch.zeros((8, 3), device=device), ids.to(device))
        final = sample_packed_flow(model, 1, sched, *args, ids.to(device), overlay=lora.LoRAOverlay(model, sites, lp),
                                   row_scale=torch.tensor([1.5, -1.0], device=device))
        out[device] = (fwd.cpu(), final.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=2e-4, rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-3, rtol=0)


def test_tiny_flux_esd_step_on_the_card_matches_the_cpu(gen):  # gen: skips without a card, sets TF32 off
    """One tiny Flux ESD micro-step (the overlay student, blocks
    checkpointed; MultiSteps k 1) card vs CPU, fp32: K1 3 and K2/K3 1 per
    attention."""
    from sliders_conceptmod_tpu_torch.adapters import lora
    from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from sliders_conceptmod_tpu_torch.train import esd, esd_flux
    from sliders_conceptmod_tpu_torch.train.optim import MultiSteps, flat_params, get_lr_schedule, get_optimizer

    g = torch.Generator().manual_seed(3)
    text, pooled, lat = torch.randn((1, 5, 8, 32), generator=g), torch.randn((1, 5, 32), generator=g), \
        torch.randn((2, 4, 16, 16), generator=g)
    cpu_model = _tiny_flux()
    out = {}
    for device in ("cpu", "cuda"):
        model = cpu_model if device == "cpu" else copy.deepcopy(cpu_model).to(device)
        sites, lp = _flux_lora(model, device)
        for leaf in lp.values():
            for t in leaf.values():
                t.requires_grad_(True)
        opt = MultiSteps(get_optimizer("adamw", get_lr_schedule("cosine", 1e-3, 50, 1e-6), weight_decay=1e-6,
                                       grad_clip_value=1.0), 1)
        cfg = esd_flux.FluxESDConfig(batch_size=2, height=32, width=32, latent_channels=4, vae_scale=2, remat=True,
                                     student_overlay=True)
        step = esd_flux.make_flux_esd_train_step(
            model, sites, lp, FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(8, mu=0.6), opt, cfg)
        before = fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches
        m = step(opt.init(flat_params(sites, lp)), esd.PromptBank(text.to(device), [3.0], [1.0], pooled.to(device)),
                 draws=[esd_flux.Draw(0, lat.to(device))])
        launches = (fa.flash_attention_fwd.launches - before[0], fa.flash_attention_bwd_dq.launches - before[1])
        out[device] = (float(m["loss"]), lora.state_dict_numpy(sites, lp), launches)
    assert out["cuda"][2] == (3 * 4, 4)  # 4 attentions per forward: teacher, student, recompute; one backward
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-3 * max(1.0, abs(out["cpu"][0]))
    for k, v in out["cpu"][1].items():
        assert abs(out["cuda"][1][k] - v).max() <= 1e-3, k


# ---------------------------------------------------------------------------
# Stable Cascade: the prior's attentions at 512px, 32 heads of 64
# ---------------------------------------------------------------------------

# (Sq, Sk): level 0 of the 12 × 12 effnet grid (144 image tokens + 77 text +
# 4 pooled + 4 image slots as keys) and level 1 after the stride-2 conv
CASCADE_ATTENTION = [(144, 229), (36, 121)]


@pytest.mark.parametrize("sq,sk", CASCADE_ATTENTION)
@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_at_cascade_lengths(gen, sq, sk, rows, dtype):
    """K1 where both lengths are ragged and Sq ≠ Sk at small sizes (36
    queries: under one tile and not a multiple of 16; 144: a last tile of 16
    rows), H 32, d 64, against its plain version, at the CFG pair's rows 2
    and the teacher's 4."""
    q = _rand(gen, (rows, sq, 32, 64), dtype, scale=3.0)
    k, v = (_rand(gen, (rows, sk, 32, 64), dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), 64**-0.5)
    tol = 1e-4 if dtype == torch.float32 else _fwd_tol(ref)
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * max(1.0, ref_lse.abs().max().item())


@pytest.mark.parametrize("sq,sk", CASCADE_ATTENTION)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_at_cascade_lengths(gen, sq, sk, dtype):
    """K2 and K3 at the student's rows 2, with the splits their rules pick
    (1 at these sizes), against their plain versions."""
    q, k, v, o, lse, do = _bwd_inputs(gen, (2, sq, sk, 32, 64), dtype)
    scale = 64**-0.5
    assert fa.pick_k2_splits(64, sq, sk, dtype) == fa.pick_k3_splits(64, sq, sk, dtype) == 1
    if dtype == torch.bfloat16:
        _check_k2(q, k, v, o, lse, do, scale)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g.float() - w).abs().max().item() <= _grad_tol(w, dtype), name


def test_tiny_cascade_prior_and_esd_step_on_the_card_match_the_cpu(gen):  # gen: skips without a card, sets TF32 off
    """The tiny Stable Cascade prior on the odd 5 × 5 grid and one ESD step
    (the merged student, layers checkpointed, euler_a T 3), card vs CPU,
    fp32; K1 4 per forward, K2 4 per step."""
    from sliders_conceptmod_tpu_torch.adapters import lora
    from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models.cascade import CascadeConfig, StableCascadeUNet
    from sliders_conceptmod_tpu_torch.train import esd, esd_cascade
    from sliders_conceptmod_tpu_torch.train.optim import flat_params, get_lr_schedule, get_optimizer

    torch.backends.cudnn.allow_tf32 = False
    cpu_model = factory.build_module(lambda: StableCascadeUNet(CascadeConfig.tiny()), "cpu", torch.float32, 5)
    g = torch.Generator().manual_seed(3)
    args = (torch.randn((2, 16, 5, 5), generator=g), torch.rand(2, generator=g), torch.randn((2, 77, 16), generator=g),
            torch.randn((2, 1, 16), generator=g), torch.randn((2, 1, 16), generator=g))
    bank = (torch.randn((1, 5, 77, 16), generator=g), torch.randn((1, 5, 1, 16), generator=g))
    empty = (torch.randn((77, 16), generator=g), torch.randn((1, 16), generator=g))
    lat, noise = torch.randn((1, 16, 5, 5), generator=g), torch.randn((2, 1, 16, 5, 5), generator=g)
    sched = create_noise_scheduler("euler_a")
    out = {}
    for device in ("cpu", "cuda"):
        model = cpu_model if device == "cpu" else copy.deepcopy(cpu_model).to(device)
        with torch.no_grad():
            fwd = model(*(a.to(device) for a in args)).cpu()
        sites = lora.create_sites(model, rank=2, target_replace=["Attention"])
        lp = lora.init_lora_params(sites, generator=torch.Generator().manual_seed(1))
        lp = {n: {k: (t + 0.05).to(device).requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10))
        step = esd_cascade.make_cascade_esd_train_step(
            model, sites, lp, sched, sched.set_timesteps(3), opt,
            esd_cascade.CascadeESDConfig(max_denoising_steps=3, height=200, width=200, remat=True),
            empty[0].to(device), empty[1].to(device), 16)
        before = fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches
        m = step(opt.init(flat_params(sites, lp)), esd.PromptBank(bank[0].to(device), [4.0], [1.0], bank[1].to(device)),
                 draws=[esd_cascade.Draw(0, lat.to(device), noise.to(device))])
        launches = (fa.flash_attention_fwd.launches - before[0], fa.flash_attention_bwd_dq.launches - before[1])
        out[device] = (fwd, float(m["loss"]), lora.state_dict_numpy(sites, lp), launches)
    assert out["cuda"][3] == (4 * (2 + 3), 4)  # the warm-up's 2 forwards, the teacher, the student, its recompute
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=2e-4, rtol=0)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-3 * max(1.0, abs(out["cpu"][1]))
    for k, v in out["cpu"][2].items():
        assert abs(out["cuda"][2][k] - v).max() <= 1e-3, k


def test_null_optimization_step_and_controllers_on_the_card_match_the_cpu(gen):  # gen: skips without a card
    """One fp32 null-text optimisation step (``infer/null_inversion.py``, 2
    DDIM steps, 2 inner steps) of the tiny SD UNet with a d-160 mid block:
    the embeddings and latents on the card against the CPU (≤ 1e-3); K1 and
    K4a in every forward, K2/K3 and K4b/K4c in every inner backward except
    the first self-attention's, which has no gradient path to the embedding;
    a forward under each controller launches one K1/K4a fewer per attention
    it materialises."""
    import dataclasses

    from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler
    from sliders_conceptmod_tpu_torch.infer import null_inversion as ni
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models import unet as tunet

    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(tunet.UNetConfig.tiny(), block_out_channels=(32, 160), attention_head_dim=1)
    cpu_unet = factory.build_module(lambda: tunet.UNet2DConditionModel(cfg), "cpu", torch.float32, 3)
    assert cfg.attention_calls_by_head_dim() == {32: 6, 160: 2}
    g = torch.Generator().manual_seed(4)
    lat0, cond, uncond = torch.randn(1, 4, 8, 8, generator=g), torch.randn(1, 7, 32, generator=g), \
        0.5 * torch.randn(1, 7, 32, generator=g)
    schedule = create_noise_scheduler("ddim").set_timesteps(2)
    null_cfg = ni.NullOptConfig(num_inner_steps=2, epsilon=-1.0)
    out = {}
    for device in ("cpu", "cuda"):
        unet = cpu_unet if device == "cpu" else copy.deepcopy(cpu_unet).to(device)
        traj = ni.ddim_invert(unet, schedule, lat0.to(device), cond.to(device))
        before = [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                                       kg.flash_attention_kgrid_fwd, kg.flash_attention_kgrid_bwd_dq,
                                       kg.flash_attention_kgrid_bwd_dkv)]
        u, lat = ni.null_optimization(unet, schedule, traj, cond.to(device), uncond.to(device), null_cfg)
        launches = [f.launches - b for f, b in zip(
            (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
             kg.flash_attention_kgrid_fwd, kg.flash_attention_kgrid_bwd_dq, kg.flash_attention_kgrid_bwd_dkv),
            before)]
        out[device] = (traj.cpu(), u.cpu(), lat.cpu(), launches)
    forwards, backwards = 2 * (2 + 2), 2 * 2  # per step: cond, 2 inner, the final guided; 2 inner backwards
    assert out["cuda"][3] == [6 * forwards, 5 * backwards, 5 * backwards, 2 * forwards, 2 * backwards, 2 * backwards]
    assert out["cpu"][3] == [0] * 6
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], atol=1e-3, rtol=1e-3)

    unet = copy.deepcopy(cpu_unet).to("cuda")
    x, ctx = lat0.to("cuda"), cond.to("cuda")
    for ctx_mgr, want in ((tunet.capture_attention_maps, (0, 0)),
                          (lambda: tunet.reweight_cross_attention(torch.ones(7)), (3, 1))):
        before = fa.flash_attention_fwd.launches, kg.flash_attention_kgrid_fwd.launches
        with ctx_mgr(), torch.no_grad():
            got = unet(x, 500, ctx)
        assert (fa.flash_attention_fwd.launches - before[0], kg.flash_attention_kgrid_fwd.launches - before[1]) == want
        with torch.no_grad():
            torch.testing.assert_close(got, unet(x, 500, ctx), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inversion_token_and_kv_patch_on_the_card_match_the_cpu(gen, dtype):  # gen: skips without a card
    """The baselines' weight edits on the card: a textual-inversion token
    grows the tiny tower's table (old rows bit-equal, the row written) and
    the encode agrees with the CPU's; a Custom Diffusion delta (a copy and a
    rank-3 ``u @ v``) patches the tiny SDXL UNet to the CPU's weights."""
    from sliders_conceptmod_tpu_torch.eval import baselines
    from sliders_conceptmod_tpu_torch.models import factory

    emb = torch.randn(32, generator=torch.Generator().manual_seed(1))
    _, te_cpu, _, _ = factory.load_models("tiny", device="cpu", weight_dtype=dtype)
    towers = {}
    for device in ("cpu", "cuda"):
        te = factory.TextEncoderBundle(copy.deepcopy(te_cpu.model).to(device), copy.deepcopy(te_cpu.tokenizer))
        old = te.model.token_embedding.weight.detach().clone()
        assert baselines.add_inversion_token(te, "<sks>", emb) == 49408
        table = te.model.token_embedding.weight
        assert table.shape[0] == te.model.config.vocab_size == 49409 and torch.equal(table[:49408], old)
        with torch.no_grad():
            towers[device] = (table.detach().cpu(), te.encode(["a photo with <sks>"]).last_hidden_state.float().cpu())
    assert torch.equal(towers["cuda"][0], towers["cpu"][0])
    torch.testing.assert_close(towers["cuda"][1], towers["cpu"][1], atol=2e-4 if dtype == torch.float32 else 3e-2,
                               rtol=0)

    _, _, unet_cpu, _ = factory.load_models_xl("tiny-xl", device="cpu", weight_dtype=dtype)
    sd = unet_cpu.state_dict()
    kv = sorted(k for k in sd if "attn2" in k and (".to_k." in k or ".to_v." in k))
    g = torch.Generator().manual_seed(2)
    delta = {kv[0]: sd[kv[0]].float() + 0.5,
             kv[1]: {"u": torch.randn((sd[kv[1]].shape[0], 3), generator=g),
                     "v": torch.randn((3, sd[kv[1]].shape[1]), generator=g)}}
    patched = {}
    for device in ("cpu", "cuda"):
        unet = copy.deepcopy(unet_cpu).to(device)
        baselines.patch_custom_diffusion_kv(unet, delta)
        patched[device] = {k: unet.state_dict()[k].cpu() for k in kv[:2]}
    for k, v in patched["cpu"].items():
        torch.testing.assert_close(patched["cuda"][k].float(), v.float(), rtol=2e-6 if dtype == torch.float32
                                   else 2 ** -8, atol=0)
