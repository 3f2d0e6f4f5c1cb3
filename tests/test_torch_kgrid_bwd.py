"""Kernels K4b (dQ) and K4c (dK/dV) — the k-grid flash-attention backward —
through their plain versions against the JAX package: the k-grid Pallas
backward in interpret mode (``jax.vjp`` of its ``flash_attention``) and the
gradients of its attention dispatch at head dim 160 (SD1.5's 1280-channel
level).

On the CPU the wrappers and the autograd Function take the plain versions;
the CUDA kernels are held against those plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py. Every comparison is fp32, within
1e-5·max(1, max|ref|) of the JAX gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.attention import dot_product_attention as jax_attention
from sliders_conceptmod_tpu.ops.flash_attention_kgrid import flash_attention as jax_kgrid
from sliders_conceptmod_tpu_torch.ops import attention as attn
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REL = 1e-5


def _inputs(shape, seed):
    b, sq, sk, h, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _close(got, want):
    """|got − want| ≤ 1e-5·max(1, max|want|), elementwise maximum."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


# (B, Sq, Sk, H, D): ragged tails on both axes at every head-dim class the
# path has (64; 192 = SD1.5's 160 padded; 512, where 16 threads share a row)
SHAPES = [(1, 70, 100, 2, 64), (2, 45, 77, 2, 192), (1, 40, 33, 1, 512)]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_jax_kgrid_vjp(shape, splits):
    """K4b's and K4c's plain versions (K4c's over ``splits`` query ranges, the
    empty ones included) against the JAX k-grid kernel's custom VJP run in
    interpret mode: dQ, dK, dV; and δ = rowsum(dO∘O)."""
    q, k, v, do = _inputs(shape, seed=shape[-1] + splits)
    scale = shape[-1] ** -0.5
    want = _jax_grads(lambda a, b, c: jax_kgrid(a, b, c, scale=scale, interpret=True), q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = kg.flash_attention_kgrid_fwd(tq, tk, tv, scale)
    dq, delta = kg.flash_attention_kgrid_bwd_dq(tq, tk, tv, o, lse, tdo, scale)
    dk, dv = kg.flash_attention_kgrid_bwd_dkv(tq, tk, tv, lse, delta, tdo, scale, splits=splits)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
        _close(got.numpy(), w)
    b, sq, _, h, _ = shape
    assert tuple(delta.shape) == (b * h, sq)
    _close(delta.numpy(), np.einsum("bqhd,bqhd->bhq", do, o.numpy()).reshape(b * h, sq))


@pytest.mark.parametrize("d", [160, 512])
def test_autograd_through_the_dispatch_matches_jax_attention(d):
    """Head dims 129..512 are differentiable: the port's dispatch (padded to
    a multiple of 64, K4a forward and K4b/K4c backward through
    FlashAttentionKGrid) against the gradients of the JAX dispatch."""
    q, k, v, do = _inputs((2, 37, 77, 2 if d == 160 else 1, d), seed=d)
    want = _jax_grads(lambda a, b, c: jax_attention(a, b, c), q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = kg.kgrid_bwd_dq_reference.cuda_calls, kg.kgrid_bwd_dkv_reference.cuda_calls
    out = attn.dot_product_attention(tq, tk, tv)
    assert out.grad_fn is not None and tuple(out.shape) == q.shape
    out.backward(torch.from_numpy(do))
    for x, w in zip((tq, tk, tv), want):
        _close(x.grad.numpy(), w)
    assert (kg.kgrid_bwd_dq_reference.cuda_calls, kg.kgrid_bwd_dkv_reference.cuda_calls) == before  # CPU: uncounted


def test_autograd_function_saves_k4a_residuals_and_returns_no_lse_gradient():
    q, k, v, do = map(torch.from_numpy, _inputs((1, 33, 40, 2, 256), seed=3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = kg.flash_attention_kgrid_fwd(*leaves, splits=2)
    assert out.requires_grad and not lse.requires_grad
    grads = torch.autograd.grad(out, leaves, do)
    o, lse2 = kg.flash_attention_kgrid_reference(q, k, v, 256**-0.5, splits=2)
    assert torch.equal(lse, lse2) and torch.equal(out.detach(), o)
    want = kg.flash_attention_kgrid_bwd_reference(q, k, v, o, lse2, do, 256**-0.5)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_dkv_splits_sum_the_same_gradients_with_no_nan():
    """Every split count (more splits than q tiles leaves empty ones) gives
    the one-split dK/dV up to summation order, finite; the split choice
    fills the card only when the key-tile grid is small."""
    q, k, v, do = map(torch.from_numpy, _inputs((1, 100, 77, 2, 192), seed=4))
    o, lse = kg.flash_attention_kgrid_reference(q, k, v, 0.1)
    dq, delta = kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, 0.1)
    one = kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, 0.1, splits=1)
    assert kg.split_ranges(100, 6)[4:] == [(100, 100), (100, 100)]
    for splits in (2, 4, 6):
        many = kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, 0.1, splits=splits)
        for a, b in zip(one, many):
            assert torch.isfinite(b).all()
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-5)
    # SD1.5's ESD student at 512px: 8 heads, 256 queries, d 192
    assert kg.bwd_rows_per_block(192) == 32 and kg.bwd_rows_per_block(320) == 16
    assert kg.pick_dkv_splits(8, 256, 77, 192) == 2  # 24 key-tile blocks, 8 q tiles
    assert kg.pick_dkv_splits(8, 256, 256, 192) == 2
    assert kg.pick_dkv_splits(16, 64, 64, 192) == 1  # 2 q tiles: too few to split
    assert kg.pick_dkv_splits(1, 16384, 16384, 64) == 1  # 512 blocks fill the card
    assert kg.pick_dkv_splits(1, 8192, 16, 512) == 64  # one key tile: as many splits as allowed
    assert kg.pick_dkv_splits(1, 4096, 40, 512) == 32  # 3 key tiles of 16 rows: 4 q tiles per split


def test_k4b_k4c_plain_versions_agree_with_k2_k3_at_d64():
    """At head dim 64 the k-grid backward and K2/K3's plain backward are the
    same function of the same inputs."""
    q, k, v, do = map(torch.from_numpy, _inputs((2, 300, 77, 2, 64), seed=5))
    o, lse = fa.flash_attention_reference(q, k, v, 0.125)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, 0.125)
    got = kg.flash_attention_kgrid_bwd(q, k, v, o, lse, do, 0.125, splits=3)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_cpu_backward_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(fa, "build", refuse)
    monkeypatch.setattr(kg, "_library", refuse)
    before = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs((1, 20, 30, 1, 320), seed=6)[:3])
    attn.dot_product_attention(q, k, v).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    assert (kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches) == before
