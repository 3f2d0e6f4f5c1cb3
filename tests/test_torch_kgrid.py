"""Kernel K4a's plain version (the k-grid flash-attention forward, split and
merged over key ranges) and the head-dim dispatch against the JAX package:
its k-grid Pallas kernel in interpret mode and its attention dispatch (the
backward, K4b/K4c, is tests/test_torch_kgrid_bwd.py).

On the CPU the wrapper takes its plain version; the CUDA kernel is held
against that plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.attention import dot_product_attention as jax_attention
from sliders_conceptmod_tpu.ops.flash_attention_kgrid import _flash_fwd_impl as jax_kgrid_fwd
from sliders_conceptmod_tpu_torch.ops import attention as attn
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(shape, seed):
    b, sq, sk, h, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, sk, sk)]


def _jax_out_lse(q, k, v, scale):
    """The JAX k-grid kernel's O and its lane-replicated lse, as [B·H, Sq]."""
    out, residuals = jax_kgrid_fwd(*map(jnp.asarray, (q, k, v)), scale, True)
    return np.asarray(out), np.asarray(residuals[-1])[:, : q.shape[1], 0]


# (B, Sq, Sk, H, D): the JAX test's ragged shape, and a D-512 case with
# ragged tails on both axes (several 32-key tiles)
SHAPES = [(1, 300, 77, 2, 64), (2, 70, 100, 1, 512)]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kgrid_kernel(shape, splits):
    q, k, v = _qkv(shape, seed=shape[-1] + splits)
    scale = shape[-1] ** -0.5
    want_out, want_lse = _jax_out_lse(q, k, v, scale)
    out, lse = kg.flash_attention_kgrid_fwd(*map(torch.from_numpy, (q, k, v)), scale, splits=splits)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (shape[0] * shape[3], shape[1])
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


def test_empty_splits_contribute_exactly_nothing():
    """More splits than key tiles: the trailing splits are empty (m = −1e30,
    l = 0) and the merge gives the one-split result, with no NaN."""
    q, k, v = map(torch.from_numpy, _qkv((1, 40, 77, 2, 128), seed=5))
    ranges = kg.split_ranges(77, 5)
    assert ranges[:3] == [(0, 32), (32, 64), (64, 77)] and ranges[3:] == [(77, 77), (77, 77)]
    one = kg.flash_attention_kgrid_reference(q, k, v, 0.1, splits=1)
    many = kg.flash_attention_kgrid_reference(q, k, v, 0.1, splits=5)
    for a, b in zip(one, many):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def test_split_choice_fills_the_card_only_when_the_grid_is_small():
    # the VAE's path shapes: 512 blocks already fill two waves of 132 SMs
    assert kg.pick_splits(1, 16384, 16384) == 1 and kg.pick_splits(4, 4096, 4096) == 1
    assert kg.pick_splits(1, 4096, 4096) == 3  # 128 blocks → 3 splits of 43 tiles
    assert kg.pick_splits(1, 32, 16384) == 64  # one q tile: as many splits as allowed
    assert kg.pick_splits(4, 300, 77) == 1  # 3 key tiles: too few to split
    for bh, sq, sk in ((1, 4096, 4096), (1, 32, 16384), (2, 64, 1000)):
        n = kg.pick_splits(bh, sq, sk)
        assert all(hi - lo >= 4 * kg.BK for lo, hi in kg.split_ranges(sk, n)[:-1])


@pytest.mark.parametrize("d", [200, 512])
def test_dispatch_above_128_matches_jax_attention(d):
    """Head dims 129..512 go to K4a's wrapper (padded to a multiple of 64),
    and agree with the JAX dispatch (its XLA path on the CPU)."""
    q, k, v = _qkv((2, 130, 90, 1, d), seed=d)
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))))
    before = kg.flash_attention_kgrid_reference.cuda_calls
    got = attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert kg.flash_attention_kgrid_reference.cuda_calls == before  # CPU calls are not counted


def test_dispatch_above_512_on_the_cpu_takes_k1s_plain_version():
    q, k, v = _qkv((1, 40, 30, 1, 576), seed=7)
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(attn.dot_product_attention(*map(torch.from_numpy, (q, k, v))).numpy(), want, **TOL)


def test_bf16_output_and_no_backward():
    """bf16 output with an fp32 lse; the backward (K4b/K4c, ported since this
    test held its refusal) runs where autograd needs it — and only there:
    under no_grad the forward builds no graph."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv((1, 64, 64, 1, 512), seed=8))
    out, lse = kg.flash_attention_kgrid_fwd(q, k, v, splits=2)
    ref, ref_lse = kg.flash_attention_kgrid_reference(q.float(), k.float(), v.float(), 512**-0.5, splits=2)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (out.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), **TOL)
    leaf = q.float().requires_grad_(True)
    out, _ = kg.flash_attention_kgrid_fwd(leaf, k.float(), v.float())
    (grad,) = torch.autograd.grad(out.sum(), leaf)
    want = kg.flash_attention_kgrid_bwd_reference(leaf.detach(), k.float(), v.float(), out.detach(), _,
                                                  torch.ones_like(out), 512**-0.5)[0]
    assert torch.equal(grad, want)
    with torch.no_grad():
        assert kg.flash_attention_kgrid_fwd(leaf, k.float(), v.float())[0].grad_fn is None


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(fa, "build", refuse)
    monkeypatch.setattr(kg, "_library", refuse)
    before = kg.flash_attention_kgrid_fwd.launches
    q, k, v = map(torch.from_numpy, _qkv((1, 33, 40, 1, 256), seed=9))
    kg.flash_attention_kgrid_fwd(q, k, v)
    attn.dot_product_attention(q, k, v)
    assert kg.flash_attention_kgrid_fwd.launches == before


def test_wrapper_rejects_bad_inputs():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 8, 1, 256), seed=10))
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_fwd(q, k[:, :, :, :128], v)
    with pytest.raises(ValueError):
        kg.flash_attention_kgrid_fwd(q, k.double(), v)
