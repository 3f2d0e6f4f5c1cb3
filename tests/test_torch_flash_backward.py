"""The port's flash-attention backward against the JAX package's.

On the CPU the port's autograd Function runs its plain backward
(``flash_attention_bwd_reference``: P recomputed from the forward's lse, K2's
and K3's formulas in fp32); the JAX side is ``jax.vjp`` of the Pallas flash
attention in interpret mode, whose backward runs ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``. Same inputs and cotangent (numpy, from a seed); fp32
gradients agree to 1e-4. The CUDA kernels K2/K3 are held against the same
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.flash_attention import flash_attention as jax_flash
from sliders_conceptmod_tpu_torch.ops import attention as attn
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = 1e-4


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, g


def _port_grads(fn, q, k, v, g):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("sq", [65, 128])
@pytest.mark.parametrize("sk", [77, 128])
def test_function_backward_matches_jax_pallas_vjp(sq, sk):
    b, h, d = 2, 2, 64
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk)
    out, (dq, dk, dv) = _port_grads(lambda *a: fa.flash_attention_fwd(*a)[0], q, k, v, g)
    want_out, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(want_out), atol=TOL, rtol=TOL)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got, np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


def test_dispatch_head_dim_padding_backward_matches_jax():
    """D = 40 goes through the dispatch's F.pad to 64; gradients of the
    unpadded inputs match the JAX vjp through the same zero padding."""
    b, sq, sk, h, d = 2, 65, 77, 2, 40
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=40)
    _, got = _port_grads(attn.dot_product_attention, q, k, v, g)
    pad = ((0, 0), (0, 0), (0, 0), (0, 64 - d))

    def jax_fn(q, k, v):
        return jax_flash(jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), scale=d**-0.5, interpret=True)[..., :d]

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    for name, gp, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        assert gp.shape == (b, sq if name == "dq" else sk, h, d)
        np.testing.assert_allclose(gp, np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 65, 77, 2, 64), (1, 128, 1, 3, 64), (1, 1, 130, 2, 128)])
def test_bwd_reference_matches_torch_autograd(shape):
    """The plain backward (K2 + K3 formulas, fp32 like the kernels) against
    torch autograd through the plain forward: the two differ only by formula
    and summation order."""
    b, sq, sk, h, d = shape
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(b, sq, sk, h, d, seed=7))
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    out, lse = fa.flash_attention_reference(qr, kr, vr, d**-0.5)
    out.backward(g)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, out.detach(), lse.detach(), g, d**-0.5)
    for got, x in zip((dq, dk, dv), (qr, kr, vr)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, x.grad, atol=1e-5, rtol=1e-5)
    # K2 alone: δ = rowsum(dO∘O) per (batch·head, row)
    _, delta = fa.bwd_dq_reference(q, k, v, out.detach(), lse, g, d**-0.5)
    torch.testing.assert_close(delta, (g * out.detach()).sum(-1).permute(0, 2, 1).reshape(b * h, sq))


def test_grad_mode_decides_the_path():
    """With grad on and an input that requires grad the wrapper returns a
    differentiable output (lse is not); under no_grad it builds no graph;
    on the CPU no kernel counter moves."""
    q, k, v, _ = _inputs(1, 8, 8, 2, 64, seed=1)
    tq = torch.from_numpy(q).requires_grad_(True)
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert out.requires_grad and not lse.requires_grad
    out.sum().backward()
    assert tq.grad is not None and tq.grad.abs().sum() > 0
    with torch.no_grad():
        out2, _ = fa.flash_attention_fwd(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert not out2.requires_grad
    torch.testing.assert_close(out2, out.detach())
    assert counts == (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)
