"""The port's attention (plain version of kernel K1 and the dispatch) against
the JAX package's Pallas flash attention (interpret mode) and its XLA path.

On the CPU the kernel wrapper takes its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.attention import _xla_attention
from sliders_conceptmod_tpu.ops.flash_attention import flash_attention as jax_flash
from sliders_conceptmod_tpu_torch.ops import attention as attn
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, Sq, Sk, H, D) — the shapes of tests/test_flash_attention.py
SHAPES = [
    (2, 256, 256, 2, 64),
    (1, 300, 77, 2, 64),  # ragged q and k tails
    (1, 640, 640, 1, 64),  # several q/k blocks
]


def _qkv(shape, seed, dtype=np.float32):
    b, sq, sk, h, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(dtype) for s in (sq, sk, sk)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_flash_and_xla(shape):
    q, k, v = _qkv(shape, seed=0)
    scale = shape[-1] ** -0.5
    want_flash = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), scale=scale, interpret=True))
    want_xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), scale))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), want_flash, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), want_xla, atol=2e-5, rtol=2e-5)
    dispatched = attn.dot_product_attention(tq, tk, tv).numpy()
    np.testing.assert_allclose(dispatched, want_xla, atol=2e-5, rtol=2e-5)
    # lse [B·H, Sq]: the row logsumexp of the scaled logits
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64) * scale, k.astype(np.float64))
    m = logits.max(-1, keepdims=True)
    want_lse = (m[..., 0] + np.log(np.exp(logits - m).sum(-1))).reshape(-1, shape[1])
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (shape[0] * shape[3], shape[1])
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)


def test_plain_bf16_close_to_fp32():
    q, k, v = _qkv((1, 512, 512, 2, 64), seed=1)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out, _ = fa.flash_attention_fwd(*bf)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(
        jax_flash(*(jnp.asarray(x.float().numpy()) for x in bf), interpret=True)
    )
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=3e-2)


def test_head_dim_padding_matches_jax():
    """The kernel path zero-pads head dims (40 → 64, 80 → 128) and slices the
    output back; scores and outputs must not change."""
    for d in (40, 80):
        q, k, v = _qkv((1, 256, 77, 2, d), seed=d)
        scale = d**-0.5
        pad = ((0, 0), (0, 0), (0, 0), (0, ((d + 63) // 64) * 64 - d))
        want = np.asarray(
            jax_flash(*(jnp.pad(jnp.asarray(x), pad) for x in (q, k, v)), scale=scale, interpret=True)
        )[..., :d]
        got = attn.kernel_attention(*map(torch.from_numpy, (q, k, v)), scale)
        assert tuple(got.shape) == q.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(fa, "build", refuse)
    monkeypatch.setattr(fa, "_library", refuse)
    before = fa.flash_attention_fwd.launches
    q, k, v = map(torch.from_numpy, _qkv((1, 64, 77, 2, 64), seed=3))
    fa.flash_attention_fwd(q, k, v)
    attn.dot_product_attention(q, k, v)
    attn.kernel_attention(q, k, v, 0.125)
    assert fa.flash_attention_fwd.launches == before


def test_wrapper_rejects_bad_inputs():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 8, 2, 64), seed=4))
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k.double(), v)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q[0], k[0], v[0])


def test_module_imports_without_nvcc_or_triton():
    code = textwrap.dedent(
        """
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "triton":
                    raise ImportError("triton refused")
        sys.meta_path.insert(0, Refuse())
        from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
        from sliders_conceptmod_tpu_torch.ops import attention
        assert fa._libs == {} and fa.flash_attention_fwd.launches == 0
        assert fa.flash_attention_bwd_dq.launches == fa.flash_attention_bwd_dkv.launches == 0
        print("imported")
        """
    )
    env = dict(os.environ, CUDA_HOME="/nonexistent", PATH="/nonexistent", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout
