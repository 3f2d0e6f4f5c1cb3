"""The split rules and split plain versions of the tensor-core K2 and K4a.

K2 (dQ) splits its key range in 64-key units when its q tiles fill less than
two waves of the H100: ``bwd_dq_reference(..., splits=s)`` — per-split fp32
partials of ``Σ dS·K`` summed in split order, then scaled, as the kernel and
its merge compute them — is held against ``jax.vjp`` of the JAX package's
Pallas flash attention in interpret mode (its backward runs
``_bwd_dq_kernel``), fp32 within 2e-4. K4a's bf16 kernel splits its key range
in 64-key units (the fp32 kernel in 32-key tiles): its plain version cut as
the bf16 kernel cuts is held against the JAX k-grid kernel in interpret mode.
The split counts are pinned at every path shape of ``chip_smoke.py``. The
CUDA kernels are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.flash_attention import flash_attention as jax_flash
from sliders_conceptmod_tpu.ops.flash_attention_kgrid import _flash_fwd_impl as jax_kgrid_fwd
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("sq,sk", [(65, 77), (129, 300)])
def test_split_plain_dq_matches_jax_pallas_vjp(sq, sk, splits):
    """Ragged on both axes; 77 keys are two 64-key units, so 5 splits leave
    three empty, which add nothing."""
    b, h, d = 2, 2, 64
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk + splits)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True), *map(jnp.asarray, (q, k, v)))
    want_dq = np.asarray(vjp(jnp.asarray(g))[0])
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_reference(tq, tk, tv, d**-0.5)
    dq, delta = fa.bwd_dq_reference(tq, tk, tv, o, lse, tg, d**-0.5, splits=splits)
    assert dq.dtype == torch.float32 and tuple(dq.shape) == (b, sq, h, d)
    np.testing.assert_allclose(dq.numpy(), want_dq, atol=TOL, rtol=TOL)
    torch.testing.assert_close(delta, (tg * o).sum(-1).permute(0, 2, 1).reshape(b * h, sq))
    # the CPU wrapper takes the plain version with the same split
    got = fa.flash_attention_bwd_dq(tq, tk, tv, o, lse, tg, d**-0.5, splits=splits)
    assert all(torch.equal(x, y) for x, y in zip(got, (dq, delta)))


def test_one_split_is_the_unsplit_formula_bit_for_bit():
    """With one split the plain K2 is ``scale·(dS K)`` over all keys, as
    before the split existed; more splits differ only by summation order."""
    q, k, v, g = map(torch.from_numpy, _inputs(1, 70, 200, 2, 64, seed=3))
    o, lse = fa.flash_attention_reference(q, k, v, 0.125)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125 - lse.reshape(1, 2, 70, 1))
    delta = (g * o).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g, v) - delta[..., None])
    want = torch.einsum("bhqk,bkhd->bqhd", ds, k) * 0.125
    one, _ = fa.bwd_dq_reference(q, k, v, o, lse, g, 0.125, splits=1)
    assert torch.equal(one, want)
    assert fa.split_ranges(200, 3, fa.K2_TILE) == [(0, 128), (128, 200), (200, 200)]
    three, _ = fa.bwd_dq_reference(q, k, v, o, lse, g, 0.125, splits=3)
    torch.testing.assert_close(three, one, atol=1e-6, rtol=1e-5)


# K2's key-range split at every training shape of chip_smoke.py (the
# student's rows): one block per 64-row q tile and batch·head; below two
# waves (264 blocks) enough splits to reach them, each at least 4 units
K2_SPLITS = {
    "self_1024": 2, "cross_1024x77": 1, "self_256": 1, "cross_256x77": 1,
    "sd15_self_4096": 1, "sd15_cross_4096x77": 1, "sd15_self_1024": 3, "sd15_cross_1024x77": 1,
    "sd15_pair_self_1024": 2, "sd15_pair_cross_1024x77": 1, "sd15_pair_self_256": 1, "sd15_pair_cross_256x77": 1,
    "sd21_self_4096": 1,
}


@pytest.mark.parametrize("shape", SMOKE.TRAIN_SHAPES, ids=lambda s: s[0])
def test_k2_split_counts_at_the_training_shapes(shape):
    name, sq, sk, h, _, rows, _ = shape
    assert fa.pick_k2_splits(rows * h, sq, sk) == K2_SPLITS[name]
    # the fp32 kernel has the bf16 kernel's blocks and 64-key units: the same rule
    assert fa.pick_k2_splits(rows * h, sq, sk, torch.float32) == K2_SPLITS[name]


@pytest.mark.parametrize("sq,sk", [(65, 512), (100, 700)])
def test_fp32_rule_split_plain_dq_matches_jax_pallas_vjp(sq, sk):
    """The fp32 wrapper on the CPU with the split its rule picks (2 at these
    lengths: 4 blocks of q rows against 8 and 11 key units) is the
    split plain version, against ``jax.vjp`` of the Pallas kernel, fp32."""
    b, h, d = 1, 2, 64
    assert fa.pick_k2_splits(b * h, sq, sk, torch.float32) == 2
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True), *map(jnp.asarray, (q, k, v)))
    want_dq = np.asarray(vjp(jnp.asarray(g))[0])
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_reference(tq, tk, tv, d**-0.5)
    dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, o, lse, tg, d**-0.5)
    np.testing.assert_allclose(dq.numpy(), want_dq, atol=TOL, rtol=TOL)
    split = fa.bwd_dq_reference(tq, tk, tv, o, lse, tg, d**-0.5, splits=2)
    assert all(torch.equal(x, y) for x, y in zip((dq, delta), split))


# K4a's key-range split at every path shape of chip_smoke.py: (bf16, fp32).
# bf16 blocks are 64-row q tiles and its units 64 keys; fp32's 32 and 32
K4A_SPLITS = {
    ("decode_16384", 1): (2, 1), ("decode_16384", 2): (1, 1), ("encode_4096", 4): (2, 1),
    ("encode_4096", 1): (5, 3), ("encode_1024", 4): (4, 3),
    ("sd15_self_256", 1): (1, 2), ("sd15_cross_256x77", 1): (1, 1), ("sd15_self_64", 1): (1, 1),
    ("sd15_cross_64x77", 1): (1, 1), ("sd15_self_256", 3): (1, 2), ("sd15_cross_256x77", 3): (1, 1),
    ("sd15_pair_self_64", 2): (1, 1), ("sd15_pair_cross_64x77", 2): (1, 1), ("sd15_pair_self_16", 2): (1, 1),
    ("sd15_pair_cross_16x77", 2): (1, 1),
}


@pytest.mark.parametrize("shape", SMOKE.KGRID_PATH_SHAPES, ids=lambda s: f"{s[0]}-rows{s[1]}")
def test_k4a_split_counts_at_the_path_shapes(shape):
    name, rows, sq, sk, h, _ = shape
    want_bf16, want_fp32 = K4A_SPLITS[(name, rows)]
    assert kg.pick_splits(rows * h, sq, sk, torch.bfloat16) == want_bf16
    assert kg.pick_splits(rows * h, sq, sk, torch.float32) == kg.pick_splits(rows * h, sq, sk) == want_fp32
    if want_bf16 > 1:  # every split but the last is at least 4 units of 64 keys
        ranges = fa.split_ranges(sk, want_bf16, kg.split_unit(torch.bfloat16))
        assert all(hi - lo >= 4 * 64 for lo, hi in ranges[:-1]) and ranges[-1][1] == sk


def _jax_kgrid(q, k, v, scale):
    """The JAX k-grid kernel's O and its lane-replicated lse, as [B·H, Sq]."""
    out, residuals = jax_kgrid_fwd(*map(jnp.asarray, (q, k, v)), scale, True)
    return np.asarray(out), np.asarray(residuals[-1])[:, : q.shape[1], 0]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("shape", [(1, 300, 77, 2, 64), (2, 70, 200, 1, 512)], ids=lambda s: "x".join(map(str, s)))
def test_k4a_plain_cut_as_bf16_matches_jax_kgrid_kernel(shape, splits):
    """The plain K4a cut into the bf16 kernel's 64-key units (200 keys in 3
    splits: 128, 72 and an empty one) against the JAX kernel, fp32."""
    b, sq, sk, h, d = shape
    q, k, v, _ = _inputs(b, sq, sk, h, d, seed=d + splits)
    want_out, want_lse = _jax_kgrid(q, k, v, d**-0.5)
    out, lse = kg.flash_attention_kgrid_reference(*map(torch.from_numpy, (q, k, v)), d**-0.5, splits=splits,
                                                  cut_as=torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=2e-5)
    assert kg.split_unit(torch.bfloat16) == 64 and kg.split_unit(torch.float32) == kg.BK == 32
