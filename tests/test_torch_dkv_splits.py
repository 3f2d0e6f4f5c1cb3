"""K3's query-range split: the plain version ``bwd_dkv_reference(...,
splits=s)`` — per-split fp32 partials of dK and dV over 64-row ranges of the
queries, summed in split order, as the tensor-core kernel and its merge
compute them — against ``jax.vjp`` of the JAX package's Pallas flash
attention in interpret mode (its backward runs ``_bwd_dkv_kernel``), fp32
within 2e-4; and the split rule at every training path shape of
``chip_smoke.py``. The CUDA kernel is held against the same plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.flash_attention import flash_attention as jax_flash
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.TRAIN_SHAPES


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("splits", [1, 2, 3, fa.MAX_SPLITS])
@pytest.mark.parametrize("sq,sk", [(65, 77), (300, 129)])
def test_split_plain_dkv_matches_jax_pallas_vjp(sq, sk, splits):
    """Ragged on both axes; 65 queries are two 64-row units, so splits 3 and
    64 leave empty splits, which add nothing."""
    b, h, d = 2, 2, 64
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk + splits)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True), *map(jnp.asarray, (q, k, v)))
    _, want_dk, want_dv = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_reference(tq, tk, tv, d**-0.5)
    _, delta = fa.bwd_dq_reference(tq, tk, tv, o, lse, tg, d**-0.5)
    dk, dv = fa.bwd_dkv_reference(tq, tk, tv, lse, delta, tg, d**-0.5, splits=splits)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, sk, h, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)
    # the CPU wrapper takes the plain version with the same split
    assert all(torch.equal(x, y) for x, y in zip(
        fa.flash_attention_bwd_dkv(tq, tk, tv, lse, delta, tg, d**-0.5, splits=splits), (dk, dv)))


@pytest.mark.parametrize("shape", _train_shapes(), ids=lambda s: s[0])
def test_k3_split_rule_fills_two_waves_or_hits_its_cap(shape):
    """At every K1-class training shape (the student's rows): the key-tile
    blocks times the splits reach two waves of the H100's 132 SMs, or the
    split count is at its cap (4 q units per split, at most 64); fp32 splits
    by the same rule (the same blocks and units)."""
    _, sq, sk, h, _, rows, _ = shape
    bh = rows * h
    splits = fa.pick_k3_splits(bh, sq, sk)
    key_blocks = -(-sk // fa.K3_TILE) * bh
    units = -(-sq // fa.K3_TILE)
    assert 1 <= splits <= fa.MAX_SPLITS
    cap = max(1, min(units // fa.MIN_TILES_PER_SPLIT, fa.MAX_SPLITS))
    assert key_blocks * splits >= fa.TARGET_BLOCKS or splits == cap
    if splits > 1:  # every split is at least 4 units long, and none is empty
        ranges = fa.split_ranges(sq, splits, fa.K3_TILE)
        assert all(hi - lo >= fa.MIN_TILES_PER_SPLIT * fa.K3_TILE for lo, hi in ranges[:-1])
        assert ranges[0][0] == 0 and ranges[-1][1] == sq and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert fa.pick_k3_splits(bh, sq, sk, torch.float32) == splits


@pytest.mark.parametrize("sq,sk", [(512, 77), (700, 100)])
def test_fp32_rule_split_plain_dkv_matches_jax_pallas_vjp(sq, sk):
    """The fp32 wrapper on the CPU with the split its rule picks (2 at these
    lengths: 4 blocks of keys against 8 and 11 q units) is the split plain
    version, against ``jax.vjp`` of the Pallas kernel, fp32."""
    b, h, d = 1, 2, 64
    assert fa.pick_k3_splits(b * h, sq, sk, torch.float32) == 2
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True), *map(jnp.asarray, (q, k, v)))
    _, want_dk, want_dv = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_reference(tq, tk, tv, d**-0.5)
    _, delta = fa.bwd_dq_reference(tq, tk, tv, o, lse, tg, d**-0.5)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, lse, delta, tg, d**-0.5)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)
    split = fa.bwd_dkv_reference(tq, tk, tv, lse, delta, tg, d**-0.5, splits=2)
    assert all(torch.equal(x, y) for x, y in zip((dk, dv), split))


# (batch·heads, Sq, Sk[, padded head dim]) -> splits: K4a's and K4c's counts at
# every shape chip_smoke.py gives them, as the rule gave them before it moved
# into ops/flash_attention.py
K4A_SPLITS = [((1, 16384, 16384), 1), ((2, 16384, 16384), 1), ((4, 4096, 4096), 1), ((1, 4096, 4096), 3),
              ((4, 300, 77), 1), ((2, 300, 77), 1)]
K4C_SPLITS = [((8, 256, 256, 192), 2), ((8, 256, 77, 192), 2), ((8, 64, 64, 192), 1), ((8, 64, 77, 192), 1),
              ((16, 64, 64, 192), 1), ((16, 64, 77, 192), 1), ((16, 16, 16, 192), 1), ((16, 16, 77, 192), 1),
              ((3, 65, 33, 192), 1), ((4, 300, 77, 512), 2), ((4, 300, 77, 64), 2), ((1, 1, 1, 512), 1),
              ((1, 70, 100, 320), 1), ((1, 16384, 16384, 64), 1), ((4, 1024, 1024, 512), 2),
              ((1, 4096, 4096, 512), 2)]


@pytest.mark.parametrize("args,want", K4A_SPLITS + K4C_SPLITS, ids=str)
def test_moved_split_helpers_keep_k4a_and_k4c_counts(args, want):
    pick = kg.pick_splits if len(args) == 3 else kg.pick_dkv_splits
    assert pick(*args) == want


def test_split_rule_at_the_cross_attention_of_sdxl():
    """Sk = 77 gives two 64-key tiles per head: 20 blocks at SDXL's 10 heads,
    so the 16 q units of 1024 queries split in 4 (its cap)."""
    assert fa.pick_k3_splits(10, 1024, 77) == 4
    assert fa.pick_k3_splits(10, 1024, 1024) == 2  # 160 blocks: two splits reach two waves
    assert fa.pick_k3_splits(8, 4096, 4096) == 1  # 512 blocks fill the card
    assert fa.split_ranges(65, 3, fa.K3_TILE) == [(0, 64), (64, 65), (65, 65)]
    # K4a/K4c cut their ranges in 32-row tiles through the same helper
    assert kg.split_ranges(100, 6) == fa.split_ranges(100, 6, kg.BK) == [
        (0, 32), (32, 64), (64, 96), (96, 100), (100, 100), (100, 100)]
