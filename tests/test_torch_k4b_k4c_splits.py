"""The split rules and split plain versions of the tensor-core K4b and K4c.

K4b (the k-grid dQ) splits its key range, and K4c (dK/dV) its query range,
in 32-row units when their blocks fill less than two waves of the H100, in
both dtypes: ``kgrid_bwd_dq_reference(..., splits=s)`` — per-split unscaled
fp32 partials of ``Σ dS·K`` summed in split order, then scaled, as the kernel
and its merge compute them — and ``kgrid_bwd_dkv_reference`` cut as the bf16
kernels cut, and as the fp32 kernels' own rule cuts, are held against ``jax.vjp`` of the JAX package's k-grid Pallas
flash attention in interpret mode (its backward runs ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``), fp32 within 1e-5·max(1, max|ref|), the bound of
``tests/test_torch_kgrid_bwd.py``. The split counts are pinned at every K4b/K4c
path shape of ``chip_smoke.py``. The CUDA kernels are held against the same
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.ops.flash_attention_kgrid import flash_attention as jax_kgrid
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def _inputs(shape, seed):
    b, sq, sk, h, d = shape
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _close(got, want):
    """|got − want| ≤ 1e-5·max(1, max|want|), elementwise maximum."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


# (B, Sq, Sk, H, D): ragged on both axes at the head-dim classes of the
# kernels (64: one warp per slab; 192, SD1.5's 160 padded: two; 512: four,
# one slab a block in fp32). 100 keys / queries are four 32-row units, 77
# three and 70 three, so 2 and 3 splits give ranges of 64 + the rest and 32
# + 32 + the rest; at 300² (ten units) the fp32 rule splits K4b and K4c 2
# ways.
SHAPES = [(2, 100, 77, 2, 64), (1, 77, 100, 2, 192), (1, 40, 70, 1, 512), (1, 300, 300, 1, 512)]


@pytest.mark.parametrize("splits", [1, 2, 3, None])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_plain_k4b_and_bf16_cut_k4c_match_jax_kgrid_vjp(shape, splits):
    """K4b's plain version over ``splits`` key ranges and K4c's over as many
    query ranges, cut in the kernels' 32-row units (``None``: as many as the
    fp32 kernels' rules pick, ``cut_as`` fp32), against the JAX k-grid
    kernel's custom VJP in interpret mode; δ = rowsum(dO∘O); the CPU
    wrappers take the plain versions with the same splits."""
    b, sq, sk, h, d = shape
    q, k, v, do = _inputs(shape, seed=d + 7 * (splits or 4))
    scale = d**-0.5
    _, vjp = jax.vjp(lambda a, b, c: jax_kgrid(a, b, c, scale=scale, interpret=True), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = kg.flash_attention_kgrid_reference(tq, tk, tv, scale)
    cut = torch.bfloat16 if splits else torch.float32
    dq, delta = kg.kgrid_bwd_dq_reference(tq, tk, tv, o, lse, tdo, scale, splits=splits, cut_as=cut)
    dk, dv = kg.kgrid_bwd_dkv_reference(tq, tk, tv, lse, delta, tdo, scale, splits=splits, cut_as=cut)
    # the counts the plain versions took: the forced ones, or the fp32 rules'
    dq_splits = splits or kg.pick_k4b_splits(b * h, sq, sk, d, torch.float32)
    dkv_splits = splits or kg.pick_dkv_splits(b * h, sq, sk, d, torch.float32)
    if splits is None:
        assert (dq_splits, dkv_splits) == ((2, 2) if sq == 300 else (1, 1))
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
        _close(got.numpy(), w)
    _close(delta.numpy(), np.einsum("bqhd,bqhd->bhq", do, o.numpy()).reshape(b * h, sq))
    got = kg.flash_attention_kgrid_bwd_dq(tq, tk, tv, o, lse, tdo, scale, splits=dq_splits)
    assert all(torch.equal(x, y) for x, y in zip(got, (dq, delta)))
    got = kg.flash_attention_kgrid_bwd_dkv(tq, tk, tv, lse, delta, tdo, scale, splits=dkv_splits)
    assert all(torch.equal(x, y) for x, y in zip(got, (dk, dv)))


def test_one_split_is_the_unsplit_formula_bit_for_bit():
    """With one split the plain K4b is ``scale·(dS K)`` over all keys from
    the pre-scaled q, as before the split existed; more splits differ only
    by summation order, and empty splits add nothing."""
    q, k, v, do = map(torch.from_numpy, _inputs((1, 70, 200, 2, 192), seed=3))
    scale = 192**-0.5
    o, lse = kg.flash_attention_kgrid_reference(q, k, v, scale)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q * scale, k) - lse.reshape(1, 2, 70, 1))
    delta = (do * o).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    want = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    one, one_delta = kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale, splits=1)
    assert torch.equal(one, want) and torch.equal(one_delta, delta.reshape(2, 70))
    # fp32 inputs cut as the fp32 kernel: one split here (seven 32-key units,
    # under the eight that two splits of at least four units need)
    assert kg.pick_k4b_splits(2, 70, 200, 192, torch.float32) == 1
    assert torch.equal(kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale)[0], want)
    assert kg.split_ranges(200, 3) == [(0, 96), (96, 192), (192, 200)]
    assert kg.split_ranges(200, 64)[6:8] == [(192, 200), (200, 200)]
    for splits in (3, 64):
        many, _ = kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale, splits=splits)
        torch.testing.assert_close(many, one, atol=1e-6, rtol=1e-5)
    # cut_as picks the split count the bf16 kernel takes
    dk, dv = kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta.reshape(2, 70), do, scale, cut_as=torch.bfloat16)
    want_dkv = kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta.reshape(2, 70), do, scale,
                                          splits=kg.pick_dkv_splits(2, 70, 200, 192, torch.bfloat16))
    assert torch.equal(dk, want_dkv[0]) and torch.equal(dv, want_dkv[1])


# (K4b's key-range splits, K4c's query-range splits) of the bf16 kernels at
# every K4b/K4c path shape of chip_smoke.py (8 heads of 160 run at 192): a
# block per 32-row tile and batch·head; below two waves (264 blocks) enough
# splits to reach them, each at least four 32-row units
BF16_SPLITS = {
    "esd_self_256": (2, 2), "esd_cross_256x77": (1, 2), "esd_self_64": (1, 1), "esd_cross_64x77": (1, 1),
    "pair_self_64": (1, 1), "pair_cross_64x77": (1, 1), "pair_self_16": (1, 1), "pair_cross_16x77": (1, 1),
}
# the same for the fp32 (3xTF32) kernels, whose blocks own 32 rows at d 192
FP32_SPLITS = {
    "esd_self_256": (2, 2), "esd_cross_256x77": (1, 2), "esd_self_64": (1, 1), "esd_cross_64x77": (1, 1),
    "pair_self_64": (1, 1), "pair_cross_64x77": (1, 1), "pair_self_16": (1, 1), "pair_cross_16x77": (1, 1),
}


@pytest.mark.parametrize("shape", SMOKE.KGRID_BWD_SHAPES, ids=lambda s: s[0])
def test_k4b_split_counts_at_the_path_shapes(shape):
    name, rows, sq, sk = shape
    bh, d = rows * SMOKE.KGRID_BWD_HEADS, 192
    assert kg.pick_k4b_splits(bh, sq, sk, d, torch.bfloat16) == BF16_SPLITS[name][0]
    # the fp32 kernel at d 192 owns 32 q rows a block too: the same counts
    assert kg.pick_k4b_splits(bh, sq, sk, d, torch.float32) == FP32_SPLITS[name][0]
    assert kg.bwd_rows_per_block(d, torch.bfloat16) == kg.bwd_rows_per_block(d, torch.float32) == 32
    assert kg.pick_k4b_splits(1, 1024, 1024, 512, torch.bfloat16) == 8  # 32 q blocks: 4 key units per split
    assert kg.pick_k4b_splits(1, 1024, 1024, 512, torch.float32) == 5  # 64 q blocks of 16 rows


@pytest.mark.parametrize("shape", SMOKE.KGRID_BWD_SHAPES, ids=lambda s: s[0])
def test_bf16_k4c_split_counts_at_the_path_shapes(shape):
    """At d 192 the bf16 and fp32 kernels both own 32 keys per block, so the
    counts agree; above d 256 the fp32 kernel's 16-key blocks give fewer."""
    name, rows, sq, sk = shape
    bh = rows * SMOKE.KGRID_BWD_HEADS
    assert kg.pick_dkv_splits(bh, sq, sk, 192, torch.bfloat16) == BF16_SPLITS[name][1]
    assert kg.pick_dkv_splits(bh, sq, sk, 192) == FP32_SPLITS[name][1]
    assert kg.pick_dkv_splits(1, 1024, 1024, 512, torch.bfloat16) == 8  # 32 key blocks: 4 q tiles per split
    assert kg.pick_dkv_splits(1, 1024, 1024, 512) == 5  # 64 key blocks: 5 splits reach two waves
    assert kg.pick_dkv_splits(1, 4096, 100, 64, torch.bfloat16) == 32  # 2 key blocks of 64: at the cap
