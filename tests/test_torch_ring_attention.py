"""Ring attention and the sequence-parallel dispatch of the port
(``parallel/ring_attention.py``, ``ops/attention.py::sequence_parallel``) in
a 4-rank gloo world on the CPU, against the JAX package's ``ring_attention``
on a 4-device CPU mesh (conftest's host devices) and against dense
attention, from the same numpy inputs; fp32 within 2e-4 (the default
bound). Mirrors ``tests/test_ring_attention.py``:

* dense equality, uneven heads with a custom scale, and a head dim of 160
  (the K4a/K4b/K4c route's plain versions), forward and the gradients of
  q, k and v;
* a tiny MMDiT under ``sequence_parallel``: its joint self-attentions (32
  tokens) go through the ring and reproduce the dense forward and the
  input's gradient, also over the int8 base; a cross-attention and a
  sequence below ``min_seq`` stay local;
* ``sequence_parallel_from_config``.

Every rank of the world runs ``tests/_torch_mesh_workers.py``, which
imports no JAX (each rank reports it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.ops import attention as jattn
from sliders_conceptmod_tpu.parallel import mesh as jmesh
from sliders_conceptmod_tpu.parallel.ring_attention import ring_attention as jring
from sliders_conceptmod_tpu_torch.core.config import TPUConfig
from sliders_conceptmod_tpu_torch.ops import attention as tattn
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
import _torch_mesh_workers as W
from _sd3_assets import random_mmdit
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)
from test_torch_quant import _quantized_port

RANKS = 4
TOL = 2e-4
# name -> (B, S, H, D, scale)
CASES = {
    "dense": (2, RANKS * 16, 3, 16, None),
    "uneven_heads_scale": (1, RANKS * 4, 5, 8, 0.5),
    "head_dim_160": (1, RANKS * 8, 2, 160, None),
}


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    q, k = (0.3 * r.standard_normal(shape)).astype(np.float32), (0.3 * r.standard_normal(shape)).astype(np.float32)
    v, do = r.standard_normal(shape).astype(np.float32), r.standard_normal(shape).astype(np.float32)
    return q, k, v, do


def _jax_ring(q, k, v, do, scale):
    """JAX's ring on a 4-device mesh: (out, (dq, dk, dv))."""
    m = jmesh.make_mesh(data=RANKS, model=1, devices=jax.devices()[:RANKS])
    spec = NamedSharding(m, P(None, "data", None, None))
    qs, ks, vs, cts = (jax.device_put(jnp.asarray(x), spec) for x in (q, k, v, do))

    def loss(a, b, c):
        return jnp.sum(jring(a, b, c, mesh=m, scale=scale) * cts)

    with m:
        out = jax.jit(lambda a, b, c: jring(a, b, c, mesh=m, scale=scale))(qs, ks, vs)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(qs, ks, vs)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    inputs = {name: _inputs(shape[:4], i) for i, (name, shape) in enumerate(CASES.items())}
    cases = {name: tuple(torch.from_numpy(a) for a in inputs[name]) + (CASES[name][4],) for name in CASES}
    out = tmp_path_factory.mktemp("ring")
    tmesh.spawn_world(W.ring_cases, (str(out), cases), RANKS, device="cpu")
    return inputs, W.load(out, RANKS)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax_ring_and_dense(ring_world, name):
    inputs, ranks = ring_world
    q, k, v, do = inputs[name]
    scale = CASES[name][4]
    got = {key: np.concatenate([r[name][key].numpy() for r in ranks], axis=1) for key in ("o", "dq", "dk", "dv")}
    assert [(r[name]["lo"], r[name]["hi"]) for r in ranks] == [(i * q.shape[1] // RANKS, (i + 1) * q.shape[1] // RANKS)
                                                               for i in range(RANKS)]
    j_out, j_grads = _jax_ring(q, k, v, do, scale)
    np.testing.assert_allclose(got["o"], j_out, atol=TOL, rtol=0)
    for key, want in zip(("dq", "dk", "dv"), j_grads):
        np.testing.assert_allclose(got[key], want, atol=TOL, rtol=0, err_msg=key)
    # and dense attention (torch autograd over the whole sequence)
    s = q.shape[-1] ** -0.5 if scale is None else scale
    tq, tk, tv = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(torch.einsum("bqhd,bkhd->bhqk", tq * s, tk), -1), tv)
    o.backward(torch.from_numpy(do).double())
    np.testing.assert_allclose(got["o"], o.detach().numpy(), atol=TOL, rtol=0)
    for key, t in zip(("dq", "dk", "dv"), (tq, tk, tv)):
        np.testing.assert_allclose(got[key], t.grad.numpy(), atol=TOL, rtol=0, err_msg=key)
    assert not any(r["jax_loaded"] for r in ranks) and {r["backend"] for r in ranks} == {"gloo"}


def _mmdit_inputs(cfg):
    r = np.random.default_rng(7)
    x = (0.2 * r.standard_normal((2, cfg.in_channels, 8, 8))).astype(np.float32)
    ctx = (0.2 * r.standard_normal((2, 16, cfg.joint_attention_dim))).astype(np.float32)
    pooled = (0.2 * r.standard_normal((2, cfg.pooled_projection_dim))).astype(np.float32)
    t = np.full((2,), 500.0, np.float32)
    ct = r.standard_normal((2, cfg.out_channels, 8, 8)).astype(np.float32)
    return x, t, ctx, pooled, ct


@pytest.fixture(scope="module")
def sp_world(tmp_path_factory):
    """The tiny MMDiT (and its int8 base) under sequence_parallel on the
    4-rank world; the JAX model, params and int8 apply for the references."""
    model, params, port = random_mmdit()
    x, t, ctx, pooled, ct = _mmdit_inputs(port.config)
    qtree, scales = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_elems=1)
    q_apply = jquant.make_quant_apply(model, scales, compute_dtype=jnp.float32)
    qport = _quantized_port(port, qtree)
    out = tmp_path_factory.mktemp("sp")
    cfg = TPUConfig(sequence_parallel=True, sp_min_seq=16, mesh_data=RANKS, mesh_model=1)
    tmesh.spawn_world(W.sp_forward, (str(out), {"bf": port, "int8": qport},
                                     tuple(torch.from_numpy(a) for a in (x, t, ctx, pooled)),
                                     torch.from_numpy(ct), 8, cfg), RANKS, device="cpu")
    return (model, params, port, qtree, q_apply, qport), (x, t, ctx, pooled, ct), W.load(out, RANKS)


@pytest.mark.parametrize("base", ["bf", "int8"])
def test_sequence_parallel_routes_the_mmdit_joint_attention(sp_world, base):
    (model, params, port, qtree, q_apply, qport), (x, t, ctx, pooled, ct), ranks = sp_world
    if base == "int8":
        japply, tree, tmodel = q_apply, qtree, qport
    else:
        japply, tree, tmodel = (lambda p, *a: model.apply({"params": p}, *a)), params, port

    def jloss(xx):
        return jnp.sum(japply(tree, xx, t, ctx, pooled) * ct)

    want = np.asarray(japply(tree, x, t, ctx, pooled))
    want_dx = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    # JAX's own ring route over its 4-device mesh gives the same forward
    m = jmesh.make_mesh(data=RANKS, model=1, devices=jax.devices()[:RANKS])
    with jattn.sequence_parallel(m, min_seq=8):
        jringed = np.asarray(jax.jit(lambda p, *a: japply(p, *a))(tree, x, t, ctx, pooled))
    np.testing.assert_allclose(jringed, want, atol=TOL, rtol=0)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tmodel(tx, *(torch.from_numpy(a) for a in (t, ctx, pooled)))
    (ty * torch.from_numpy(ct)).sum().backward()
    for r in ranks:
        got = r[base]
        # every joint attention of the model (2 blocks: 16 image + 16 context tokens) went through the ring
        assert len(got["routed"]) == port.config.num_layers
        assert all(q == k and q[1] == 32 for q, k in got["routed"])
        np.testing.assert_allclose(got["y"].numpy(), want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got["y"].numpy(), ty.detach().numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(got["dx"].numpy(), want_dx, atol=TOL, rtol=0)
        np.testing.assert_allclose(got["dx"].numpy(), tx.grad.numpy(), atol=TOL, rtol=0)
        assert not r["jax_loaded"]


def test_cross_and_short_attention_stay_local(sp_world):
    for r in sp_world[2]:
        assert r["probes_routed"] == []


def test_sequence_parallel_from_config(sp_world):
    for r in sp_world[2]:
        assert r["from_config"] == ({"data": RANKS, "model": 1}, "data", 16)
        assert r["after"] is None
    with tattn.sequence_parallel_from_config(TPUConfig()):
        assert tattn._SP_CTX is None  # nullcontext: no routing
    # one process: a 1x1 mesh, which routes nothing
    with tattn.sequence_parallel_from_config(TPUConfig(sequence_parallel=True, sp_min_seq=4)):
        mesh, axis, min_seq = tattn._SP_CTX
        assert mesh.shape == {"data": 1, "model": 1} and axis == "data" and min_seq == 4
        q = torch.randn(1, 8, 2, 8)
        assert torch.equal(tattn.dot_product_attention(q, q, q), tattn.kernel_attention(q, q, q, 8 ** -0.5))
    assert tattn._SP_CTX is None
