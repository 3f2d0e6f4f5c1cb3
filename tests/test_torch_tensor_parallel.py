"""Tensor parallelism of the port (``parallel/mesh.py::tp_shard_tree``) in
a 2-rank gloo world on the CPU (mirrors ``tests/test_tensor_parallel.py``):

* a tiny Flux forward with every Linear's output rows sharded over the
  model axis equals the unsharded forward and the JAX package's (the same
  weights), and so does the gradient of its input, fp32 within 2e-4; so does
  the int8 base (QuantLinear codes and scales sharded), against JAX's int8
  forward; each rank holds less than the whole;
* two SD3 ESD steps with ``mesh_model`` 2 — the overlay student, and the
  merged student (each rank merges its rows; the factor gradients are
  summed over the model axis) — equal the one-process steps within 2e-4."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_workers as W
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.models import flux as jflux
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _flux_assets import random_flux
from test_torch_family_dp import _sd3
from test_torch_quant import _quantized_port
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

RANKS, TOL = 2, 2e-4


def _flux_inputs(cfg):
    gh = gw = 4
    txt = 3
    r = np.random.default_rng(0)
    x = (0.1 * r.standard_normal((1, gh * gw, cfg.in_channels))).astype(np.float32)
    ctx = (0.1 * r.standard_normal((1, txt, 32))).astype(np.float32)
    pooled = (0.1 * r.standard_normal((1, 32))).astype(np.float32)
    t = np.asarray([0.5], np.float32)
    txt_ids = np.zeros((txt, 3), np.float32)
    img_ids = np.asarray(jflux.prepare_latent_image_ids(gh, gw), np.float32)
    ct = r.standard_normal((1, gh * gw, cfg.in_channels)).astype(np.float32)
    return (x, t, ctx, pooled, txt_ids, img_ids), ct


@pytest.fixture(scope="module")
def flux_world(tmp_path_factory):
    model, params, port = random_flux()
    inputs, ct = _flux_inputs(port.config)
    qtree, scales = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_elems=1)
    qport = _quantized_port(port, qtree)
    out = tmp_path_factory.mktemp("tp")
    models = {"bf": copy.deepcopy(port), "int8": copy.deepcopy(qport)}
    tmesh.spawn_world(W.tp_forward, (str(out), models, tuple(torch.from_numpy(a) for a in inputs),
                                     torch.from_numpy(ct)), RANKS, device="cpu")
    japplies = {"bf": (lambda p, *a: model.apply({"params": p}, *a), params),
                "int8": (jquant.make_quant_apply(model, scales, compute_dtype=jnp.float32), qtree)}
    return {"bf": port, "int8": qport}, japplies, (inputs, ct), W.load(out, RANKS)


@pytest.mark.parametrize("base", ["bf", "int8"])
def test_flux_forward_under_model_sharding_matches_unsharded_and_jax(flux_world, base):
    ports, japplies, (inputs, ct), ranks = flux_world
    japply, tree = japplies[base]
    want = np.asarray(jax.jit(japply)(tree, *inputs))
    want_dx = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(japply(tree, x, *inputs[1:]) * ct)))(
        jnp.asarray(inputs[0])))
    tx = torch.from_numpy(inputs[0]).requires_grad_(True)
    ty = ports[base](tx, *(torch.from_numpy(a) for a in inputs[1:]))
    (ty * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), want, atol=TOL, rtol=0)
    for r in ranks:
        got = r[base]
        assert not r["jax_loaded"] and got["n_sharded"] > 10 and got["held"] < 0.75
        np.testing.assert_allclose(got["y"].numpy(), ty.detach().numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(got["y"].numpy(), want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got["dx"].numpy(), tx.grad.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(got["dx"].numpy(), want_dx, atol=TOL, rtol=0)


ROUTES = {"overlay": dict(student_overlay=True, overlay_warmup=False),
          "merged": dict(student_overlay=False, overlay_warmup=None)}


@pytest.fixture(scope="module")
def step_world(tmp_path_factory):
    jobs = {}
    for name, route in ROUTES.items():
        jsites, jlp, tsites, _, job = _sd3(False)
        job = list(job)
        job[5] = dict(job[5], **route)
        job[9:] = [1, RANKS]  # data 1, model 2
        jobs[name] = (tsites, tuple(job))
    out = tmp_path_factory.mktemp("tp_steps")
    tmesh.spawn_world(W.esd_steps, (str(out), {n: j for n, (_, j) in jobs.items()}), RANKS, device="cpu")
    return jobs, W.load(out, RANKS)


@pytest.mark.parametrize("route", list(ROUTES))
def test_sd3_steps_with_mesh_model_2_match_one_process(step_world, route):
    jobs, ranks = step_world
    tsites, (make, pre, post, kw, cfg, cfg_kwargs, opt_spec, tbank, draws, _, _) = jobs[route]
    pre = copy.deepcopy(pre)
    opt = W._optimizer(opt_spec)
    step = W._fn(make)(*pre, opt, W._fn(cfg)(**cfg_kwargs), *post, **kw)
    state = opt.init(toptim.flat_params(tsites, pre[2]))
    before = tlora.state_dict_numpy(tsites, pre[2])
    one = [step(state, tbank, draws=copy.deepcopy(d)) for d in draws]
    want = tlora.state_dict_numpy(tsites, pre[2])
    for r in ranks:
        assert not r["jax_loaded"]
        for m, o in zip(r[route]["metrics"], one):
            np.testing.assert_allclose(m["loss"], float(o["loss"]), rtol=TOL, atol=1e-7)
            np.testing.assert_allclose(m["grad_norm"], float(o["grad_norm"]), rtol=TOL)
        got = tlora.state_dict_numpy(tsites, r[route]["factors"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
    assert max(np.abs(want[k] - before[k]).max() for k in want) > 5e-3  # the factors moved
