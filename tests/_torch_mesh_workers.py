"""Worker entry points of the port's mesh tests: each runs in every rank of
a spawned gloo world (``parallel/mesh.py::spawn_world``) and writes its
results to ``{out}/rank{r}.pt``. This module imports torch and the port
only — never JAX or the JAX package — so a spawned rank never loads them
(each result records whether it did)."""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import torch

from sliders_conceptmod_tpu_torch.parallel import mesh as mesh_lib


def _save(out: str, result: dict) -> None:
    result["jax_loaded"] = any(m.split(".")[0] in ("jax", "sliders_conceptmod_tpu") for m in sys.modules)
    result["backend"] = mesh_lib._WORLD["backend"]
    torch.save(result, Path(out) / f"rank{mesh_lib.rank()}.pt")


def load(out, ranks: int) -> list:
    """Every rank's saved results."""
    return [torch.load(Path(out) / f"rank{r}.pt", weights_only=False) for r in range(ranks)]


def _fn(name: str):
    module, _, fn = name.partition(":")
    return getattr(importlib.import_module(module), fn)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def fail(out: str) -> None:
    """Rank 1 raises (the launcher's failure path)."""
    if mesh_lib.rank() == 1:
        raise RuntimeError("rank 1 failed on purpose")
    mesh_lib.barrier("never_crossed", timeout_ms=60_000)


def collectives(out: str) -> None:
    """The collectives of every dtype the paths move: each rank's
    ``arange`` (offset by its rank) all-gathered, passed one hop round the
    ring, summed, and a Python object broadcast from rank 0; a barrier
    crossed twice under one name."""
    r, n = mesh_lib.rank(), mesh_lib.world_size()
    mesh = mesh_lib.make_mesh(data=n, model=1)
    res = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = (torch.arange(6).reshape(2, 3) + 10 * r).to(dtype)
        res[str(dtype)] = {"gathered": mesh_lib.all_gather_cat(x, 0, mesh.data_group),
                           "passed": mesh_lib.ring_exchange([x, x + 1], mesh.data_ranks, mesh.data_group)}
    res["summed"] = mesh_lib.all_reduce_sum_(torch.full((3,), float(r + 1)), mesh.data_group)
    res["object"] = mesh_lib.broadcast_object({"from": r} if r == 0 else None)
    res["objects"] = mesh_lib.gather_objects(r * 2)
    for _ in range(2):
        mesh_lib.barrier("twice")
    _save(out, res)


# ---------------------------------------------------------------------------
# ring attention and the sequence-parallel dispatch
# ---------------------------------------------------------------------------


def ring_cases(out: str, cases: dict) -> None:
    """``{name: (q, k, v, dO, scale)}`` (whole sequences): ring attention on
    this rank's sequence blocks; each case's output block and block
    gradients."""
    from sliders_conceptmod_tpu_torch.parallel.ring_attention import ring_attention

    mesh = mesh_lib.make_mesh(data=mesh_lib.world_size(), model=1)
    res = {}
    for name, (q, k, v, do, scale) in cases.items():
        lo, hi = mesh_lib.data_share(q.shape[1], mesh)
        qb, kb, vb = (t[:, lo:hi].clone().requires_grad_(True) for t in (q, k, v))
        o = ring_attention(qb, kb, vb, mesh=mesh, scale=scale)
        o.backward(do[:, lo:hi])
        res[name] = {"lo": lo, "hi": hi, "o": o.detach(), "dq": qb.grad, "dk": kb.grad, "dv": vb.grad}
    _save(out, res)


def sp_forward(out: str, models: dict, inputs: tuple, ct, min_seq: int, tpu_cfg) -> None:
    """Each of ``models`` (name → model) run as ``model(*inputs)`` under
    ``sequence_parallel`` over the whole world, with the gradient of
    ``sum(y · ct)`` with respect to ``inputs[0]`` and the q/k shapes the
    dispatch sent to the ring; then a cross-attention and a short
    self-attention probed inside the context, and what
    ``sequence_parallel_from_config(tpu_cfg)`` sets."""
    from sliders_conceptmod_tpu_torch.ops import attention as attn
    from sliders_conceptmod_tpu_torch.parallel import ring_attention as ra

    mesh = mesh_lib.make_mesh(data=mesh_lib.world_size(), model=1)
    routed = []
    orig = ra.sequence_sharded_attention

    def spy(q, k, v, **kw):
        routed.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v, **kw)

    res = {}
    ra.sequence_sharded_attention = spy
    try:
        for name, model in models.items():
            del routed[:]
            x = inputs[0].clone().requires_grad_(True)
            with attn.sequence_parallel(mesh, min_seq=min_seq):
                y = model(x, *inputs[1:])
                (y * ct).sum().backward()
            res[name] = {"y": y.detach(), "dx": x.grad, "routed": list(routed)}
        del routed[:]
        with attn.sequence_parallel(mesh, min_seq=min_seq):
            q = torch.randn(1, 2 * min_seq, 2, 8, generator=torch.Generator().manual_seed(0))
            attn.dot_product_attention(q, q[:, :min_seq], q[:, :min_seq])  # cross-attention: q_seq != kv_seq
            short = q[:, : min_seq // 2]
            attn.dot_product_attention(short, short, short)  # below min_seq
        res["probes_routed"] = list(routed)
        with attn.sequence_parallel_from_config(tpu_cfg):
            ctx = attn._SP_CTX
            res["from_config"] = None if ctx is None else (ctx[0].shape, ctx[1], ctx[2])
        res["after"] = attn._SP_CTX
    finally:
        ra.sequence_sharded_attention = orig
    _save(out, res)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _optimizer(spec):
    """``(name, schedule args, kwargs[, MultiSteps k])`` → the port's optimizer."""
    from sliders_conceptmod_tpu_torch.train import optim

    name, sched, kwargs = spec[:3]
    opt = optim.get_optimizer(name, optim.get_lr_schedule(*sched), **kwargs)
    return optim.MultiSteps(opt, spec[3]) if len(spec) > 3 else opt


def _esd_job(make: str, pre: tuple, post: tuple, kw: dict, cfg: str, cfg_kwargs: dict, opt_spec, bank,
             draws_per_step: list, data: int, model: int = 1) -> dict:
    from sliders_conceptmod_tpu_torch.train.optim import flat_params

    mesh = mesh_lib.make_mesh(data=data, model=model)
    module, sites, factors = pre[0], pre[1], pre[2]
    for leaf in factors.values():
        for t in leaf.values():
            t.requires_grad_(True)
    if model > 1:
        mesh_lib.tp_shard_tree(module, mesh)
    opt = _optimizer(opt_spec)
    step = _fn(make)(*pre, opt, _fn(cfg)(**cfg_kwargs, mesh=mesh), *post, **kw)
    state = opt.init(flat_params(sites, factors))
    metrics = []
    for draws in draws_per_step:
        m = step(state, bank, draws=draws)
        metrics.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    return {"metrics": metrics, "factors": _cpu(factors)}


def esd_steps(out: str, jobs: dict) -> None:
    """Each job ``name → (make, pre, post, kw, cfg, cfg_kwargs, opt_spec,
    bank, draws_per_step, data[, model])``: an ESD step ``make(*pre,
    optimizer, cfg(**cfg_kwargs, mesh=...), *post, **kw)`` on a (data,
    model) mesh over the world (``pre[0]`` tensor-sharded when model > 1)
    run on the given draws — each step's loss and grad norm and the trained
    factors (``pre[2]``)."""
    _save(out, {name: _esd_job(*job) for name, job in jobs.items()})


def train(out: str, module: str, config, prompts, kwargs: dict) -> None:
    """A trainer's ``train(config, prompts, **kwargs)`` (``module``: the
    trainer module or CLI module that has it): the losses, the metrics rows
    and the trained factors."""
    res = _fn(f"{module}:train")(config, prompts, **kwargs)
    _save(out, {"losses": list(res.losses), "rows": res.metrics, "factors": _cpu(res.lora_params)})


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def tp_forward(out: str, models: dict, inputs: tuple, ct) -> None:
    """Each of ``models`` (name → model) tensor-sharded over the whole
    world's model axis and run as ``model(*inputs)``: its output, the
    gradient of ``sum(y · ct)`` with respect to ``inputs[0]``, the share of
    the model's tensors this rank holds and the number of sharded modules."""
    mesh = mesh_lib.make_mesh(data=1, model=mesh_lib.world_size())
    res = {}
    for name, model in models.items():
        before = sum(t.numel() for t in model.state_dict().values())
        mesh_lib.tp_shard_tree(model, mesh)
        after = sum(t.numel() for t in model.state_dict().values())
        x = inputs[0].clone().requires_grad_(True)
        y = model(x, *inputs[1:])
        (y * ct).sum().backward()
        res[name] = {"y": y.detach(), "dx": x.grad, "held": after / before,
                     "n_sharded": sum(1 for m in model.modules() if getattr(m, "_tp", None) is not None)}
    _save(out, res)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def fp32_service(family: str):
    """The family's service class in fp32 weights."""
    from sliders_conceptmod_tpu_torch import serve

    base = {"xl": serve.SliderService, "sd1": serve.SD1SliderService, "sd3": serve.SD3SliderService,
            "flux": serve.FluxSliderService}[family]
    return type(f"FP32{base.__name__}", (base,), {"weight_dtype": torch.float32})


def serve_requests(svc, requests, extra=None) -> list:
    """PNG bytes of ``requests`` one by one, of all of them as one
    micro-batch, and (``extra``: name, path, request) of a slider
    registered now."""
    out = [svc.generate(*r) for r in requests]
    out += svc._generate_batch([tuple(r) + ("default",) for r in requests])
    if extra is not None:
        name, path, req = extra
        svc.add_slider(name, path)
        out.append(svc.generate(*req, slider=name))
    return out


def serve(out: str, family: str, base: str, slider: str, kwargs: dict, requests, extra=None) -> None:
    """A mesh service over the world: rank 0 serves ``requests``
    (:func:`serve_requests`) and closes it; the other ranks run its ops."""
    svc = fp32_service(family)(base, slider, device="cpu", **kwargs)
    if svc.serve_ranks():
        pngs = serve_requests(svc, requests, extra)
        svc.close()
        _save(out, {"pngs": pngs, "max_batch": svc._batcher.max_batch, "buckets": svc._buckets})
    else:
        _save(out, {"worker": True})
