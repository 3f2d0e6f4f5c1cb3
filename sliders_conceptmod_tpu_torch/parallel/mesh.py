"""The (data, model) mesh over ``torch.distributed`` — counterpart of
``sliders_conceptmod_tpu/parallel/mesh.py``.

JAX runs one controller over every device; PyTorch runs one process per rank.
The port keeps JAX's surface and maps it so:

* :func:`init_distributed` joins a world through a ``tcp://`` store
  (idempotent, as JAX's is). Each rank names its device: ``cpu`` when the
  caller asks for it, else ``cuda:{local rank mod local cards}``. The backend
  is NCCL when every host has a card per local rank, else gloo (the CPU, and
  ranks that share a card: NCCL refuses two ranks on one device). The chosen
  backend is printed.
* :func:`barrier` waits on the store, not on a device collective.
* :func:`make_mesh` lays ranks out ``(data, model)`` row-major, as JAX's
  ``reshape(data, model)`` lays devices, and makes one process group per row
  and per column (:class:`Mesh`).
* :func:`training_mesh_from_config` keeps JAX's rules and messages. A world
  joined through ``tpu.coordinator_address`` / ``num_processes`` /
  ``process_id`` is JAX's multi-process world (:func:`process_count`); a world
  a CLI spawned for itself (:func:`spawn_for_config`) is one host's.
* Placement: every rank holds the same host values (one checkpoint, one
  seed), so replication is the identity; :func:`data_shard_host_tree` keeps a
  rank's rows; :func:`tp_shard_tree` keeps a rank's output rows of every
  Linear / Conv weight (and bias) whose output dim the model axis divides, and
  all-gathers the module's output along the channel dim — the forward equals
  the unsharded one, and each rank holds 1/m of those weights.

Collectives on CUDA tensors over a gloo group are staged through pinned host
buffers, by the group's backend (:func:`_staged`). Where no world is active
every helper is the single-process identity.
"""

from __future__ import annotations

import copy
import datetime
import importlib
import math
import socket
import sys
import types
from contextlib import closing
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

WORLD_TIMEOUT_S = 600.0  # joining the store, and every collective: ranks' set-up times may differ by minutes
_WORLD: dict = {"initialized": False}
_MESHES: Dict[tuple, "Mesh"] = {}  # by (data, model, ranks): a mesh's groups are made once
_BARRIERS: Dict[str, int] = {}
# the model-axis groups of tensor-sharded modules, by id: a module keeps the id (it survives a deepcopy)
_TP_GROUPS: Dict[int, object] = {}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _split_address(address: str) -> Tuple[str, int]:
    host, _, port = address.replace("tcp://", "").rpartition(":")
    return host or "localhost", int(port)


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda", spawned: bool = False) -> None:
    """Join a world of ``num_processes`` ranks through the store at
    ``coordinator_address`` (``host:port`` or ``tcp://host:port``; rank 0
    serves it) as rank ``process_id``. ``device`` is the caller's (``cpu``,
    or ``cuda``: this rank takes ``cuda:{local rank mod local cards}``).
    ``spawned``: the world is one host's, started by :func:`spawn_world`.
    Repeat calls no-op."""
    if _WORLD["initialized"]:
        return
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, num_processes and process_id "
                         "(no cluster is detected on this machine)")
    host, port = _split_address(coordinator_address)
    n, rank = int(num_processes), int(process_id)
    timeout = datetime.timedelta(seconds=WORLD_TIMEOUT_S)
    store = dist.TCPStore(host, port, n, is_master=rank == 0, timeout=timeout)
    on_cpu = torch.device(device).type == "cpu"
    cards = 0 if on_cpu else torch.cuda.device_count()
    # every rank publishes its host and card count; each rank reads all of them, so all agree
    store.set(f"world/host/{rank}", f"{socket.gethostname()}|{cards}")
    hosts = [store.get(f"world/host/{r}").decode().split("|") for r in range(n)]
    mine = hosts[rank][0]
    local_rank = sum(1 for r in range(rank) if hosts[r][0] == mine)  # this rank's index among its host's
    if on_cpu:
        dev = torch.device("cpu")
    else:
        if cards == 0:
            raise RuntimeError("init_distributed(device='cuda'): this rank sees no CUDA device")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    per_host: Dict[str, int] = {}
    for h, _ in hosts:
        per_host[h] = per_host.get(h, 0) + 1
    nccl = not on_cpu and dist.is_nccl_available() and all(
        per_host[h] <= int(c) for h, c in hosts)
    backend = "nccl" if nccl else "gloo"
    dist.init_process_group(backend, store=store, rank=rank, world_size=n, timeout=timeout)
    _WORLD.update(initialized=True, rank=rank, size=n, backend=backend, device=dev, store=store,
                  processes=1 if spawned else n)
    why = ("a card per rank" if nccl else "the CPU" if on_cpu else
           f"{per_host[mine]} ranks share {cards} card(s) on {mine}")
    print(f"[mesh] rank {rank}/{n}: backend {backend} ({why}), device {dev}", flush=True)


def active() -> bool:
    return bool(_WORLD["initialized"])


def world_size() -> int:
    return _WORLD["size"] if active() else 1


def rank() -> int:
    return _WORLD["rank"] if active() else 0


def process_count() -> int:
    """JAX's ``process_count``: the ranks of a world joined through the yaml
    surface; 1 for a single process or a world spawned on one host."""
    return _WORLD["processes"] if active() else 1


def is_writer() -> bool:
    """Rank 0 prints, writes samples and checkpoints, and saves the slider."""
    return rank() == 0


def local_device(device) -> torch.device:
    """This rank's device in a world (the caller's CPU stays the CPU), else
    ``device`` itself."""
    device = torch.device(device)
    if not active() or device.type == "cpu":
        return device
    return _WORLD["device"]


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Block until every rank reaches this barrier — over the store, not a
    device collective (JAX's coordination-service barrier). Ranks whose
    set-up times diverged meet here before their first collective. No-op in
    a single process."""
    if not active():
        return
    _BARRIERS[name] = _BARRIERS.get(name, 0) + 1
    key = f"barrier/{name}/{_BARRIERS[name]}"
    store = _WORLD["store"]
    if store.add(key, 1) == world_size():
        store.set(key + "/done", "1")
    store.wait([key + "/done"], datetime.timedelta(milliseconds=int(timeout_ms)))


def shutdown() -> None:
    if active():
        dist.destroy_process_group()
        _WORLD.clear()
        _WORLD["initialized"] = False
        _MESHES.clear()
        _BARRIERS.clear()


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------


def free_address() -> str:
    """``tcp://localhost:<port>`` on a port that is free now."""
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _module_name(fn: Callable) -> str:
    """``fn``'s module as a child can import it: ``python -m x.y`` runs x.y
    as ``__main__``; a script's ``__main__`` stays so (the start method
    ``spawn`` runs the script again in each child, as its ``__main__``)."""
    name = fn.__module__
    spec = getattr(sys.modules["__main__"], "__spec__", None) if name == "__main__" else None
    return spec.name if spec is not None else name


def _spawned(index: int, module: str, fn_name: str, args: tuple, nprocs: int, address: str, device: str,
             threads: int) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    init_distributed(address, nprocs, index, device=device, spawned=True)
    # torch.multiprocessing hands CPU tensors over in shared memory: each rank works on its own copy
    args = copy.deepcopy(args)
    try:
        getattr(importlib.import_module(module), fn_name)(*args)
    finally:
        shutdown()


def spawn_world(fn: Callable, args: tuple, nprocs: int, device: str = "cuda") -> None:
    """Run ``fn(*args)`` in ``nprocs`` new ranks (start method ``spawn``, one
    world of this host, every rank on ``device``) and wait for all of them.
    ``fn`` must be a module-level function. A rank's failure raises here
    (``torch.multiprocessing.ProcessRaisedException``) after the others are
    stopped. On the CPU the ranks share this process's intra-op threads."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // nprocs)
    mp.start_processes(_spawned, args=(_module_name(fn), fn.__name__, tuple(args), nprocs, free_address(),
                                       str(device), threads),
                       nprocs=nprocs, join=True, start_method="spawn")


def device_kind(device) -> str:
    """``cpu`` or ``cuda`` of a device or a device flag (``cuda:1``, a bare
    CUDA ordinal, ``cpu``)."""
    return "cpu" if str(device).split(":")[0] == "cpu" else "cuda"


def joins_world(tpu_cfg) -> bool:
    """The yaml surface asks to join a world (``coordinator_address`` or
    ``num_processes``)."""
    return bool(getattr(tpu_cfg, "coordinator_address", None) or getattr(tpu_cfg, "num_processes", None))


def ranks_for_config(tpu_cfg, samples_per_step: int, device) -> int:
    """The ranks a trainer's config asks for when no world is given: the
    data × model mesh when the config asks for DP (``samples_per_step`` > 1),
    TP (``mesh_model`` > 1) or sequence parallelism; 1 otherwise. An unset
    ``mesh_data`` takes every local card (one rank on the CPU). The data axis
    follows :func:`training_mesh_from_config`'s rules (a divisor of the
    samples) but for sequence parallelism, whose ring spans it whole."""
    if active() or joins_world(tpu_cfg):
        return 1
    model = max(getattr(tpu_cfg, "mesh_model", 1), 1)
    data = getattr(tpu_cfg, "mesh_data", -1)
    if data in (-1, 0, None):
        cards = 0 if device_kind(device) == "cpu" else torch.cuda.device_count()
        data = max(cards // model, 1)
    sp = bool(getattr(tpu_cfg, "sequence_parallel", False))
    if data * model <= 1 or (samples_per_step <= 1 and model <= 1 and not sp):
        return 1
    if not sp:
        shape = _mesh_shape(tpu_cfg, samples_per_step, data * model)
        data = shape[0] if shape is not None else 1
    return data * model


def spawn_for_config(tpu_cfg, samples_per_step: int, device, fn: Callable, args: tuple) -> bool:
    """The trainer CLIs' launcher: when the config asks for more than one
    rank and no world is given, run ``fn(*args)`` in a spawned world of that
    many ranks and return True (the caller is done); else False."""
    n = ranks_for_config(tpu_cfg, samples_per_step, device)
    if n <= 1:
        return False
    print(f"[mesh] spawning {n} ranks on {device_kind(device)}", flush=True)
    spawn_world(fn, args, n, device=device_kind(device))
    return True


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass
class Mesh:
    """This rank's place in a (data, model) layout of ``ranks``: its
    coordinates and the groups of its row and column. ``shape`` is JAX's
    ``mesh.shape``. A rank outside ``ranks`` (a shrunk data axis) is not a
    ``member``: its coordinates and groups are None."""

    data: int
    model: int
    ranks: Tuple[int, ...]
    member: bool
    data_index: Optional[int] = None  # coordinate on the data axis
    model_index: Optional[int] = None
    data_group: Optional[object] = None  # the ranks that share this rank's model index
    model_group: Optional[object] = None  # the ranks that share this rank's data index
    data_ranks: Tuple[int, ...] = ()
    model_ranks: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        return self.data_ranks if axis == DATA_AXIS else self.model_ranks

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence[int]] = None) -> Mesh:
    """data=-1: all remaining ranks on the data axis. ``devices`` are the
    ranks to lay out (default: the whole world). Every rank of the world
    must call it, in the same order: it makes process groups."""
    devices = tuple(devices) if devices is not None else tuple(range(world_size()))
    n = len(devices)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    key = (data, model, devices)
    if key in _MESHES:
        return _MESHES[key]
    me = rank()
    grid = [list(devices[i * model:(i + 1) * model]) for i in range(data)]
    rows = [tuple(r) for r in grid]  # model groups: one per data index
    cols = [tuple(grid[i][j] for i in range(data)) for j in range(model)]  # data groups: one per model index
    mesh = Mesh(data, model, devices, me in devices)
    groups = {}
    if active():
        # new_group is collective over the world: every rank makes every group, in this order
        for g in rows + cols:
            groups[g] = dist.new_group(list(g)) if len(g) > 1 else None
    if mesh.member:
        i = devices.index(me)
        mesh.data_index, mesh.model_index = divmod(i, model)
        mesh.model_ranks, mesh.data_ranks = rows[mesh.data_index], cols[mesh.model_index]
        mesh.model_group, mesh.data_group = groups.get(mesh.model_ranks), groups.get(mesh.data_ranks)
    _MESHES[key] = mesh
    return mesh


def _mesh_shape(tpu_cfg, samples_per_step: int, n_devices: int) -> Optional[Tuple[int, int]]:
    """JAX's sizing rules over ``n_devices`` ranks: ``(data, model)``, or
    None for the single-device graph."""
    mesh_model = max(getattr(tpu_cfg, "mesh_model", 1), 1)
    if n_devices <= 1 or (samples_per_step <= 1 and mesh_model <= 1):
        return None
    if mesh_model > 1 and process_count() > 1:
        raise NotImplementedError(
            "multi-host tensor parallelism is not wired — shard the model "
            "axis within one host (mesh_model <= local devices)"
        )
    # the data axis shards samples_per_step rows, so it must divide them
    data = getattr(tpu_cfg, "mesh_data", -1)
    if data in (-1, 0, None):
        data = max(n_devices // mesh_model, 1)
        if samples_per_step % data:
            # auto-sizing only ever shrinks to a divisor; say so out loud
            data = math.gcd(samples_per_step, data)
            print(
                f"[mesh] tpu.samples_per_step={samples_per_step} is not divisible by "
                f"the {n_devices // mesh_model}-device data axis — using "
                f"mesh_data={data} (set tpu.mesh_data or raise samples_per_step to "
                "use every chip)"
            )
    elif samples_per_step % data:
        raise ValueError(
            f"tpu.samples_per_step={samples_per_step} must be divisible by "
            f"tpu.mesh_data={data} (each data-axis chip takes an equal share "
            "of the per-step samples)"
        )
    return data, mesh_model


def training_mesh_from_config(tpu_cfg, samples_per_step: int, device="cuda") -> Optional[Mesh]:
    """The trainers' mesh from the yaml ``tpu:`` block: join the world first
    when configured (coordinator_address / num_processes / process_id, on
    ``device``), then lay the (data, model) mesh over the world when it has
    more than one rank and the config asks for DP (samples_per_step > 1) or
    TP (mesh_model > 1). A single rank returns None — the one-device step."""
    if joins_world(tpu_cfg):
        init_distributed(tpu_cfg.coordinator_address, tpu_cfg.num_processes, tpu_cfg.process_id, device=device)
    shape = _mesh_shape(tpu_cfg, samples_per_step, world_size())
    if shape is None:
        return None
    data, model = shape
    if data > 1 and getattr(tpu_cfg, "sequence_parallel", False):
        # JAX: the ring is itself sharded over the data axis, so it cannot nest inside the sample sharding
        raise ValueError("tpu.sequence_parallel rings over the data axis that tpu.samples_per_step shards — "
                         "use one or the other per axis (samples_per_step: 1 with sequence_parallel)")
    # a shrunk data axis uses the first data*model ranks; the rest idle
    return make_mesh(data, model, devices=range(data * model))


def dp_size(mesh: Optional[Mesh]) -> int:
    return mesh.data if mesh is not None else 1


def data_share(items: Sequence, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``(lo, hi)``: this rank's equal share of ``items`` (or of a count)
    along the data axis; everything off-mesh."""
    n = items if isinstance(items, int) else len(items)
    d = dp_size(mesh)
    if n % d:
        raise ValueError(f"{n} rows do not split over a {d}-rank data axis")
    k = n // d
    i = mesh.data_index if mesh is not None else 0
    return i * k, (i + 1) * k


# ---------------------------------------------------------------------------
# collectives (staged through the host for CUDA tensors on gloo)
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as a 1-D view of its bytes: gloo moves every
    dtype so (it refuses bf16, and int16 in its collectives)."""
    return t.reshape(-1).view(torch.uint8)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (None: no-op)."""
    if group is None:
        return t
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather([_wire(p) for p in parts], _wire(src), group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def sum_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each gradient summed over ``group``, through one flat buffer."""
    if group is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_sum_(flat, group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return out


def data_mean(loss: torch.Tensor, grads: Sequence[torch.Tensor], mesh: Optional[Mesh]):
    """``(loss, grads)`` of this rank's share of the samples (each already
    divided by the whole step's sample count) summed over the data axis:
    the mean over every sample of the step, the same on every rank."""
    if mesh is None or mesh.data_group is None:
        return loss, list(grads)
    out = sum_grads([loss.reshape(1)] + list(grads), mesh.data_group)
    return out[0].reshape(()), out[1:]


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank of the world (pickled)."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_WORLD["device"] if _WORLD["backend"] == "nccl" else None)
    return box[0]


def gather_objects(obj, group=None) -> List:
    """Every rank's ``obj``, in rank order, on every rank."""
    if not active():
        return [obj]
    out = [None] * (dist.get_world_size(group) if group is not None else world_size())
    dist.all_gather_object(out, obj, group=group)
    return out


def ring_exchange(tensors: Sequence[torch.Tensor], ranks: Sequence[int], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the ring ``ranks`` and receive
    the previous rank's: one point-to-point hop (``batch_isend_irecv``). On
    a gloo group CUDA tensors travel through pinned host buffers."""
    me = rank()
    i = list(ranks).index(me)
    nxt, prv = ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]
    staged = bool(tensors) and _staged(tensors[0], group)
    send = [_to_host(t.contiguous()) if staged else t.contiguous() for t in tensors]
    recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged else torch.empty_like(t) for t in send]
    ops = []
    for s, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, _wire(s), nxt, group))
        ops.append(dist.P2POp(dist.irecv, _wire(r), prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device, non_blocking=True) if staged else r for r, t in zip(recv, tensors)]


class ScatterAlong(torch.autograd.Function):
    """Forward: this rank's slice of a tensor every rank of ``group`` holds
    alike; backward: the group's slices' gradients gathered (the gradient of
    the whole)."""

    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, index * (x.shape[dim] // n), x.shape[dim] // n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None, None, None


class GatherAlong(torch.autograd.Function):
    """Forward: the group's slices concatenated along ``dim``; backward:
    this rank's slice of the gradient (every rank computes the same
    downstream, so the gradient of the whole is the same on each)."""

    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None, None, None


class _Replicated(torch.autograd.Function):
    """Forward: the identity on an input every rank of ``group`` holds
    alike; backward: the ranks' gradients summed (each rank's shard of a
    tensor-parallel layer gives part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.group), None


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def replicate_host_tree(tree, mesh: Optional[Mesh]):
    """Every rank holds the same host values (one checkpoint, one seed), so
    the replicated tree is the tree itself."""
    return tree


def data_shard_host_tree(tree, mesh: Optional[Mesh]):
    """Dim 0 of every tensor of ``tree`` (a tensor, or a dict / list / tuple
    of them) cut to this rank's rows of the data axis."""
    if isinstance(tree, dict):
        return {k: data_shard_host_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(data_shard_host_tree(v, mesh) for v in tree)
    if isinstance(tree, torch.Tensor):
        lo, hi = data_share(tree.shape[0], mesh)
        return tree[lo:hi]
    return tree


def place_training_state(mesh: Optional[Mesh], base, lora_params, opt_state, bank, tp: bool = False):
    """The four training trees on the mesh: the frozen base replicates (or
    is tensor-sharded in place when ``tp``); adapter factors, optimizer
    state and the prompt bank replicate."""
    if tp and mesh is not None:
        tp_shard_tree(base, mesh)
    return base, lora_params, opt_state, bank


def _tp_kind(mod: nn.Module) -> Optional[str]:
    from sliders_conceptmod_tpu_torch.adapters.quant import QuantLinear

    if isinstance(mod, QuantLinear):
        return "quant"
    if type(mod) is nn.Linear:
        return "linear"
    if type(mod) is nn.Conv2d and mod.groups == 1:  # a grouped conv's output channels are tied to its inputs
        return "conv"
    return None


def _tp_forward(mod: nn.Module, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    tp = mod._tp
    group = _TP_GROUPS[tp["group"]]
    if torch.is_grad_enabled() and x.requires_grad:
        x = _Replicated.apply(x, group)
    y = type(mod).forward(mod, x, *args, **kwargs)
    dim = 1 if tp["kind"] == "conv" else y.dim() - 1
    return GatherAlong.apply(y, dim, tp["index"], tp["n"], group)


def tp_shard_tree(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Tensor-parallel placement, in place: every Linear / Conv2d / int8
    QuantLinear whose output dim the model axis divides keeps this rank's
    rows of its weight (codes and per-row scales for int8) and bias, and its
    forward all-gathers the output channels (differentiably; the input's
    gradient is summed over the axis). Every other tensor replicates. The
    forward equals the unsharded one. Adapter overlays hook the module and
    see its whole output; a merge (``adapters/lora.py``) gathers the weight,
    merges and keeps this rank's rows."""
    m, group = mesh.model, mesh.model_group
    if m <= 1:
        return module
    j = mesh.model_index
    _TP_GROUPS[id(group)] = group
    for mod in module.modules():
        kind = _tp_kind(mod)
        if kind is None or getattr(mod, "_tp", None) is not None:
            continue
        names = ("weight_q", "scale") if kind == "quant" else ("weight",)
        out = getattr(mod, names[0]).shape[0]
        if out % m:
            continue
        rows = slice(j * out // m, (j + 1) * out // m)
        for name in names + ("bias",):
            t = getattr(mod, name, None)
            if t is None:
                continue
            shard = t.detach()[rows].clone()
            if isinstance(t, nn.Parameter):
                setattr(mod, name, nn.Parameter(shard, requires_grad=t.requires_grad))
            else:
                setattr(mod, name, shard)
        mod._tp = {"kind": kind, "group": id(group), "index": j, "n": m, "rows": rows}
        mod.forward = types.MethodType(_tp_forward, mod)
    return module


def tp_full_weight(mod: nn.Module, weight: torch.Tensor) -> torch.Tensor:
    """The whole weight of a tensor-sharded module from each rank's rows
    (``weight`` itself for an unsharded module)."""
    tp = getattr(mod, "_tp", None)
    if tp is None:
        return weight
    with torch.no_grad():
        return all_gather_cat(weight.detach(), 0, _TP_GROUPS[tp["group"]])


def tp_rows(mod: nn.Module) -> Optional[slice]:
    tp = getattr(mod, "_tp", None)
    return None if tp is None else tp["rows"]
