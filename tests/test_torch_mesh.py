"""The port's mesh rules (``parallel/mesh.py``) against the JAX package's,
case by case (mirrors ``tests/test_mesh_dp.py::
test_training_mesh_from_config_validates_data_axis``): the same ``None``
cases, the same auto-sized data axis and printed note, the same errors and
messages, over the 8 devices conftest gives JAX and a world of 8 ranks the
port is told it has. Also: ``make_mesh``'s layout and errors, the ranks a
trainer's config spawns, this rank's rows, and the launcher: a spawned rank
that raises makes the caller raise."""

import types

import jax
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.parallel import mesh as jmesh
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
import _torch_mesh_workers as W
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

DEVICES = 8


def _cfg(**kw):
    base = dict(coordinator_address=None, num_processes=None, process_id=None, mesh_data=-1, mesh_model=1,
                sequence_parallel=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _outcome(fn, capsys):
    """(mesh shape or None, or the exception's type and message; the printed text)."""
    try:
        m = fn()
        got = None if m is None else dict(m.shape)
    except (ValueError, NotImplementedError) as e:
        got = (type(e), str(e))
    return got, capsys.readouterr().out


# (mesh_data, mesh_model, samples_per_step)
RULES = [
    (8, 1, 4),  # explicit mesh_data that does not divide samples_per_step: loud error
    (-1, 1, 4),  # auto: shrink to 4
    (-1, 1, 6),  # 6 samples on 8 devices: gcd -> 2, with the note
    (-1, 2, 1),  # pure TP: the data axis degrades to 1
    (2, 1, 8),  # a divisible request honoured exactly
    (-1, 1, 1),  # one sample and no TP: the one-device step
    (0, 4, 8),  # 0 is auto too
    (3, 1, 8),
]


@pytest.mark.parametrize("data,model,samples", RULES)
def test_training_mesh_rules_match_jax(monkeypatch, capsys, data, model, samples):
    cfg = _cfg(mesh_data=data, mesh_model=model)
    assert len(jax.devices()) == DEVICES
    want = _outcome(lambda: jmesh.training_mesh_from_config(cfg, samples), capsys)
    monkeypatch.setattr(tmesh, "world_size", lambda: DEVICES)
    got = _outcome(lambda: tmesh.training_mesh_from_config(cfg, samples, "cpu"), capsys)
    assert got == want


def test_multi_host_tensor_parallelism_is_refused_in_jax_words(monkeypatch, capsys):
    cfg = _cfg(mesh_model=2)
    monkeypatch.setattr(jmesh.jax, "process_count", lambda: 2)
    want = _outcome(lambda: jmesh.training_mesh_from_config(cfg, 4), capsys)
    monkeypatch.setattr(tmesh, "world_size", lambda: DEVICES)
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    got = _outcome(lambda: tmesh.training_mesh_from_config(cfg, 4, "cpu"), capsys)
    assert got == want and got[0][0] is NotImplementedError


@pytest.mark.parametrize("data,model", [(-1, 1), (2, 4), (4, 2), (3, 1), (-1, 3), (8, 1), (1, 8)])
def test_make_mesh_layout_and_errors_match_jax(data, model):
    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return str(e)

    want = outcome(lambda: jmesh.make_mesh(data, model))
    got = outcome(lambda: tmesh.make_mesh(data, model, devices=range(DEVICES)))
    if isinstance(want, str):
        assert got == want
        return
    assert got.shape == dict(want.shape)
    # rank r sits where JAX puts device r: row-major (data, model)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert tmesh.rank() == 0 and got.member and (got.data_index, got.model_index) == (0, 0)
    assert got.model_ranks == tuple(ids[0]) and got.data_ranks == tuple(ids[:, 0])


def test_ranks_a_trainer_config_spawns(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.ranks_for_config(_cfg(mesh_data=2), 4, "cpu") == 2
    assert tmesh.ranks_for_config(_cfg(mesh_data=2), 1, "cpu") == 1  # one sample, no TP: one rank
    assert tmesh.ranks_for_config(_cfg(mesh_data=2, mesh_model=2), 4, "cpu") == 4
    assert tmesh.ranks_for_config(_cfg(), 4, "cpu") == 1  # auto on the CPU: one rank
    assert tmesh.ranks_for_config(_cfg(), 4, "cuda") == 4  # auto on the card: every local card
    assert tmesh.ranks_for_config(_cfg(), 6, "cuda") == 2  # ... shrunk to a divisor, as the mesh is
    assert tmesh.ranks_for_config(_cfg(mesh_data=2, sequence_parallel=True), 1, "cpu") == 2  # the ring's ranks
    assert tmesh.ranks_for_config(_cfg(mesh_data=2, coordinator_address="h:1", num_processes=2), 4, "cpu") == 1
    with pytest.raises(ValueError, match="must be divisible by"):
        tmesh.ranks_for_config(_cfg(mesh_data=3), 4, "cpu")


def test_rows_and_placement_off_mesh_and_on_a_data_axis():
    x = torch.arange(12.0).reshape(6, 2)
    assert tmesh.data_share(6, None) == (0, 6)
    assert tmesh.data_shard_host_tree({"a": x}, None)["a"] is not None
    mesh = tmesh.make_mesh(3, 1, devices=range(3))  # this process is rank 0
    assert tmesh.data_share(6, mesh) == (0, 2)
    assert torch.equal(tmesh.data_shard_host_tree({"a": [x]}, mesh)["a"][0], x[:2])
    assert tmesh.replicate_host_tree(x, mesh) is x
    with pytest.raises(ValueError, match="do not split"):
        tmesh.data_share(4, mesh)


def test_a_failing_rank_fails_the_launcher(tmp_path):
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="rank 1 failed on purpose"):
        tmesh.spawn_world(W.fail, (str(tmp_path),), 2, device="cpu")
    assert not tmesh.active()  # the caller never joined the world


def test_collectives_move_every_dtype_in_a_gloo_world(tmp_path):
    """bf16 included (gloo takes it as bytes): gather in rank order, one hop
    round the ring, the sum, the broadcast object, the store barrier."""
    tmesh.spawn_world(W.collectives, (str(tmp_path),), 3, device="cpu")
    ranks = W.load(tmp_path, 3)
    for r, res in enumerate(ranks):
        for dtype in (torch.float32, torch.bfloat16, torch.int64):
            x = [(torch.arange(6).reshape(2, 3) + 10 * i).to(dtype) for i in range(3)]
            got = res[str(dtype)]
            assert got["gathered"].dtype == dtype and torch.equal(got["gathered"], torch.cat(x))
            assert torch.equal(got["passed"][0], x[(r - 1) % 3]) and torch.equal(got["passed"][1], x[(r - 1) % 3] + 1)
        assert torch.equal(res["summed"], torch.full((3,), 6.0))
        assert res["object"] == {"from": 0} and res["objects"] == [0, 2, 4] and res["backend"] == "gloo"



def test_dual_tree_warm_up_under_tensor_parallelism_is_refused_in_jax_words(tmp_path):
    """SD3's trainer refuses the dual-tree W8A8 warm-up with mesh_model > 1
    from the config alone, before any load, as JAX's does."""
    import os

    from sliders_conceptmod_tpu.cli import train_lora_sd3 as jcli
    from sliders_conceptmod_tpu.core import config as jconfig
    from sliders_conceptmod_tpu.core import prompts as jprompts
    from sliders_conceptmod_tpu_torch.cli import train_lora_sd3 as tcli
    from sliders_conceptmod_tpu_torch.core import config as tconfig
    from sliders_conceptmod_tpu_torch.core import prompts as tprompts
    from test_torch_sd3_esd import REPO, _tiny_yaml

    path = _tiny_yaml(tmp_path, w8a8_warmup=True, mesh_model=2)
    prompts = os.path.join(REPO, "data", "prompts-tiny.yaml")
    outcomes = []
    for train, config, load in ((jcli.train, jconfig, jprompts), (tcli.train, tconfig, tprompts)):
        with pytest.raises(NotImplementedError) as e:
            kw = {"device": "cpu"} if train is tcli.train else {}
            train(config.load_config_from_yaml(path), load.load_prompts_from_yaml(prompts, []), rank=2, **kw)
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1] and "not TP-sharded" in outcomes[1]


def test_sequence_parallel_refuses_a_sharded_sample_axis(monkeypatch):
    """The ring spans the data axis, so it cannot run inside the samples'
    sharding of the same axis (JAX's ring cannot nest in that shard_map)."""
    monkeypatch.setattr(tmesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="use one or the other per axis"):
        tmesh.training_mesh_from_config(_cfg(mesh_data=2, sequence_parallel=True), 2, "cpu")
    assert tmesh.training_mesh_from_config(_cfg(mesh_data=2, sequence_parallel=True), 1, "cpu") is None
