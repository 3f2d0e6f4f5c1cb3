"""The trainers on a mesh (``train/trainer.py`` and the family CLIs with
``parallel/mesh.py``), on the CPU, against one process; fp32 within 2e-4:

* tiny-xl ESD, ``samples_per_step`` 4 over ``mesh_data`` 2 (gloo ranks
  spawned by the test): the losses and factors of the one-process run;
  rank 0 alone writes the metrics and the saves; resumed from the
  checkpoint of step 2 in a new world, the run ends where the
  uninterrupted one does (mirrors ``__graft_entry__.py``'s resume check);
* the tiny SD family (DDIM) the same way;
* the yaml world (mirrors ``tests/test_multiprocess.py::
  test_two_process_trainer_matches_single_process``): two separate
  processes of ``cli/train_lora_xl.py`` joined through
  ``tpu.coordinator_address`` / ``num_processes`` / ``process_id`` save the
  slider the single-process CLI saves;
* the Stable Cascade CLI with ``mesh_data: 2`` in its yaml spawns its own
  two ranks and saves the one-process slider.

Every spawned rank runs port code only (``tests/_torch_mesh_workers.py`` or
a CLI module); none imports JAX."""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import _torch_mesh_workers as W
from sliders_conceptmod_tpu_torch.cli import train_lora_cascade as tcascade_cli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.parallel import mesh as tmesh
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-4
RANKS = 2


def _config(yaml_name: str, path, iterations=4, per_steps=2, **tpu):
    cfg = tconfig.load_config_from_yaml(str(REPO / "data" / yaml_name))
    cfg.prompts_file = str(REPO / cfg.prompts_file)
    cfg.save.path = str(path)
    cfg.save.per_steps = per_steps
    cfg.train.iterations = iterations
    cfg.logging.verbose = False
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def _assert_factors(got, want):
    for n in want:
        for k in want[n]:
            np.testing.assert_allclose(got[n][k].detach().numpy(), want[n][k].detach().numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{n}.{k}")


def _world_train(out, cfg, prompts, **kwargs):
    os.makedirs(out, exist_ok=True)
    tmesh.spawn_world(W.train, (str(out), "sliders_conceptmod_tpu_torch.train.trainer", cfg, prompts,
                                dict(rank=2, device="cpu", **kwargs)), RANKS, device="cpu")
    return W.load(out, RANKS)


def test_xl_trainer_on_a_data_axis_matches_one_process_and_resumes(tmp_path):
    prompts = tprompts.load_prompts_from_yaml(str(REPO / "data" / "prompts-tiny.yaml"))
    one = ttrainer.train(_config("config-tiny-xl.yaml", tmp_path / "one", samples_per_step=4), prompts, rank=2,
                         device="cpu")
    ranks = _world_train(tmp_path / "out", _config("config-tiny-xl.yaml", tmp_path / "world", samples_per_step=4,
                                                   mesh_data=RANKS), prompts)
    for r in ranks:
        assert not r["jax_loaded"] and r["backend"] == "gloo"
        np.testing.assert_allclose(r["losses"], one.losses, rtol=TOL, atol=1e-7)
        assert [row["timesteps_to"] for row in r["rows"]] == [row["timesteps_to"] for row in one.metrics]
        _assert_factors(r["factors"], one.lora_params)
    # rank 0 alone wrote: one metrics row per step, the periodic save and its resume checkpoint, the last save
    assert sorted(os.listdir(tmp_path / "world")) == sorted(os.listdir(tmp_path / "one"))
    rows = (tmp_path / "world" / "tinyxl_slider_metrics.jsonl").read_text().splitlines()
    assert len(rows) == 5  # 4 steps and the steps/s line
    # a new world resumed from step 2's checkpoint ends where the uninterrupted run does
    resumed = _world_train(tmp_path / "out_resumed", _config("config-tiny-xl.yaml", tmp_path / "world",
                                                             samples_per_step=4, mesh_data=RANKS),
                           prompts, resume_from=str(tmp_path / "world"), save_file=False)
    for r in resumed:
        np.testing.assert_allclose(r["losses"], one.losses[3:], rtol=TOL, atol=1e-7)
        _assert_factors(r["factors"], one.lora_params)


def test_sd_trainer_on_a_data_axis_matches_one_process(tmp_path):
    prompts = tprompts.load_prompts_from_yaml(str(REPO / "data" / "prompts-tiny.yaml"))
    kw = dict(iterations=2, samples_per_step=4)
    one = ttrainer.train(_config("config-tiny.yaml", tmp_path / "one", **kw), prompts, rank=2, device="cpu",
                         save_file=False)
    ranks = _world_train(tmp_path / "out", _config("config-tiny.yaml", tmp_path / "world", mesh_data=RANKS, **kw),
                         prompts, save_file=False)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one.losses, rtol=TOL, atol=1e-7)
        _assert_factors(r["factors"], one.lora_params)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _yaml(path: Path, save: Path, extra: str = "", base: str = "config-tiny-xl.yaml") -> Path:
    text = (REPO / "data" / base).read_text()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{REPO / "data" / "prompts-tiny.yaml"}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{save}"').replace("verbose: true", "verbose: false")
    text = text.replace("iterations: 4", "iterations: 2")
    path.write_text(text + "  samples_per_step: 4\n" + extra)
    return path


def _cli(module: str, config: Path, **kw) -> subprocess.Popen:
    # three processes share this worker's share of the cores
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": str(max(1, torch.get_num_threads() // 3))}
    return subprocess.Popen([sys.executable, "-m", module, "--config_file", str(config), "--alpha", "1", "--rank", "2",
                             "--device", "cpu"], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


def _slider(root: Path, suffix: str) -> dict:
    (path,) = root.rglob(f"*_last{suffix}")
    if suffix == ".pt":
        return {k: v.numpy() for k, v in torch.load(path).items()}
    return {k: v.numpy() for k, v in tst.load_file(str(path)).items()}


def test_yaml_world_of_two_processes_trains_the_single_process_slider(tmp_path):
    module = "sliders_conceptmod_tpu_torch.cli.train_lora_xl"
    single = _cli(module, _yaml(tmp_path / "single.yaml", tmp_path / "single"))
    port = _free_port()
    procs = [_cli(module, _yaml(tmp_path / f"rank{r}.yaml", tmp_path / "world",
                                f'  coordinator_address: "localhost:{port}"\n  num_processes: 2\n  process_id: {r}\n'))
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in [single] + procs]
    finally:
        for p in [single] + procs:
            p.kill()
    assert [p.returncode for p in [single] + procs] == [0, 0, 0], "\n".join(logs)[-4000:]
    assert "backend gloo" in logs[1] and "rank 1/2" in logs[2]
    want, got = _slider(tmp_path / "single", ".safetensors"), _slider(tmp_path / "world", ".safetensors")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)


def test_cascade_cli_spawns_its_data_axis_and_trains_the_one_process_slider(tmp_path):
    """``mesh_data: 2`` in the yaml: the CLI spawns two gloo ranks itself, as
    JAX's CLI takes the mesh from the same yaml."""
    base = "config-tiny-cascade.yaml"
    one, two = _yaml(tmp_path / "one.yaml", tmp_path / "one", base=base), _yaml(
        tmp_path / "two.yaml", tmp_path / "two", "  mesh_data: 2\n", base=base)
    for cfg in (one, two):
        args = tcascade_cli.build_parser().parse_args(["--config_file", str(cfg), "--alpha", "1", "--rank", "2",
                                                       "--device", "cpu"])
        tcascade_cli.main(copy.deepcopy(args))
    want, got = _slider(tmp_path / "one", ".pt"), _slider(tmp_path / "two", ".pt")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
