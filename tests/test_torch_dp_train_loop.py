"""Data-parallel ESD steps of the port on the one-sample loop (tiny-xl,
batch 2, ``samples_per_step`` 4 over a 2-rank gloo world) against the JAX
package's sharded step and the port's one-process step on the same draws;
``tests/test_torch_dp_train.py`` holds the cases and the bounds."""

import pytest

from test_torch_dp_train import check_case, run_world
from test_torch_train import slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

HERE = ("loop_batch_two",)


@pytest.fixture(scope="module")
def world(slice_setup, tmp_path_factory):
    return run_world(slice_setup, tmp_path_factory.mktemp("dp"), HERE)


@pytest.mark.parametrize("name", HERE)
def test_dp_steps_match_the_jax_sharded_step_and_one_process(slice_setup, world, name):
    check_case(slice_setup, world, name)
