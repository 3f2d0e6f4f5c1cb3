"""Data-parallel ESD steps of Flux (batch 2: 8 rows, one micro-step per
optimizer step) and Stable Cascade (``share_warmup``, on its default merged
student) in a 2-rank gloo world on the CPU, against the JAX package's
sharded steps and the port's one-process steps on the same draws;
``tests/test_torch_family_dp.py`` holds the cases and the bounds."""

import pytest

from test_torch_family_dp import _cascade, _flux, check_case, run_world
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

FAMILIES = {"flux": _flux, "cascade_share": _cascade}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(FAMILIES, tmp_path_factory.mktemp("family_dp"))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_dp_matches_the_jax_sharded_step_and_one_process(world, name):
    check_case(world, name)
