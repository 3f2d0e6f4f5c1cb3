"""The port's Stable Cascade ESD step against the JAX package's on the other
schedulers the trainer takes: the ratio-space ``wuerstchen`` scheduler (its
warm-up ratios are the schedule's own) on every route — the merged student,
the overlay student, DoRA, the dual-tree W8A8 warm-up — and the beta
schedulers ddpm (ancestral noise, no branch scaling) and ddim (no noise),
whose ratios come from ``get_t_conditioning``. Two steps on the tiny prior,
fp32, within 2e-4 (``tests/_cascade_assets.py::check_two_steps``; euler_a is
``tests/test_torch_cascade_esd.py``)."""

import pytest

from _cascade_assets import check_two_steps
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.mark.parametrize("route,remat", [("merged", False), ("overlay", True), ("dora", True), ("w8a8", False)])
def test_cascade_esd_steps_match_jax_wuerstchen(route, remat):
    check_two_steps("wuerstchen", route, remat=remat)


@pytest.mark.parametrize("sched_name", ["ddpm", "ddim"])
def test_cascade_esd_steps_match_jax_beta_schedulers(sched_name):
    check_two_steps(sched_name, "merged")
