"""The port's ``share_warmup``, ``fuse_teacher_student``, ``pipeline_warmup``
and checkpointed student (``train/esd.py``) against the JAX package's, on tiny-xl (64px,
Euler-A, ``max_denoising_steps`` 3, fp32) with JAX's draws
(``tests/test_torch_esd_knobs.py`` holds the helpers and the other knobs):

* ``share_warmup`` (2 samples), ``fuse_teacher_student`` (2 steps) and ``pipeline_warmup`` (3 steps with
  the carry, with ``dynamic_crops``): loss, grad norm and every factor
  within 2e-4, and the pipelined carry.
"""

import jax
import numpy as np

from test_torch_esd_knobs import Pair, _fused_draws, _sample_draws
from test_torch_train import STEP_TOL, slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


def test_share_warmup_matches_jax(slice_setup):
    """One batch-1 chain with a snapshot at each sample's tₖ; one pair per
    step (sample 0's)."""
    pair = Pair(slice_setup, samples_per_step=2, share_warmup=True)
    pair.run(lambda key, sch: _fused_draws(key, sch, 2, 2, share=True), seeds=(11, 12))


def test_fuse_teacher_student_matches_jax(slice_setup):
    pair = Pair(slice_setup, fuse_teacher_student=True)
    pair.run(lambda key, sch: _sample_draws(key, sch, 2))


def test_pipeline_warmup_with_crops_matches_jax(slice_setup):
    """Three pipelined steps: step k trains on the carry drawn by step k−1
    and draws step k+1's warm-up from the factors before its update."""
    pair = Pair(slice_setup, pipeline_warmup=True, dynamic_crops=True)
    k_carry = jax.random.PRNGKey(5)
    carry = pair.jstep.init_carry(pair.params, pair.lp, k_carry, pair.jbank)
    pair.tstep.init_carry(pair.tbank, draws=_sample_draws(k_carry, pair.schedule, 2, crops=True))
    for i, seed in enumerate((11, 12, 13)):
        key = jax.random.PRNGKey(seed)
        pair.lp, pair.jstate, jm, carry = pair.jstep(pair.params, pair.lp, pair.jstate, key, pair.jbank, carry)
        tm = pair.tstep(pair.tstate, pair.tbank, draws=_sample_draws(key, pair.schedule, 2, crops=True))
        pair.check(jm, tm, i)
        np.testing.assert_allclose(pair.tstep.carry.denoised.numpy(), np.asarray(carry["denoised"]), atol=STEP_TOL,
                                   rtol=0, err_msg=f"step {i}: the next carry")
        assert pair.tstep.carry.current_t == int(carry["current_t"])
        np.testing.assert_array_equal(pair.tstep.carry.time_ids.numpy(), np.asarray(carry["time_ids"]))
    assert pair.moved() > 5e-3
