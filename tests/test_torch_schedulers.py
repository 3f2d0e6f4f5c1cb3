"""The port's NoiseScheduler against the JAX package's (every kind, ε and v,
with the stochastic kinds fed the same injected noise) and against the
framework-neutral float64 goldens of tests/golden/scheduler_trajectories.npz."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.diffusion import schedulers as jsched
from sliders_conceptmod_tpu_torch.diffusion import schedulers as tsched
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "scheduler_trajectories.npz")
KINDS = ["ddim", "ddpm", "lms", "euler_a"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_tables_and_steps_match_jax(kind, pred):
    n = 12
    js = jsched.create_noise_scheduler(kind, prediction_type=pred)
    ts = tsched.create_noise_scheduler(kind, prediction_type=pred)
    jsch, tsch = js.set_timesteps(n), ts.set_timesteps(n)
    for field in ("timesteps", "alpha_prod", "alpha_prod_prev", "sigmas", "sigma_up", "sigma_down", "lms_coeffs"):
        np.testing.assert_array_equal(getattr(tsch, field), np.asarray(getattr(jsch, field)), err_msg=field)
    assert tsch.init_noise_sigma == jsch.init_noise_sigma

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 8, 8)) * tsch.init_noise_sigma).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate = js.init_step_state(x.shape)
    tstate = ts.init_step_state(x.shape)
    key = jax.random.PRNGKey(3)
    for i in range(n):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        np.testing.assert_allclose(
            ts.scale_model_input(tsch, tx, i).numpy(), np.asarray(js.scale_model_input(jsch, jx, i)),
            rtol=1e-6, atol=1e-6,
        )
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(sub, x.shape, jnp.float32))  # the JAX step's own draw
        jx, jstate = js.step(jsch, jnp.asarray(eps), i, jx, jstate, key=sub)
        tx, tstate = ts.step(tsch, torch.from_numpy(eps), i, tx, tstate, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5, err_msg=f"{kind} step {i}")
        # continue both from the same state so rounding does not accumulate
        tx = torch.from_numpy(np.asarray(jx).copy())
        tstate = tsched.StepState(torch.from_numpy(np.asarray(jstate.derivatives).copy()))


@pytest.mark.parametrize("kind", KINDS)
def test_add_noise_and_velocity_match_jax(kind):
    js, ts = jsched.create_noise_scheduler(kind), tsched.create_noise_scheduler(kind)
    jsch, tsch = js.set_timesteps(25), ts.set_timesteps(25)
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(2))
    for t in (0, 37, 500, 999):
        np.testing.assert_allclose(
            ts.add_noise(tsch, torch.from_numpy(x0), torch.from_numpy(noise), t).numpy(),
            np.asarray(js.add_noise(jsch, jnp.asarray(x0), jnp.asarray(noise), t)),
            rtol=1e-6, atol=1e-6,
        )
        np.testing.assert_allclose(
            ts.get_velocity(tsch, torch.from_numpy(x0), torch.from_numpy(noise), t).numpy(),
            np.asarray(js.get_velocity(jsch, jnp.asarray(x0), jnp.asarray(noise), t)),
            rtol=1e-6, atol=1e-6,
        )
        np.testing.assert_allclose(
            ts.scale_model_input_train_t(tsch, torch.from_numpy(x0), t).numpy(),
            np.asarray(js.scale_model_input_train_t(jsch, jnp.asarray(x0), t)),
            rtol=1e-6, atol=1e-6,
        )
    rows = np.asarray([3, 400, 999])
    x = np.tile(x0, (3, 1, 1, 1))
    np.testing.assert_allclose(  # per-row train timesteps
        ts.scale_model_input_train_t(tsch, torch.from_numpy(x), torch.from_numpy(rows)).numpy(),
        np.asarray(js.scale_model_input_train_t(jsch, jnp.asarray(x), jnp.asarray(rows))),
        rtol=1e-6, atol=1e-6,
    )


GOLDEN_CONFIGS = [
    ("ddim50_eps", "ddim", 50, "epsilon", False),
    ("ddim50_v", "ddim", 50, "v_prediction", False),
    ("ddpm50_eps", "ddpm", 50, "epsilon", True),
    ("lms50_eps", "lms", 50, "epsilon", False),
    ("euler_a50_eps", "euler_a", 50, "epsilon", True),
    ("euler_a12_eps", "euler_a", 12, "epsilon", True),
]


@pytest.mark.parametrize("name,kind,n,pred,stochastic", GOLDEN_CONFIGS)
def test_steps_match_golden(name, kind, n, pred, stochastic):
    """Each step from the golden state, as tests/test_scheduler_golden.py does;
    the stochastic goldens were drawn with jax.random keys fold_in(PRNGKey(7), i),
    so those draws are injected."""
    golden = np.load(GOLDEN)
    ts = tsched.create_noise_scheduler(kind, prediction_type=pred)
    sch = ts.set_timesteps(n)
    np.testing.assert_allclose(np.asarray(sch.timesteps, np.float64), golden[f"{name}_timesteps"], rtol=0, atol=1e-3)
    traj, eps_seq = golden[f"{name}_traj"], golden[f"{name}_eps_seq"]
    np.testing.assert_allclose(sch.init_noise_sigma * golden["x0"], traj[0], rtol=1e-6, atol=1e-6)
    state = ts.init_step_state(traj.shape[1:])
    for i in range(n):
        noise = None
        if stochastic:
            key = jax.random.fold_in(jax.random.PRNGKey(7), i)
            noise = torch.from_numpy(np.array(jax.random.normal(key, traj.shape[1:], jnp.float32)))
        out, state = ts.step(sch, torch.from_numpy(eps_seq[i]), i, torch.from_numpy(traj[i]), state, noise=noise)
        np.testing.assert_allclose(out.numpy(), traj[i + 1], rtol=1e-5, atol=1e-5, err_msg=f"{name} step {i}")


def test_per_row_generators_make_rows_independent():
    """A list of per-row generators: a row's noise depends only on its own
    generator, not on the rows batched with it."""
    ts = tsched.create_noise_scheduler("euler_a")
    sch = ts.set_timesteps(4)
    x = torch.zeros((2, 4, 8, 8))
    eps = torch.zeros_like(x)
    duo, _ = ts.step(sch, eps, 0, x, generator=[torch.Generator().manual_seed(7), torch.Generator().manual_seed(9)])
    solo9, _ = ts.step(sch, eps[:1], 0, x[:1], generator=[torch.Generator().manual_seed(9)])
    torch.testing.assert_close(duo[1:], solo9, rtol=0, atol=0)
    assert (duo[0] - duo[1]).abs().max() > 1e-2
    with pytest.raises(ValueError):
        ts.step(sch, eps, 0, x, generator=[torch.Generator()])
