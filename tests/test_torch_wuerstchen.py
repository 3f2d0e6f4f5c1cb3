"""The port's Würstchen scheduler and Stage-C ratio map
(``diffusion/wuerstchen.py``) against the JAX package's, on its CPU backend:

* ``set_timesteps`` bit-equal (T 4, 20, 50), ``alpha_cumprod`` within fp32;
* ``step`` fed JAX's noise within 2e-4, on a middle step and on the last
  (where the noise is dropped), and from a generator; ``add_noise`` at a
  scalar ratio and at one per row;
* ``get_t_conditioning`` bit-equal on the euler_a, ddim and ddpm schedules'
  timesteps at T 4, 20 and 50 and at the trainer's re-indexed train
  timestep, and over all 1000 train timesteps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.diffusion import wuerstchen as jw
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu_torch.diffusion import wuerstchen as tw
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = 2e-4
STEPS = [4, 20, 50]


@pytest.mark.parametrize("n", STEPS)
def test_set_timesteps_bit_equal(n):
    want = jw.WuerstchenScheduler().set_timesteps(n)
    got = tw.WuerstchenScheduler().set_timesteps(n)
    assert got.timesteps.dtype == np.float32 and got.num_inference_steps == n and got.init_noise_sigma == 1.0
    assert np.array_equal(got.timesteps, np.asarray(want.timesteps))
    assert tw.WuerstchenScheduler.scale_model_input(got, torch.ones(2), 0).equal(torch.ones(2))


def test_alpha_cumprod_matches_jax():
    t = np.concatenate([np.linspace(0, 1, 101), [0.0, 1.0]]).astype(np.float32)
    want = np.asarray(jw.WuerstchenScheduler().alpha_cumprod(jnp.asarray(t)))
    got = tw.WuerstchenScheduler().alpha_cumprod(t)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[-2] == np.float32(0.9999) and got[-1] == np.float32(1e-4)


@pytest.mark.parametrize("step_index", [0, 5, 19], ids=["first", "middle", "last"])
def test_step_matches_jax(step_index):
    rng = np.random.default_rng(step_index)
    x = rng.standard_normal((2, 16, 3, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 16, 3, 3)).astype(np.float32)
    key = jax.random.PRNGKey(step_index)
    js, ts = jw.WuerstchenScheduler(), tw.WuerstchenScheduler()
    want = np.asarray(js.step(js.set_timesteps(20), jnp.asarray(eps), step_index, jnp.asarray(x), key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    sched = ts.set_timesteps(20)
    got = ts.step(sched, torch.from_numpy(eps), step_index, torch.from_numpy(x), noise=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    drawn = ts.step(sched, torch.from_numpy(eps), step_index, torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(0))
    if step_index == 19:  # the previous ratio is 0: no noise, whatever was given
        assert torch.equal(drawn, got)
    else:
        assert not torch.equal(drawn, got)
    half = ts.step(sched, torch.from_numpy(eps).bfloat16(), step_index, torch.from_numpy(x).bfloat16(), noise=noise)
    assert half.dtype == torch.bfloat16


def test_add_noise_matches_jax():
    rng = np.random.default_rng(3)
    x0, noise = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32) for _ in range(2))
    js, ts = jw.WuerstchenScheduler(), tw.WuerstchenScheduler()
    for ratio in (np.float32(0.5), np.array([0.25, 0.9], np.float32)):
        want = np.asarray(js.add_noise(None, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ratio)))
        got = ts.add_noise(None, torch.from_numpy(x0), torch.from_numpy(noise), ratio)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n", STEPS)
@pytest.mark.parametrize("kind", ["euler_a", "ddim", "ddpm"])
def test_t_conditioning_bit_equal(kind, n):
    jsched, tsched = jscheduler(kind).set_timesteps(n), tscheduler(kind).set_timesteps(n)
    assert np.array_equal(np.asarray(tsched.timesteps), np.asarray(jsched.timesteps))
    acp = np.asarray(jsched.alphas_cumprod)
    assert np.array_equal(tsched.alphas_cumprod, acp)
    want = np.asarray(jw.get_t_conditioning(jsched.timesteps, jsched.alphas_cumprod))
    got = tw.get_t_conditioning(tsched.timesteps, tsched.alphas_cumprod)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    t_train = 999 - ((n - 1) * 1000 // n)  # the trainer's re-indexed train timestep
    assert np.array_equal(tw.get_t_conditioning(t_train, tsched.alphas_cumprod),
                          np.asarray(jw.get_t_conditioning(jnp.int32(t_train), jsched.alphas_cumprod)))


def test_t_conditioning_bit_equal_over_every_train_timestep():
    acp = tscheduler("ddpm").set_timesteps(20).alphas_cumprod
    want = np.asarray(jw.get_t_conditioning(jnp.arange(1000), jnp.asarray(acp)))
    assert np.array_equal(tw.get_t_conditioning(np.arange(1000), acp), want)
