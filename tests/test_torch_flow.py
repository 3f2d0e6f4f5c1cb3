"""The port's flow-matching scheduler and SD3 sampler against the JAX package's.

* ``FlowMatchScheduler.set_timesteps`` bit-equal for n ∈ {1, 2, 28, 50}
  (and the dynamic-shift variant at one μ);
* ``step`` and ``add_noise`` in fp32 and bf16 bit-equal, the result in the
  sample's dtype;
* ``flip_step_for_start_noise`` at the edges (0, mid, n);
* ``sample_flow_loop`` over the tiny MMDiT against JAX: CFG, cond-only
  (embeddings of the latents' batch), a guidance ≤ 1, and the flip at 0,
  mid and n, with merged weights after the flip and with the overlay;
  latents within 1e-3 (the bound of tests/test_torch_serve.py);
* ``sd3_latents_to_images`` through a tiny 16-channel VAE without quant
  convs (``shift_factor`` 0.0609) against JAX's, images within 1 of 255.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion import flow_match as jflow
from sliders_conceptmod_tpu.infer import generate_flow as jgen
from sliders_conceptmod_tpu.models import vae as jvae
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.infer import generate_flow as tgen
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import vae as tvae
from _sd3_assets import LATENT_TOL, random_mmdit
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.mark.parametrize("n", [1, 2, 28, 50])
def test_set_timesteps_bit_equal(n):
    j = jflow.FlowMatchScheduler(shift=3.0).set_timesteps(n)
    t = tflow.FlowMatchScheduler(shift=3.0).set_timesteps(n)
    assert t.num_inference_steps == n and j.init_noise_sigma == 1.0
    assert t.timesteps.dtype == torch.float32 and t.sigmas.shape == (n + 1,)
    assert np.array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    assert np.array_equal(t.sigmas.numpy(), np.asarray(j.sigmas))
    mu = jflow.calculate_shift(4096)
    assert tflow.calculate_shift(4096) == mu
    jd = jflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(n, mu=mu)
    td = tflow.FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(n, mu=mu)
    assert np.array_equal(td.sigmas.numpy(), np.asarray(jd.sigmas))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_and_add_noise_bit_equal(dtype):
    j = jflow.FlowMatchScheduler().set_timesteps(28)
    t = tflow.FlowMatchScheduler().set_timesteps(28)
    r = np.random.default_rng(0)
    x, v = (r.standard_normal((2, 16, 4, 4)).astype(np.float32) for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xt, vt = torch.from_numpy(x).to(td), torch.from_numpy(v).to(td)
    for i in (0, 13, 27):
        want = jflow.FlowMatchScheduler.step(j, jnp.asarray(v, jd), i, jnp.asarray(x, jd))
        got = tflow.FlowMatchScheduler.step(t, vt, i, xt)
        assert got.dtype == td
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32)), i
        want = jflow.FlowMatchScheduler.add_noise(j, jnp.asarray(x, jd), jnp.asarray(v, jd), i)
        got = tflow.FlowMatchScheduler.add_noise(t, xt, vt, i)
        assert got.dtype == td
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32)), i


@pytest.mark.parametrize("start_noise", [-1.0, 0.0, 500.0, 750.0, 999.0, 1000.0, 1100.0])
@pytest.mark.parametrize("n", [1, 4, 28])
def test_flip_step_matches_jax(n, start_noise):
    j = jflow.FlowMatchScheduler().set_timesteps(n)
    t = tflow.FlowMatchScheduler().set_timesteps(n)
    assert tgen.flip_step_for_start_noise(t, start_noise) == jgen.flip_step_for_start_noise(j, start_noise)


def _slider(params, port, seed=3):
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    r = np.random.default_rng(seed)
    lp = jax.tree.map(lambda a: jnp.asarray(0.3 * r.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(0), jsites))
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    return jsites, lp, tsites, tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, lp), tsites)


# (CFG rows, guidance, flip step, slider route)
CASES = [(True, 7.0, 2, "merged"), (True, 7.0, 0, "overlay"), (True, 7.0, 4, "merged"), (False, 7.0, 2, "merged"),
         (True, 1.0, 2, "merged"), (True, 0.5, 0, "overlay")]


@pytest.mark.parametrize("cfg_rows,guidance,flip,route", CASES)
def test_sample_flow_loop_matches_jax(cfg_rows, guidance, flip, route):
    model, params, port = random_mmdit()
    jsites, lp, tsites, tlp = _slider(params, port)
    n, b = 4, 2
    js = jflow.FlowMatchScheduler().set_timesteps(n)
    ts = tflow.FlowMatchScheduler().set_timesteps(n)
    r = np.random.default_rng(7)
    lat = r.standard_normal((b, 16, 8, 8)).astype(np.float32)
    rows = 2 * b if cfg_rows else b
    text = (0.5 * r.standard_normal((rows, 12, 32))).astype(np.float32)
    pooled = r.standard_normal((rows, 32)).astype(np.float32)

    def apply(p, *a):
        return model.apply({"params": p}, *a)

    if route == "merged":
        want = jgen.sample_flow_loop(apply, params, jlora.merge_lora_params(params, jsites, lp, 1.5), flip, js,
                                     jnp.asarray(lat), jnp.asarray(text), jnp.asarray(pooled), guidance_scale=guidance)
        got = tgen.sample_flow_loop(port, flip, ts, torch.from_numpy(lat), torch.from_numpy(text),
                                    torch.from_numpy(pooled), guidance_scale=guidance,
                                    merged=tlora.merge_lora_params(port, tsites, tlp, 1.5))
    else:
        scale = jnp.asarray([1.5], jnp.float32)
        want = jgen.sample_flow_loop(apply, params, params, flip, js, jnp.asarray(lat), jnp.asarray(text),
                                     jnp.asarray(pooled), guidance_scale=guidance,
                                     slider_overlay=lambda: jlora.lora_overlay(jsites, lp, scale))
        got = tgen.sample_flow_loop(port, flip, ts, torch.from_numpy(lat), torch.from_numpy(text),
                                    torch.from_numpy(pooled), guidance_scale=guidance,
                                    overlay=tlora.LoRAOverlay(port, tsites, tlp), row_scale=torch.tensor([1.5]))
    assert got.shape == lat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LATENT_TOL, rtol=0)
    if flip < n:  # the slider moved the result
        plain = tgen.sample_flow_loop(port, n, ts, torch.from_numpy(lat), torch.from_numpy(text),
                                      torch.from_numpy(pooled), guidance_scale=guidance)
        assert (plain - got).abs().max() > 1e-3


def test_tensor_guidance_keeps_cfg():
    """A tensor guidance (serving's) runs CFG even at 1: u + 1·(c − u) = c up to rounding."""
    _, _, port = random_mmdit()
    ts = tflow.FlowMatchScheduler().set_timesteps(2)
    r = np.random.default_rng(1)
    lat = torch.from_numpy(r.standard_normal((1, 16, 8, 8)).astype(np.float32))
    text = torch.from_numpy(r.standard_normal((2, 12, 32)).astype(np.float32))
    pooled = torch.from_numpy(r.standard_normal((2, 32)).astype(np.float32))
    a = tgen.sample_flow_loop(port, 2, ts, lat, text, pooled, guidance_scale=torch.tensor(1.0))
    b = tgen.sample_flow_loop(port, 2, ts, lat, text, pooled, guidance_scale=1.0)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_sd3_latents_to_images_matches_jax():
    jcfg = dataclasses.replace(jvae.VAEConfig.sd3(), block_out_channels=(16, 32), layers_per_block=1,
                               norm_num_groups=4)
    tcfg = dataclasses.replace(tvae.VAEConfig.sd3(), block_out_channels=(16, 32), layers_per_block=1,
                               norm_num_groups=4)
    assert dataclasses.asdict(tvae.VAEConfig.sd3()) == dataclasses.asdict(jvae.VAEConfig.sd3())
    jmodel = jvae.AutoencoderKL(jcfg)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 16, 16)))["params"]
    assert "quant_conv" not in params and "post_quant_conv" not in params
    port = tvae.AutoencoderKL(tcfg)
    assert port.quant_conv is None and port.post_quant_conv is None
    unused = load_jax_params(port, to_numpy_tree(params))
    assert unused == []
    lat = np.random.default_rng(4).standard_normal((2, 16, 8, 8)).astype(np.float32)
    want = jgen.sd3_latents_to_images(lambda z: jmodel.apply({"params": params}, z, method=jmodel.decode),
                                      jnp.asarray(lat))
    got = tgen.sd3_latents_to_images(port.decode, torch.from_numpy(lat))
    assert got.shape == want.shape == (2, 16, 16, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    mean, logvar = port.encode(torch.zeros(1, 3, 16, 16))  # no quant_conv: conv_out's 2·16 moments
    assert mean.shape == logvar.shape == (1, 16, 8, 8)
