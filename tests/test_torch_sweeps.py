"""The sweep's building blocks in the port against the JAX package, fp32 on
the CPU: ``adapters/lora.py::merge_lora_params`` (Linear and conv sites,
``train_method`` full) and ``infer/generate.py::sample_loop`` (the two-phase
trajectory, the flip mid-way, under DDIM and LMS, ε and v-prediction).

The sampler bound is 2e-4 of the trajectory's largest magnitude, and never
below 2e-4: LMS latents start at σ_max ≈ 14.6 times a unit normal, and a
random tiny UNet does not shrink them in four steps (|x| reaches ~30)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jcreate
from sliders_conceptmod_tpu.infer import generate as jgen
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion import schedulers as tsched
from sliders_conceptmod_tpu_torch.infer import generate as tgen
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CONV = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV


def sampler_tol(want) -> float:
    return 2e-4 * max(1.0, float(np.abs(np.asarray(want)).max()))


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny UNet, the port's with the same weights, and one full
    slider (Linear and conv sites) with non-zero factors in both."""
    _, _, junet, _ = jfactory.load_models("tiny")
    unet = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny())
    assert load_jax_params(unet, to_numpy_tree(junet.params)) == []
    unet.eval().requires_grad_(False)
    jsites = jlora.create_sites(junet.params, rank=2, alpha=1.0, target_replace=CONV, train_method="full")
    rng = np.random.default_rng(3)
    jlp = jax.tree.map(lambda a: jnp.asarray(0.2 * rng.standard_normal(a.shape), jnp.float32),
                       jlora.init_lora_params(jax.random.PRNGKey(3), jsites))
    tsites = tlora.create_sites(unet, rank=2, alpha=1.0, target_replace=CONV, train_method="full")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]
    assert {s.kind for s in tsites} == {"dense", "conv"}
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    return junet, unet, jsites, jlp, tsites, tlp


@pytest.mark.parametrize("multiplier", [-2.0, 0.5])
def test_merge_lora_params_matches_jax(tiny, multiplier):
    junet, unet, jsites, jlp, tsites, tlp = tiny
    merged = tlora.merge_lora_params(unet, tsites, tlp, multiplier)
    assert len(merged) == len(tsites)  # the site weights only
    want_module = tunet.UNet2DConditionModel(unet.config)
    load_jax_params(want_module, to_numpy_tree(jlora.merge_lora_params(junet.params, jsites, jlp, multiplier)))
    want = want_module.state_dict()
    for name, w in merged.items():
        np.testing.assert_allclose(w.numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
        assert w.dtype == unet.get_parameter(name).dtype
    for name, p in unet.named_parameters():  # the model itself is untouched
        if name not in merged:
            assert torch.equal(p, want[name]), name
    ref = dict(unet.named_parameters())
    assert all(not torch.equal(merged[n], ref[n]) for n in merged)


def test_merge_refuses_integer_weights(tiny):
    _, unet, _, _, tsites, tlp = tiny
    site = tsites[0]
    lin = torch.nn.Linear(site.in_dim, site.out_dim)
    lin.weight = torch.nn.Parameter(torch.zeros_like(lin.weight, dtype=torch.int8), requires_grad=False)
    holder = torch.nn.Module()
    holder.add_module(site.module_path[0], lin)
    one = tlora.LoRASite((site.module_path[0],), site.lora_name, "dense", site.rank, site.alpha, site.in_dim,
                         site.out_dim)
    with pytest.raises(ValueError, match="integer"):
        tlora.merge_lora_params(holder, [one], tlp, 1.0)


@pytest.mark.parametrize("kind,prediction", [("ddim", "epsilon"), ("ddim", "v_prediction"), ("lms", "epsilon"),
                                             ("lms", "v_prediction")])
def test_sample_loop_matches_jax(tiny, kind, prediction):
    junet, unet, jsites, jlp, tsites, tlp = tiny
    n, flip, scale = 4, 2, 1.5  # the flip mid-trajectory: 2 base steps, 2 merged
    jsched, tsch = jcreate(kind, prediction_type=prediction), tsched.create_noise_scheduler(kind, prediction)
    jschedule, tschedule = jsched.set_timesteps(n), tsch.set_timesteps(n)
    rng = np.random.default_rng(7)
    latents = (rng.standard_normal((2, 4, 8, 8)) * tschedule.init_noise_sigma).astype(np.float32)
    emb = rng.standard_normal((4, 77, 32)).astype(np.float32)
    want = jgen.sample_loop(
        junet.apply_fn(), junet.params, jlora.merge_lora_params(junet.params, jsites, jlp, scale), flip, jsched,
        jschedule, jnp.asarray(latents), jnp.asarray(emb), jax.random.PRNGKey(0), guidance_scale=7.5,
    )
    merged = tlora.merge_lora_params(unet, tsites, tlp, scale)
    got = tgen.sample_loop(unet, merged, flip, tsch, tschedule, torch.from_numpy(latents), torch.from_numpy(emb),
                           guidance_scale=7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=sampler_tol(want), rtol=0)
    base = tgen.sample_loop(unet, None, flip, tsch, tschedule, torch.from_numpy(latents), torch.from_numpy(emb),
                            guidance_scale=7.5)
    assert (got - base).abs().max().item() > 1e-3  # the merged phase bites
    for name, w in merged.items():  # the merged weights never entered the module
        assert not torch.equal(unet.get_parameter(name), w)


def test_sample_loop_cond_only_matches_jax(tiny):
    """guidance <= 1: the conditional rows only, in both packages."""
    junet, unet, jsites, jlp, tsites, tlp = tiny
    jsched, tsch = jcreate("ddim"), tsched.create_noise_scheduler("ddim")
    rng = np.random.default_rng(8)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    emb = rng.standard_normal((2, 77, 32)).astype(np.float32)
    want = jgen.sample_loop(junet.apply_fn(), junet.params, jlora.merge_lora_params(junet.params, jsites, jlp, -1.0),
                            1, jsched, jsched.set_timesteps(3), jnp.asarray(latents), jnp.asarray(emb),
                            jax.random.PRNGKey(0), guidance_scale=1.0)
    calls = []
    handle = unet.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
    try:
        got = tgen.sample_loop(unet, tlora.merge_lora_params(unet, tsites, tlp, -1.0), 1, tsch, tsch.set_timesteps(3),
                               torch.from_numpy(latents), torch.from_numpy(emb), guidance_scale=1.0)
    finally:
        handle.remove()
    assert calls == [1, 1, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=sampler_tol(want), rtol=0)
