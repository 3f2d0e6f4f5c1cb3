"""The port's SD1/SD2 ESD step against the JAX package's: two DDIM ESD
steps (``max_denoising_steps`` 3, 64px, fp32) from the same UNet weights,
LoRA factors, prompt embeddings and random draws, at ``train.cfg`` 1 and 2,
on the tiny SD UNet with an epsilon and a v-prediction scheduler; loss, grad
norm and every factor within 2e-4 (``STEP_TOL``). The same steps on a tiny
variant whose mid block has one head of 160 are
tests/test_torch_sd_esd_d160.py."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from test_torch_sd_train import CTX, MAX_STEPS, SEQ, STEP_TOL, _random_unet
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


# ---------------------------------------------------------------------------
# the slice: DDIM ESD steps, port vs JAX
# ---------------------------------------------------------------------------


SETTINGS = [
    dict(target="person", positive="person, very old", unconditional="person, young", neutral="person",
         action="enhance", guidance_scale=4, resolution=64),
    dict(target="sky", positive="blue sky", negative="grey sky", action="erase", guidance_scale=2.0, resolution=64),
]


def _jax_draws(key, schedule, n_pairs):
    """The port's Draws from the JAX step key, as the JAX ``warm_draw`` draws
    (DDIM's warm-up takes no noise; the split is kept for the key stream)."""
    k_pair, k_t, k_noise, k_warm = jax.random.split(key, 4)
    pair = int(jax.random.randint(k_pair, (), 0, n_pairs))
    t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS))
    lat0 = np.array(jsampling.get_initial_latents(k_noise, schedule, 1, 64, 64))
    return tesd.Draws(pair, t_to, torch.from_numpy(lat0), torch.zeros((t_to,) + lat0.shape))


@pytest.mark.parametrize("train_cfg", [1.0, 2.0])
@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_sd_ddim_esd_steps_match_jax(prediction, train_cfg):
    esd_steps_match_jax("tiny", prediction, train_cfg)


def esd_steps_match_jax(variant, prediction, train_cfg, route=(True, True), peft="lora", seeds=(11, 12)):
    """Steps of the port and of the JAX package from the same state;
    ``variant`` is the UNet ("tiny" or "d160"), ``route`` the
    ``(student_overlay, overlay_warmup)`` pair, ``peft`` "lora" or "dora"
    (then ``dora_scale`` is held too)."""
    jpeft, tpeft = (jdora, tdora) if peft == "dora" else (jlora, tlora)
    student_overlay, overlay_warmup = route
    model, params, port = _random_unet(variant, seed=4)
    rng = np.random.default_rng(5)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, train_method="full")
    jlp = (jdora.init_lora_params(jax.random.PRNGKey(1), jsites, base_params=params) if peft == "dora"
           else jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    # non-zero up factors, so the first step's gradient reaches the downs too
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, train_method="full")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]

    def emb(prompt):
        r = np.random.default_rng(zlib.crc32(prompt.encode()))
        return 0.5 * r.standard_normal((SEQ, CTX)).astype(np.float32)

    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SETTINGS],
                                   lambda p: (jnp.asarray(emb(p)), None))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                   lambda p: (torch.from_numpy(emb(p)), None))
    assert tbank.pooled is None

    jsched = jscheduler("ddim", prediction_type=prediction)
    jschedule = jsched.set_timesteps(MAX_STEPS)
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10))
    ecfg = jesd.ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=64, width=64,
                          batch_size=1, student_overlay=student_overlay, overlay_warmup=overlay_warmup,
                          remat_unet=False)

    def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
        return model.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

    jstep = jesd.make_esd_train_step(unet_apply, jsites, jsched, jschedule, jopt, ecfg,
                                     merge_fn=jpeft.merge_lora_params)

    tlp = tpeft.load_weights_from_tensors(jpeft.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    tsched = tscheduler("ddim", prediction_type=prediction)
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10))
    tstep = tesd.make_esd_train_step(
        port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
        tesd.ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=64, width=64,
                       student_overlay=student_overlay, overlay_warmup=overlay_warmup),
        merge_fn=tpeft.merge_lora_params)
    tstate = topt.init(toptim.flat_params(tsites, tlp))

    lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
    jstate = jopt.init(lp)
    before = tpeft.state_dict_numpy(tsites, tlp)
    for i, seed in enumerate(seeds):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, jschedule, len(SETTINGS))
        lp, jstate, jm = jstep(params, lp, jstate, key, jbank)
        tm = tstep(tstate, tbank, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
        want = jpeft.state_dict_numpy(jsites, lp)
        got = tpeft.state_dict_numpy(tsites, tlp)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=f"step {i}: {k}")
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 5e-3  # the factors moved
    return before, got
