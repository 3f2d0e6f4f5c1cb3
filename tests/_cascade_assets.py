"""Shared set-up of the port's Stable Cascade tests: the tiny prior with
random weights in both packages and prompt embeddings made from a seed with
numpy, and two ESD steps of both packages on one route
(:func:`check_two_steps`). The cached helpers are cached per process;
callers only read what they return."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.diffusion.wuerstchen import WuerstchenScheduler as JWuerstchen
from sliders_conceptmod_tpu.models import cascade as jcascade
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import esd_cascade as jesc
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.diffusion.wuerstchen import WuerstchenScheduler as TWuerstchen
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import cascade as tcascade
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import esd_cascade as tesc
from sliders_conceptmod_tpu_torch.train import optim as toptim

STEP_TOL = 2e-4  # fp32 prior forwards and ESD steps, port vs JAX
SEQ = 5  # text tokens of the made-up embeddings (the tiny tower gives 77)


def jax_init(cfg, hw: int = 4):
    model = jcascade.StableCascadeUNet(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.in_channels, hw, hw)), jnp.zeros((1,)),
                        jnp.zeros((1, 3, cfg.clip_text_in_channels)),
                        jnp.zeros((1, 1, cfg.clip_text_pooled_in_channels)),
                        jnp.zeros((1, 1, cfg.clip_image_in_channels)))
    return model, params["params"]


@functools.lru_cache(maxsize=None)
def random_prior(seed: int = 3, scale: float = 0.1):
    """(JAX model, JAX params with N(0, scale²) leaves, the port's tiny prior
    holding them — the whole tree, nothing left over)."""
    model, params = jax_init(jcascade.CascadeConfig.tiny())
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
    port = tcascade.StableCascadeUNet(tcascade.CascadeConfig.tiny())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    return model, params, port.eval().requires_grad_(False)


def emb(prompt: str, seq: int = SEQ, dim: int = 16, pooled_dim: int = 16):
    """A prompt's (text [seq, dim], pooled [1, pooled_dim]) from its CRC32."""
    r = np.random.default_rng(zlib.crc32(prompt.encode()))
    text = (0.5 * r.standard_normal((seq, dim))).astype(np.float32)
    return text, r.standard_normal((1, pooled_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# two ESD steps, port against JAX
# ---------------------------------------------------------------------------

MAX_STEPS = 4
SIZE = 128  # ceil(128 / 42.67) = 3: an odd 3 × 3 grid, so the up path resizes
# plain SGD: the factors move by lr · gradient, so the comparison holds the
# gradients themselves (Adam's m/√v turns fp32 noise in a near-zero gradient
# into a step of up to lr)
OPT, LR = "sgd", 4.0
SETTINGS = [
    dict(target="person", positive="person, very old", unconditional="person, young", neutral="person",
         action="enhance", guidance_scale=4, resolution=SIZE),
    dict(target="sky", positive="blue sky", negative="grey sky", unconditional="sky", action="erase",
         guidance_scale=2.0, resolution=SIZE),
]


def jax_draws(key, n_pairs: int, samples: int):
    """The port's draws from the JAX step key, as the JAX step's
    ``sample_loss`` splits it (``fold_in(k_warm, i)`` per warm-up step)."""
    keys = [key] if samples == 1 else list(jax.random.split(key, samples))
    out = []
    for k in keys:
        k_pair, k_noise, k_warm = jax.random.split(k, 3)
        pair = int(jax.random.randint(k_pair, (), 0, n_pairs))
        shape = (1, 16, 3, 3)
        lat0 = np.array(jax.random.normal(k_noise, shape, jnp.float32))
        noise = np.stack([np.array(jax.random.normal(jax.random.fold_in(k_warm, i), shape, jnp.float32))
                          for i in range(MAX_STEPS - 1)])
        out.append(tesc.Draw(pair, torch.from_numpy(lat0), torch.from_numpy(noise)))
    return out


@functools.lru_cache(maxsize=None)
def banks():
    """(JAX bank, the port's bank, the empty prompt's (text, pooled))."""
    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SETTINGS],
                                   lambda p: tuple(jnp.asarray(a) for a in emb(p)))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                   lambda p: tuple(torch.from_numpy(a) for a in emb(p)))
    return jbank, tbank, emb("")


def check_two_steps(sched_name: str, route: str, samples: int = 1, share: bool = False, remat: bool = False):
    """Two ESD steps of both packages on ``route`` (merged, overlay, dora,
    w8a8: the dual tree, every Linear quantized): loss, grad norm and every
    factor within STEP_TOL, and the factors moved.

    W8A8 rounds each token's activations to int8, so its warm-up is not
    continuous in its inputs: fp32 noise in one summation order can flip a
    rounding and move the loss by ~1e-3 (the port moves as much when its
    initial latents are scaled by 1 ± 1e-6). On that route JAX's two steps
    must match, within STEP_TOL, the port's from the draws as they are or
    from the latents scaled by 1 ± 1e-6."""
    jbank, tbank, (empty_text, empty_pooled) = banks()
    jpeft, tpeft = (jdora, tdora) if route == "dora" else (jlora, tlora)
    model, params, port = random_prior()
    rng = np.random.default_rng(5)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"])
    jlp = (jdora.init_lora_params(jax.random.PRNGKey(1), jsites, base_params=params) if route == "dora"
           else jlora.init_lora_params(jax.random.PRNGKey(1), jsites))
    # non-zero up factors, so the first step's gradient reaches the downs too
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"])
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]

    jsched, tsched = (JWuerstchen(), TWuerstchen()) if sched_name == "wuerstchen" else (
        jscheduler(sched_name), tscheduler(sched_name))
    student_overlay, w8a8 = route == "overlay", route == "w8a8"
    keys = [jax.random.PRNGKey(seed) for seed in (11, 12)]

    def apply(p, *a):
        return model.apply({"params": p}, *a)

    jparams = jax.tree.map(jnp.asarray, params)
    warm_params = jwarm = None
    if w8a8:
        warm_params, scales = jquant.quantize_params(jparams, min_elems=1)
        jwarm = jquant.wrap_apply(apply, scales, jnp.float32, act_quant=True)
    jopt = joptim.get_optimizer(OPT, joptim.get_lr_schedule("constant", LR, 10))
    jstep = jesc.make_cascade_esd_train_step(
        apply, jsites, jsched, jsched.set_timesteps(MAX_STEPS), jopt,
        jesc.CascadeESDConfig(max_denoising_steps=MAX_STEPS, height=SIZE, width=SIZE, remat=False,
                              samples_per_step=samples, share_warmup=share),
        empty_text=jnp.asarray(empty_text), empty_pooled=jnp.asarray(empty_pooled), clip_image_dim=16,
        merge_fn=jpeft.merge_lora_params, student_overlay=student_overlay, warm_apply=jwarm, overlay_warmup=w8a8)
    lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
    jstate = jopt.init(lp)
    want = []
    for key in keys:
        lp, jstate, jm = jstep(jparams, lp, jstate, key, jbank, warm_params)
        want.append((float(jm["loss"]), float(jm["grad_norm"]), jpeft.state_dict_numpy(jsites, lp)))

    warm_prior = tquant.quantized_copy(port, act_quant=True, min_elems=1) if w8a8 else None

    def port_steps(latent_scale: float):
        tlp = tpeft.load_weights_from_tensors(jpeft.state_dict_numpy(jsites, jlp), tsites)
        for leaf in tlp.values():
            for t in leaf.values():
                t.requires_grad_(True)
        topt = toptim.get_optimizer(OPT, toptim.get_lr_schedule("constant", LR, 10))
        tstep = tesc.make_cascade_esd_train_step(
            port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
            tesc.CascadeESDConfig(max_denoising_steps=MAX_STEPS, height=SIZE, width=SIZE, remat=remat,
                                  samples_per_step=samples, share_warmup=share, student_overlay=student_overlay,
                                  overlay_warmup=w8a8),
            empty_text=torch.from_numpy(empty_text), empty_pooled=torch.from_numpy(empty_pooled),
            clip_image_dim=16, merge_fn=tpeft.merge_lora_params, warm_prior=warm_prior)
        tstate = topt.init(toptim.flat_params(tsites, tlp))
        before = tpeft.state_dict_numpy(tsites, tlp)
        got = []
        for key in keys:
            draws = [tesc.Draw(d.pair, d.latents0 * latent_scale, d.warm_noise)
                     for d in jax_draws(key, len(SETTINGS), samples)]
            tm = tstep(tstate, tbank, draws=draws)
            got.append((float(tm["loss"]), float(tm["grad_norm"]), tpeft.state_dict_numpy(tsites, tlp)))
        return before, got

    def mismatch(got):
        """The first check of the two steps that fails, or None."""
        for i, ((loss, g_norm, factors), (w_loss, w_norm, w_factors)) in enumerate(zip(got, want)):
            if not abs(loss - w_loss) <= STEP_TOL * abs(w_loss) + 1e-7:
                return f"step {i}: loss {loss} vs {w_loss}"
            if not abs(g_norm - w_norm) <= STEP_TOL * abs(w_norm):
                return f"step {i}: grad norm {g_norm} vs {w_norm}"
            assert set(factors) == set(w_factors)
            for k in w_factors:
                if not np.abs(factors[k] - w_factors[k]).max() <= STEP_TOL:
                    return f"step {i}: {k} off by {np.abs(factors[k] - w_factors[k]).max()}"
        return None

    before, got = port_steps(1.0)
    failures = [mismatch(got)]
    for latent_scale in ((1 + 1e-6, 1 - 1e-6) if w8a8 and failures[0] else ()):
        failures.append(mismatch(port_steps(latent_scale)[1]))
    assert None in failures, failures
    factors = got[-1][2]
    assert max(np.abs(factors[k] - before[k]).max() for k in factors) > 5e-3  # the factors moved
