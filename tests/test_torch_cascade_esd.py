"""The port's Stable Cascade ESD step (``train/esd_cascade.py``) against the
JAX package's ``make_cascade_esd_train_step`` on euler_a (the shipped
config's scheduler): two steps on the tiny prior (fp32, 128px — an odd 3 × 3
effnet grid —, ``max_denoising_steps`` 4) from the same weights, LoRA
factors, prompt embeddings and random draws (derived from the JAX step key
as ``sample_loss`` splits it); loss, grad norm and every factor within 2e-4
(``tests/_cascade_assets.py::check_two_steps``).

* routes: the merged student (the default), the overlay student, DoRA, and
  the dual-tree W8A8 warm-up (an int8 copy with the slider through the
  overlay; both packages quantize every Linear: tiny widths hold none of
  65,536 elements; its int8 rounding is not continuous, so JAX's steps
  must match the port's from the draws or from the latents scaled by
  1 ± 1e-6, each check at 2e-4);
* the port's student with its layers checkpointed where the JAX step's
  remat is off (the numbers are the same);
* the step's refusals, word for word.

The wuerstchen, ddpm and ddim steps are in
``tests/test_torch_cascade_esd_schedulers.py``, ``samples_per_step`` and the
CLI in ``tests/test_torch_cascade_cli.py``.
"""

import jax.numpy as jnp
import pytest
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.train import esd_cascade as jesc
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.train import esd_cascade as tesc
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _cascade_assets import check_two_steps, random_prior
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.mark.parametrize("route,remat", [("merged", True), ("overlay", False), ("dora", False), ("w8a8", True)])
def test_cascade_esd_steps_match_jax_euler_a(route, remat):
    check_two_steps("euler_a", route, remat=remat)


def _raised(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", ["overlay_dora", "warm_without_overlay_warmup", "overlay_warmup_dora",
                                  "share_one_sample", "lms"])
def test_step_refusals_match_jax_word_for_word(case):
    model, params, port = random_prior()
    jsites = jlora.create_sites(params, rank=2, target_replace=["Attention"])
    tsites = tlora.create_sites(port, rank=2, target_replace=["Attention"])
    tlp = tlora.init_lora_params(tsites)
    kw = dict(student_overlay=False, overlay_warmup=False, samples_per_step=1, share_warmup=False)
    merge = "lora"
    sched = "euler_a"
    jwarm = twarm = None
    if case == "overlay_dora":
        kw["student_overlay"], merge = True, "dora"
    elif case == "warm_without_overlay_warmup":
        jwarm, twarm = (lambda *a: None), port
    elif case == "overlay_warmup_dora":
        kw["overlay_warmup"], merge = True, "dora"
    elif case == "share_one_sample":
        kw["share_warmup"] = True
    else:
        sched = "lms"
    jmerge = jdora.merge_lora_params if merge == "dora" else jlora.merge_lora_params
    tmerge = tdora.merge_lora_params if merge == "dora" else tlora.merge_lora_params
    jsched, tsched = jscheduler(sched), tscheduler(sched)
    want = _raised(lambda: jesc.make_cascade_esd_train_step(
        lambda *a: None, jsites, jsched, jsched.set_timesteps(4),
        joptim.get_optimizer("sgd", joptim.get_lr_schedule("constant", 1.0, 1)),
        jesc.CascadeESDConfig(max_denoising_steps=4, samples_per_step=kw["samples_per_step"],
                              share_warmup=kw["share_warmup"]),
        jnp.zeros((5, 16)), jnp.zeros((1, 16)), 16, merge_fn=jmerge, student_overlay=kw["student_overlay"],
        warm_apply=jwarm, overlay_warmup=kw["overlay_warmup"]))
    got = _raised(lambda: tesc.make_cascade_esd_train_step(
        port, tsites, tlp, tsched, tsched.set_timesteps(4),
        toptim.get_optimizer("sgd", toptim.get_lr_schedule("constant", 1.0, 1)),
        tesc.CascadeESDConfig(max_denoising_steps=4, **kw), torch.zeros((5, 16)), torch.zeros((1, 16)), 16,
        merge_fn=tmerge, warm_prior=twarm))
    assert got == want
