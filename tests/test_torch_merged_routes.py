"""The port's merged slider routes against the JAX package's, on the CPU.

* ``core/config.py::resolve_student_overlay`` over the whole grid of
  ``(student_overlay, overlay_warmup)`` × peft type × ``default_overlay`` ×
  ``quantize_base``: the JAX function's answer, or its exception and message;
* ``merge_lora_params(..., grad=True)``: the merged weights and the
  factors' gradients through the merge (and its cast into bf16 weights)
  against ``jax.grad`` of the JAX merge; without ``grad`` no graph;
* one tiny-xl ESD step (Euler-A, fp32) on the routes ``(True, False)`` (the
  overlay student, the merged warm-up — the JAX default for a bf16 LoRA) and
  ``(False, None)`` (the merged student): loss and every factor within 2e-4
  (the tiny-SD DDIM step on both routes is in tests/test_torch_dora.py, the
  bf16 number of the default route in tests/test_torch_export.py, to keep
  each file's time short);
* two tiny-xl image-pair steps with the merged ±s students.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from test_torch_imageslider import image_pair_steps_match_jax
from test_torch_train import MAX_STEPS, _jax_draws, slice_setup, xl_esd_steps_match_jax  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

ROUTES = [(True, False), (False, None)]
ROUTE_IDS = ["overlay_student_merged_warmup", "merged_student"]


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("quantize_base", [False, True])
@pytest.mark.parametrize("default_overlay", [None, True, False])
@pytest.mark.parametrize("peft_type", ["lora", "dora"])
def test_resolve_student_overlay_matches_jax_over_the_grid(peft_type, default_overlay, quantize_base):
    for so in (None, True, False):
        for ow in (None, True, False):
            want = _outcome(lambda: jconfig.resolve_student_overlay(
                jconfig.TPUConfig(student_overlay=so, overlay_warmup=ow), quantize_base, peft_type, default_overlay))
            got = _outcome(lambda: tconfig.resolve_student_overlay(
                tconfig.TPUConfig(student_overlay=so, overlay_warmup=ow), quantize_base, peft_type, default_overlay))
            assert got == want, (so, ow)
    # an unset tpu block: the ESD trainers pass default_overlay = (peft_type == "lora")
    if default_overlay is (peft_type == "lora") and not quantize_base:
        want = (True, False) if peft_type == "lora" else (False, None)
        assert tconfig.resolve_student_overlay(tconfig.TPUConfig(), False, peft_type, default_overlay) == want


# ---------------------------------------------------------------------------
# the merge with gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_with_grad_matches_jax_grad(slice_setup, dtype):
    """Merged weights and d(Σ R∘W′)/d(factors) through the merge, its cast into
    the weight's dtype included, against ``jax.grad`` of the JAX merge."""
    _, params, port, jsites, jlp, tsites, _, _ = slice_setup
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()).to(tdt)
    load_jax_params(port, to_numpy_tree(params))
    rng = np.random.default_rng(9)
    kernels = {s.lora_name: jlora._tree_at(jparams, s.module_path + ("kernel",)) for s in jsites}
    weights = {s.lora_name: rng.standard_normal(kernels[s.lora_name].shape).astype(np.float32) for s in jsites}

    def jloss(lp):
        merged = jlora.merge_lora_params(jparams, jsites, lp, 1.5)
        return sum(jnp.sum(jlora._tree_at(merged, s.module_path + ("kernel",)).astype(jnp.float32)
                           * weights[s.lora_name]) for s in jsites)

    jgrad = jax.grad(jloss)(jlp)
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    merged = tlora.merge_lora_params(port, tsites, tlp, 1.5, grad=True)
    by_name = dict(zip((s.lora_name for s in tsites), merged.values()))
    assert all(m.dtype == tdt for m in merged.values())
    loss = sum((by_name[s.lora_name].float() * torch.from_numpy(
        weights[s.lora_name].T if s.kind == "dense" else weights[s.lora_name].transpose(3, 2, 0, 1))).sum()
        for s in tsites)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(jlp)), rtol=2e-4 if dtype == "float32" else 1e-3)
    want = jlora.state_dict_numpy(jsites, jgrad)
    got = tlora.state_dict_numpy(tsites, {n: {k: t.grad for k, t in leaf.items()} for n, leaf in tlp.items()})
    for k in want:
        if k.endswith(".alpha"):
            continue
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4 * np.abs(want[k]).max(), err_msg=k)
    assert not any(m.requires_grad for m in tlora.merge_lora_params(port, tsites, tlp, 1.5).values())


def test_overlay_none_refuses_a_hooked_model(slice_setup):
    """The merged route runs in ``overlay(None)``: a hook left on a site module
    would add the slider a second time, so entering it raises."""
    _, _, port, _, _, tsites, _, _ = slice_setup
    tlp = tlora.init_lora_params(tsites)
    overlay = tlora.LoRAOverlay(port, tsites, tlp)
    with overlay(None):
        pass
    with overlay(torch.ones(1)):
        with pytest.raises(RuntimeError, match="forward hook"):
            with overlay(None):
                pass
    with overlay(None):  # the hooks went with their block
        pass


# ---------------------------------------------------------------------------
# the steps, port vs JAX (fp32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_xl_esd_step_routes_match_jax(slice_setup, route):
    xl_esd_steps_match_jax(slice_setup, 1.0, route=route, seeds=(11,))


def test_image_pair_merged_students_match_jax():
    # The merged students' factor gradients span 1e-12…1e-3 here (a full
    # dL/dW′ projected on a factor), and Adam's first step with eps 1e-8 is
    # lr·g/(|g| + 1e-8): where |g| ≈ eps it turns the packages' fp32
    # summation orders (merge, then dW′; JAX fuses) into 4e-4 of update. With
    # eps 1e-4 the update stays a smooth function of g (≤ lr/eps = 100× its
    # error), so the 2e-4 bound holds the gradient itself.
    image_pair_steps_match_jax(student_overlay=False, seeds=(21, 22), optimizer_args="eps=1e-4")
