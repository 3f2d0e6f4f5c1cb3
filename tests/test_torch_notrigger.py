"""The port's notrigger trainer (``train/notrigger.py``,
``cli/train_notrigger.py``) against the JAX package's, on the tiny-xl CLIP
towers (fp32, the port's towers holding JAX's weights):

* ``make_notrigger_step`` for positive-only, negative-only and both, LoRA
  and DoRA, in tower 0 and tower 1: over 3 steps of the trainer's optimizer
  (SGD, ``constant_with_warmup``, value clip 1.0) the metrics (``loss``,
  ``similarity``, ``pdist``, ``ndist``, ``w_p``/``w_n``/``w_r``) and the
  updated factors match JAX's within 2e-4 (fp32); ``initial_distances`` too;
* ``fixed_distance_loss``'s gradient runs through the moved target, as
  JAX's does.

The CLI and its files: ``tests/test_torch_notrigger_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.cli import train_notrigger as jcli
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.train import notrigger as jnt
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import slider_file as tsfile
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.train import notrigger as tnt
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = 2e-4
LR = 10.0  # the warm-up's lr is lr·k/100: 0, 0.1, 0.2 over the 3 steps
POS, NEG = "a smiling person", "a frowning person"


@pytest.fixture(scope="module")
def towers():
    """tiny-xl's two CLIP towers in both packages (the port's with JAX's
    weights) and the prompts' token ids."""
    _, jtes, _, _ = jfactory.load_models_xl("tiny-xl")
    _, ttes, _, _ = tfactory.load_models_xl("tiny-xl", device="cpu", with_unet=False)
    for jte, tte in zip(jtes, ttes):
        assert load_jax_params(tte.model, to_numpy_tree(jte.params)) == []
        tte.model.eval().requires_grad_(False)
    ids = [{p: np.asarray(jte.tokenizer([p])) for p in ("", POS, NEG)} for jte in jtes]  # te2 pads with 0
    for tte, tower_ids in zip(ttes, ids):
        for p, v in tower_ids.items():
            np.testing.assert_array_equal(tte.tokenizer([p]), v)
    return jtes, ttes, ids


def _setup(towers, clip_index, dora):
    """JAX sites and factors (non-zero up factors, DoRA's scales moved off the
    column norms) in tower ``clip_index``, and the port's copies."""
    jtes, ttes, _ = towers
    jte, tte = jtes[clip_index], ttes[clip_index]
    prefix = f"lora_te{clip_index + 1}"
    jsites = jlora.create_sites(jte.params, rank=2, alpha=1.0, target_replace=jnt.CLIP_TARGET_REPLACE, prefix=prefix,
                                train_method="full", name_path_prefix=jcli.CLIP_NAME_PATH_PREFIX)
    key = jax.random.PRNGKey(3 + clip_index)
    jlp = jdora.init_lora_params(key, jsites, jte.params) if dora else jlora.init_lora_params(key, jsites)
    rng = np.random.default_rng(clip_index)
    jlp = {n: {k: jnp.asarray(v * (1 + 0.1 * rng.standard_normal(v.shape)) if k == "dora_scale" else
                              (0.2 * rng.standard_normal(v.shape) if k == "up" else v), jnp.float32)
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tpeft = tdora if dora else tlora
    tsites = tpeft.create_sites(tte.model, rank=2, alpha=1.0, target_replace=tnt.CLIP_TARGET_REPLACE, prefix=prefix,
                                train_method="full", name_path_prefix=tsfile.CLIP_NAME_PATH_PREFIX)
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]
    sd = (jdora if dora else jlora).state_dict_numpy(jsites, jlp)
    tlp = tpeft.load_weights_from_tensors({k: np.asarray(v) for k, v in sd.items()}, tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    return jte, tte, jsites, jlp, tsites, tlp


SIGNS = {"positive": (POS, None), "negative": (None, NEG), "both": (POS, NEG)}


@pytest.mark.parametrize("clip_index", [0, 1])
@pytest.mark.parametrize("peft", ["lora", "dora"])
@pytest.mark.parametrize("signs", list(SIGNS))
def test_notrigger_steps_match_jax(towers, signs, peft, clip_index):
    positive, negative = SIGNS[signs]
    dora = peft == "dora"
    jte, tte, jsites, jlp, tsites, tlp = _setup(towers, clip_index, dora)
    ids = towers[2][clip_index]
    jpeft, tpeft = (jdora, tdora) if dora else (jlora, tlora)

    def jenc(params, x):
        return jte.model.apply({"params": params}, x).hidden_states[-1]

    j_ids = {p: jnp.asarray(v) for p, v in ids.items()}
    jt = {p: (jenc(jte.params, j_ids[p]) if p else None) for p in (positive, negative) if p}
    j_neutral = jenc(jte.params, j_ids[""])
    jopt = joptim.get_optimizer("sgd", joptim.get_lr_schedule("constant_with_warmup", LR, 10), grad_clip_value=1.0)
    jd1, jd2 = jnt.initial_distances(jenc, jte.params, jsites, jlp, j_ids[""], jt.get(positive), jt.get(negative),
                                     merge_fn=jpeft.merge_lora_params)
    ncfg = dict(lambda_similarity=0.1, has_positive=positive is not None, has_negative=negative is not None)
    jstep = jnt.make_notrigger_step(jenc, jsites, jopt, jnt.NoTriggerConfig(**ncfg), j_ids[""], jt.get(positive),
                                    jt.get(negative), j_neutral, jd1, jd2, merge_fn=jpeft.merge_lora_params)

    hidden = tnt.hidden_of(tte.model)
    t_ids = {p: torch.from_numpy(v.astype(np.int64)) for p, v in ids.items()}
    with torch.no_grad():
        tt = {p: hidden(t_ids[p]) for p in (positive, negative) if p}
        t_neutral = hidden(t_ids[""])
    topt = toptim.get_optimizer("sgd", toptim.get_lr_schedule("constant_with_warmup", LR, 10), grad_clip_value=1.0)
    td1, td2 = tnt.initial_distances(tte.model, tsites, tlp, t_ids[""], tt.get(positive), tt.get(negative),
                                     merge_fn=tpeft.merge_lora_params)
    for j, t in ((jd1, td1), (jd2, td2)):
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_allclose(float(t), float(j), rtol=TOL)
    tstep = tnt.make_notrigger_step(tte.model, tsites, tlp, topt, tnt.NoTriggerConfig(**ncfg), t_ids[""],
                                    tt.get(positive), tt.get(negative), t_neutral, td1, td2,
                                    merge_fn=tpeft.merge_lora_params)
    tstate = topt.init(toptim.flat_params(tsites, tlp))
    lp, jstate = jlp, jopt.init(jlp)
    before = tpeft.state_dict_numpy(tsites, tlp)
    for i in range(3):
        lp, jstate, jm = jstep(jte.params, lp, jstate)
        tm = tstep(tstate)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, atol=1e-6, err_msg=f"step {i}: {k}")
        want, got = jpeft.state_dict_numpy(jsites, lp), tpeft.state_dict_numpy(tsites, tlp)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=TOL, rtol=0, err_msg=f"step {i}: {k}")
    moved = max(float(np.abs(got[k] - before[k]).max()) for k in got)
    assert moved > 10 * TOL  # the comparison is not of frozen factors


def test_fixed_distance_loss_gradient_runs_through_the_moved_target():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 1, 5, 8)).astype(np.float32)
    d = np.float32(0.7)
    jg = jax.grad(lambda x: jnt.fixed_distance_loss(x, jnp.asarray(b), jnp.asarray(d)))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    loss = tnt.fixed_distance_loss(x, torch.from_numpy(b), torch.tensor(d))
    (tg,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(jnt.fixed_distance_loss(jnp.asarray(a), jnp.asarray(b),
                                                                           jnp.asarray(d))), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-5)
    # the detached target's gradient would be the plain MSE's: 2(x − moved)/n ≠ JAX's
    x2 = torch.from_numpy(a).requires_grad_(True)
    diff = torch.from_numpy(b) - x2
    cur = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    moved = (x2 + diff / (cur + 1e-8) * torch.clamp(torch.tensor(d), max=cur.min().item())).detach()
    (dg,) = torch.autograd.grad(torch.mean((x2 - moved) ** 2), x2)
    assert not np.allclose(dg.numpy(), np.asarray(jg), atol=1e-7)
