"""The port's optimizers and schedules (``train/optim.py``) against the JAX
package's ``get_optimizer`` / ``get_lr_schedule``.

* every schedule at steps 0…2·max against JAX's: rel 1e-6;
* Lion, SGD (with and without momentum) and AdamW under the norm clip and
  the value clip against optax over 5 steps, some steps clipping: ≤ 1e-6;
* Prodigy, DAdaptAdam and DAdaptLion against the JAX bodies over 6 steps,
  their d-estimates included: ≤ 1e-5;
* a resume from ``train/checkpoint.py`` continues bit for bit with each
  optimizer, alone and through ``trainer.train`` on tiny-xl;
* the names JAX refuses raise the same exception type.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.train import checkpoint as tckpt
from sliders_conceptmod_tpu_torch.train import optim as toptim
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ["constant", "cosine", "cosine_with_restarts", "step", "linear", "constant_with_warmup"]
SHAPES = [(4, 7), (7, 4), (3,), (2, 3, 3, 3)]
MAX_ITERS = 400


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_jax(name):
    lr, lr_min = 1e-2, 1e-3
    steps = np.arange(0, 2 * MAX_ITERS + 1)
    want = np.broadcast_to(np.asarray(joptim.get_lr_schedule(name, lr, MAX_ITERS, lr_min)(jnp.asarray(steps))),
                           steps.shape)
    sched = toptim.get_lr_schedule(name, lr, MAX_ITERS, lr_min)
    got = np.array([sched(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert all(isinstance(sched(int(s)), float) for s in steps[:3])  # host floats: no device read


def _problem(seed=3, n_steps=5, scales=(0.01, 1.0, 0.02, 3.0, 0.05, 0.3)):
    rng = np.random.default_rng(seed)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES] for scale in scales[:n_steps]]
    return init, grads


def _run_both(name, args, sched, n_steps, clip_norm=None, clip_value=None, jstate_check=None, tol=1e-6):
    init, grads = _problem(n_steps=n_steps)
    jopt = joptim.get_optimizer(name, joptim.get_lr_schedule(*sched), args, grad_clip_norm=clip_norm,
                                grad_clip_value=clip_value)
    jp = [jnp.asarray(x) for x in init]
    jstate = jopt.init(jp)
    topt = toptim.get_optimizer(name, toptim.get_lr_schedule(*sched), args, grad_clip_norm=clip_norm,
                                grad_clip_value=clip_value)
    tp = [torch.from_numpy(x.copy()) for x in init]
    tstate = topt.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, [torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0, err_msg=f"step {i}")
        if jstate_check is not None:
            jstate_check(jstate, tstate, i)
    moved = max(float(np.abs(a.numpy() - b).max()) for a, b in zip(tp, init))
    assert moved > 10 * tol  # the comparison is not of frozen parameters
    assert tstate["count"] == n_steps


@pytest.mark.parametrize("name,args,clip_norm,clip_value", [
    ("lion", "", None, None),
    ("lion8bit", "weight_decay=0.1 betas=(0.8,0.95)", 0.5, None),
    ("lion", "", 0.2, 0.01),
    ("sgd", "", None, None),
    ("sgd", "momentum=0.9", None, None),
    ("sgd", "momentum=0.5", 0.2, 0.02),
    ("adamw", "weight_decay=0.1", 0.2, 0.02),
    ("adam", "", None, 0.05),
], ids=["lion", "lion8bit-wd-betas-clip", "lion-clip-value", "sgd", "sgd-momentum", "sgd-momentum-clips",
        "adamw-clips", "adam-clip-value"])
def test_optax_optimizers_match(name, args, clip_norm, clip_value):
    """Over 5 steps whose gradients are scaled 0.01…3: the norm clip (0.2,
    0.5) acts on some steps, the value clip on most."""
    _run_both(name, args, ("cosine", 1e-2, 4, 1e-4), 5, clip_norm, clip_value)


def _d_state(jstate):
    """The JAX state tuple's entry that holds the d-estimate."""
    return next(s for s in jstate if hasattr(s, "d"))


@pytest.mark.parametrize("name,args", [
    ("prodigy", ""),
    ("prodigy", "use_bias_correction=true safeguard_warmup=true weight_decay=0.01 d_coef=0.5"),
    ("prodigy", "betas=(0.9,0.99) beta3=0.9 growth_rate=1.5"),
    ("dadaptadam", ""),
    ("dadaptadam", "weight_decay=0.01 use_bias_correction=true"),
    ("dadaptadam", "weight_decay=0.01 decouple=true growth_rate=2"),
    ("dadaptlion", ""),
    ("dadaptlion", "weight_decay=0.01 betas=(0.8,0.95)"),
], ids=["prodigy", "prodigy-bias-safeguard-wd", "prodigy-betas-growth", "dadaptadam", "dadaptadam-coupled-wd",
        "dadaptadam-decoupled", "dadaptlion", "dadaptlion-wd-betas"])
def test_adaptive_optimizers_match_the_jax_bodies(name, args):
    """The d-estimates (d, Prodigy's d_max) at rel 1e-5; the running
    numerators, sums of ⟨g, ·⟩ whose terms cancel, at rel 1e-5 plus abs 1e-9."""
    keys = {"prodigy": ("d", "d_max", "d_numerator")}.get(name, ("d", "numerator_weighted"))

    def check(jstate, tstate, i):
        js = _d_state(jstate)
        for k in keys:
            np.testing.assert_allclose(float(tstate[k]), float(getattr(js, k)), rtol=1e-5,
                                       atol=1e-9 if "numerator" in k else 0, err_msg=f"step {i}: {k}")
        assert tstate["d"].ndim == 0  # a device scalar: a step never reads it back

    # d0 1e-2 (default 1e-6): the parameters move well past the tolerance in 6 steps
    _run_both(name, args + " d0=0.01", ("constant", 1.0, 10), 6, clip_norm=0.5, jstate_check=check, tol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("adamw", ""), ("lion", ""), ("sgd", "momentum=0.9"), ("prodigy", "use_bias_correction=true"),
    ("dadaptadam", ""), ("dadaptlion", ""),
])
def test_resume_continues_bit_for_bit(name, args, tmp_path):
    """3 steps, a checkpoint, 3 more; against a fresh optimizer restored from
    the checkpoint and run for the same 3: the same bits in every parameter
    and every state entry."""
    init, grads = _problem(n_steps=6, scales=(0.5,) * 6)

    def make():
        opt = toptim.get_optimizer(name, toptim.get_lr_schedule("cosine", 1e-2, 8, 1e-4), args,
                                   grad_clip_norm=0.3, grad_clip_value=0.1)
        params = [torch.from_numpy(x.copy()) for x in init]
        lora_params = {"site": {f"p{i}": p for i, p in enumerate(params)}}
        return opt, params, lora_params, opt.init(params)

    opt, params, lp, state = make()
    for g in grads[:3]:
        opt.step(params, [torch.from_numpy(x) for x in g], state)
    tckpt.save(str(tmp_path / "r.pt"), lp, state, 3, None)
    for g in grads[3:]:
        opt.step(params, [torch.from_numpy(x) for x in g], state)

    opt2, params2, lp2, state2 = make()
    assert tckpt.restore(str(tmp_path / "r.pt"), lp2, state2, None) == 3
    for g in grads[3:]:
        opt2.step(params2, [torch.from_numpy(x) for x in g], state2)
    for a, b in zip(params, params2):
        assert torch.equal(a, b)
    assert state2.keys() == state.keys() and state2["count"] == state["count"] == 6
    for k, v in state.items():
        for a, b in zip(*(([v], [state2[k]]) if not isinstance(v, list) else (v, state2[k]))):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), k


def test_resume_refuses_another_optimizers_state(tmp_path):
    p = [torch.ones(3)]
    adam = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-3, 10))
    tckpt.save(str(tmp_path / "r.pt"), {"s": {"down": p[0]}}, adam.init(p), 1, None)
    lion = toptim.get_optimizer("lion", toptim.get_lr_schedule("constant", 1e-3, 10))
    with pytest.raises(ValueError, match="another optimizer"):
        tckpt.restore(str(tmp_path / "r.pt"), {"s": {"down": torch.ones(3)}}, lion.init(p), None)


@pytest.mark.parametrize("name,scheduler", [("prodigy", "cosine_with_restarts"), ("lion", "step")])
def test_trainer_resumes_bit_identically_with_the_new_optimizers(name, scheduler, tmp_path):
    """``trainer.train`` on tiny-xl under ``honor_network_config``: 4 steps
    with a resume checkpoint at step 2, then a run resumed from it gives the
    uninterrupted run's last losses and factors, bit for bit."""
    def cfg_at(path):
        cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-tiny-xl.yaml"))
        cfg.prompts_file = os.path.join(REPO, cfg.prompts_file)
        cfg.save.path, cfg.save.per_steps, cfg.train.iterations = str(path), 2, 4
        cfg.logging.verbose = False
        cfg.train.optimizer, cfg.train.lr_scheduler = name, scheduler
        cfg.train.lr = 1.0 if name == "prodigy" else 1e-3
        return cfg

    prompts = tprompts.load_prompts_from_yaml(cfg_at(tmp_path).prompts_file)
    res = ttrainer.train(cfg_at(tmp_path / "full"), prompts, rank=2, device="cpu")
    res2 = ttrainer.train(cfg_at(tmp_path / "resumed"), prompts, rank=2, device="cpu",
                          resume_from=str(tmp_path / "full"))
    assert res2.losses == res.losses[3:] and all(np.isfinite(res.losses))
    a = tst.load_file(str(tmp_path / "full" / "tinyxl_slider_last.safetensors"))
    b = tst.load_file(str(tmp_path / "resumed" / "tinyxl_slider_last.safetensors"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["dadaptsgd", "adagrad"])
def test_refused_names_raise_what_jax_raises(name):
    sched = toptim.get_lr_schedule("constant", 1e-3, 10)
    with pytest.raises(ValueError) as jerr:
        joptim.get_optimizer(name, joptim.get_lr_schedule("constant", 1e-3, 10))
    with pytest.raises(ValueError) as terr:
        toptim.get_optimizer(name, sched)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        toptim.get_lr_schedule("polynomial", 1e-3, 10)
