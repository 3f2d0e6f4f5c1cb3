"""The port's SDXL ESD training slice against the JAX package's.

* every ``data/*.yaml`` reads the same through the port's YAML subset reader
  as through ``yaml.safe_load``, and configs / prompts load to equal values
  with both packages' loaders;
* ``action_sign`` and the prompt defaults (the 5th prompt included);
* AdamW + global-norm clip + the constant and cosine schedules against optax
  over 5 updates (≤ 1e-6);
* the slice as a whole: one and two ESD steps on tiny-xl (64px, Euler-A,
  ``max_denoising_steps`` 3, fp32) from the same UNet weights, LoRA factors,
  prompt embeddings and random draws — the port's draws derived from the JAX
  key as ``warm_draw`` derives them — at ``train.cfg`` 1 and 2; loss,
  grad norm and every factor agree within 2e-4;
* ``trainer.train`` on ``data/config-tiny-xl.yaml``: the saved key set is
  the JAX trainer's, and a resumed run is bit-identical.
"""

import dataclasses
import glob
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import train_lora_xl as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.core import yaml_subset
from sliders_conceptmod_tpu_torch.diffusion import sampling as tsampling
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "data", "config*.yaml")))
PROMPTS = sorted(glob.glob(os.path.join(REPO, "data", "prompts*.yaml")))
STEP_TOL = 2e-4
MAX_STEPS, SEQ, CTX = 3, 11, 32


# ---------------------------------------------------------------------------
# YAML, config, prompts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS + PROMPTS, ids=os.path.basename)
def test_yaml_subset_reads_every_data_file_as_pyyaml(path):
    with open(path) as f:
        assert yaml_subset.load_file(path) == yaml.safe_load(f)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_to_equal_values(path):
    want = jconfig.load_config_from_yaml(path).model_dump()
    got = tconfig.load_config_from_yaml(path).model_dump()
    assert got == want


@pytest.mark.parametrize("path", PROMPTS, ids=os.path.basename)
def test_prompts_load_to_equal_values_with_attributes(path):
    for attrs in (None, ["young", "very old"]):
        want = [p.model_dump() for p in jprompts.load_prompts_from_yaml(path, attrs)]
        got = [p.model_dump() for p in tprompts.load_prompts_from_yaml(path, attrs)]
        assert got == want


def test_yaml_subset_refuses_what_it_does_not_take():
    text = "a: 1e-4\nb: 1.5\nc: 'it''s'\nd: \"x # y\"  # comment\ne: yes\nf: ~\ng:\n- 1\n- k: v\n  w: 2\n"
    assert yaml_subset.loads(text) == yaml.safe_load(text)
    for bad in ("a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\nb: *x\n", "a: |\n  text\n", "a: >\n  t\n",
                "---\na: 1\n", "a: !!str 1\n", "a: 0x1f\n", "a: \"two\n  lines\"\n", "a: b: c\n"):
        with pytest.raises(yaml_subset.YAMLSubsetError):
            yaml_subset.loads(bad)


def test_action_sign_and_prompt_defaults():
    for action in ("erase", "enhance"):
        assert tprompts.action_sign(action) == jprompts.action_sign(action)
    with pytest.raises(ValueError):
        tprompts.action_sign("blur")
    for raw in ({"target": "a"}, {"target": "a", "unconditional": "u"}, {"target": "a", "positive": "p",
                "negative": None, "neutral": "n", "unconditional": None, "guidance_scale": 3}):
        got = tprompts.PromptSettings.from_dict(dict(raw)).model_dump()
        assert got == jprompts.PromptSettings(**dict(raw)).model_dump()
    s = tprompts.PromptSettings.from_dict({"target": "a", "unconditional": "u"})
    assert (s.positive, s.neutral, s.negative) == ("a", "u", "u")  # 5th prompt ← unconditional
    with pytest.raises(ValueError):
        tprompts.PromptSettings.from_dict({"positive": "p"})


def test_precision_and_overlay_rules():
    assert tconfig.parse_precision("fp32") == torch.float32
    assert tconfig.parse_precision("bfloat16") == tconfig.parse_precision("fp16") == torch.bfloat16
    assert tconfig.parse_save_precision("fp16") == torch.float16
    assert tconfig.parse_save_precision("bf16") == torch.bfloat16
    # the JAX rule: an unset tpu block over a bf16 LoRA in the ESD trainers is the
    # overlay student with the merged warm-up; false knobs select the merged routes
    # (the whole grid against JAX: tests/test_torch_merged_routes.py)
    for so, ow, want in ((None, None, (True, False)), (True, None, (True, False)), (True, True, (True, True)),
                         (True, False, (True, False)), (False, None, (False, None))):
        jcfg = jconfig.TPUConfig(student_overlay=so, overlay_warmup=ow)
        tcfg = tconfig.TPUConfig(student_overlay=so, overlay_warmup=ow)
        assert jconfig.resolve_student_overlay(jcfg, False, "lora", default_overlay=True) == want
        assert tconfig.resolve_student_overlay(tcfg, False, "lora", default_overlay=True) == want
    # the JAX refusals: DoRA with the overlay student; an overlay warm-up without it
    with pytest.raises(NotImplementedError, match="LoRA only"):
        tconfig.resolve_student_overlay(tconfig.TPUConfig(student_overlay=True), False, "dora", False)
    with pytest.raises(ValueError, match="requires tpu.student_overlay"):
        tconfig.resolve_student_overlay(tconfig.TPUConfig(student_overlay=False, overlay_warmup=True), False, "lora",
                                        True)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["constant", "cosine"])
def test_adamw_clip_and_schedule_match_optax(sched):
    rng = np.random.default_rng(3)
    shapes = [(4, 7), (7, 4), (3,), (2, 3, 3, 3)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.01, 1.0, 0.02, 3.0, 0.05)]  # some steps clip, some do not
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule(sched, 1e-2, 4, 1e-4), grad_clip_norm=0.2)
    tx = jopt
    jp = [jnp.asarray(x) for x in init]
    state = tx.init(jp)
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule(sched, 1e-2, 4, 1e-4), grad_clip_norm=0.2)
    tp = [torch.from_numpy(x.copy()) for x in init]
    tstate = topt.init(tp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, [torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    for step in (0, 1, 3, 4, 7):
        assert toptim.get_lr_schedule(sched, 1e-2, 4, 1e-4)(step) == pytest.approx(
            float(joptim.get_lr_schedule(sched, 1e-2, 4, 1e-4)(step)), rel=1e-6)


def test_unported_optimizers_raise():
    """Every optimizer JAX's get_optimizer takes is ported (its parity:
    tests/test_torch_optim.py); the names JAX refuses raise its ValueError."""
    for name in ("lion", "sgd", "prodigy", "dadaptadam", "dadaptlion"):
        assert isinstance(toptim.get_optimizer(name, toptim.get_lr_schedule("constant", 1e-3, 10)), toptim.Optimizer)
    for name in ("dadaptsgd", "rmsprop"):
        with pytest.raises(ValueError):
            joptim.get_optimizer(name, joptim.get_lr_schedule("constant", 1e-3, 10))
        with pytest.raises(ValueError):
            toptim.get_optimizer(name, toptim.get_lr_schedule("constant", 1e-3, 10))


# ---------------------------------------------------------------------------
# the slice: ESD steps, port vs JAX
# ---------------------------------------------------------------------------


SETTINGS = [
    dict(target="sky", positive="blue sky", negative="grey sky", action="enhance", guidance_scale=2.0, resolution=64),
    dict(target="person", positive="old person", unconditional="person", action="erase", resolution=64),
]


@pytest.fixture(scope="module")
def slice_setup():
    cfg = junet.UNetConfig.tiny_xl()
    model = junet.UNet2DConditionModel(cfg)
    added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
                        jnp.zeros((1, SEQ, CTX)), added_cond_kwargs=added)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    port = port.eval().requires_grad_(False)

    jsites = jlora.create_sites(params, rank=2, alpha=1.0, train_method="full")
    jlp = jlora.init_lora_params(jax.random.PRNGKey(1), jsites)
    # non-zero up factors, so the first step's gradient reaches the downs too
    jlp = jax.tree.map(lambda a: jnp.asarray(a), jlp)
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, train_method="full")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]

    embeds = {}

    def emb(prompt):
        if prompt not in embeds:
            r = np.random.default_rng(zlib.crc32(prompt.encode()))
            embeds[prompt] = (0.5 * r.standard_normal((SEQ, CTX)).astype(np.float32),
                              0.5 * r.standard_normal((32,)).astype(np.float32))
        return embeds[prompt]

    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SETTINGS],
                                   lambda p: tuple(jnp.asarray(x) for x in emb(p)))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                   lambda p: tuple(torch.from_numpy(x) for x in emb(p)))
    return model, params, port, jsites, jlp, tsites, jbank, tbank


def _jax_draws(key, schedule, n_pairs):
    """The port's Draws from the JAX step key, exactly as ``warm_draw`` and the
    Euler-A step draw them."""
    k_pair, k_t, k_noise, k_warm = jax.random.split(key, 4)
    pair = int(jax.random.randint(k_pair, (), 0, n_pairs))
    t_to = int(jax.random.randint(k_t, (), 1, MAX_STEPS))
    lat0 = np.array(jsampling.get_initial_latents(k_noise, schedule, 1, 64, 64))
    noise, k = [], k_warm
    for _ in range(t_to):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, lat0.shape, dtype=jnp.float32)))
    return tesd.Draws(pair, t_to, torch.from_numpy(lat0), torch.from_numpy(np.stack(noise)))


@pytest.mark.parametrize("train_cfg", [1.0, 2.0])
def test_esd_steps_match_jax(slice_setup, train_cfg):
    xl_esd_steps_match_jax(slice_setup, train_cfg)


def xl_esd_steps_match_jax(slice_setup, train_cfg, route=(True, True), seeds=(11, 12)):
    """Steps of the port and of the JAX package from the same state on the
    ``(student_overlay, overlay_warmup)`` route."""
    model, params, port, jsites, jlp, tsites, jbank, tbank = slice_setup
    student_overlay, overlay_warmup = route
    jsched = jscheduler("euler_a")
    jschedule = jsched.set_timesteps(MAX_STEPS)
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    ecfg = jesd.ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=64, width=64,
                          batch_size=1, student_overlay=student_overlay, overlay_warmup=overlay_warmup,
                          remat_unet=False)
    add = jsampling.get_add_time_ids(64, 64)

    def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
        return model.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

    jstep = jesd.make_esd_train_step(unet_apply, jsites, jsched, jschedule, jopt, ecfg,
                                     add_time_ids=jnp.asarray(add))

    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    tsched = tscheduler("euler_a")
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    tstep = tesd.make_esd_train_step(
        port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
        tesd.ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=train_cfg, height=64, width=64,
                       student_overlay=student_overlay, overlay_warmup=overlay_warmup),
        add_time_ids=torch.from_numpy(add),
    )
    tstate = topt.init(toptim.flat_params(tsites, tlp))

    lp = jax.tree.map(jnp.array, jlp)  # the JAX step donates its inputs
    jstate = jopt.init(lp)
    before = tlora.state_dict_numpy(tsites, tlp)
    for i, seed in enumerate(seeds):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, jschedule, 2)
        lp, jstate, jm = jstep(params, lp, jstate, key, jbank)
        tm = tstep(tstate, tbank, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
        want = jlora.state_dict_numpy(jsites, lp)
        got = tlora.state_dict_numpy(tsites, tlp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=f"step {i}: {k}")
    moved = max(np.abs(got[k] - before[k]).max() for k in got)
    assert moved > 5e-3  # two lr-1e-2 Adam steps: the comparison is not of frozen factors


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _tiny_config(path, iterations=4, per_steps=2):
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-tiny-xl.yaml"))
    cfg.prompts_file = os.path.join(REPO, cfg.prompts_file)
    cfg.save.path = str(path)
    cfg.save.per_steps = per_steps
    cfg.train.iterations = iterations
    cfg.logging.verbose = False
    return cfg


def test_trainer_saves_the_jax_key_set_and_resumes_bit_identically(tmp_path):
    cfg = _tiny_config(tmp_path / "full")
    prompts = tprompts.load_prompts_from_yaml(cfg.prompts_file)
    res = ttrainer.train(cfg, prompts, rank=2, device="cpu")
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    files = sorted(os.listdir(tmp_path / "full"))
    assert files == ["tinyxl_slider_2steps.safetensors", "tinyxl_slider_last.safetensors",
                     "tinyxl_slider_metrics.jsonl", "tinyxl_slider_resume.pt"]
    saved = tst.load_file(str(tmp_path / "full" / "tinyxl_slider_last.safetensors"))

    # the JAX trainer saves the state dict of its sites over the same tiny-xl UNet
    jcfg = junet.UNetConfig.tiny_xl()
    shapes = jax.eval_shape(
        lambda: junet.UNet2DConditionModel(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)),
            added_cond_kwargs={"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))})["params"])
    jsites = jlora.create_sites(shapes, rank=2, alpha=1.0, train_method="full")
    jkeys = {f"{s.lora_name}.{k}" for s in jsites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    assert set(saved) == jkeys
    assert all(saved[k].dtype == torch.float32 for k in saved)
    ups = [v for k, v in saved.items() if k.endswith("lora_up.weight")]
    assert all(u.abs().max() > 0 for u in ups)  # up starts at zero and moved

    # resume from the step-2 checkpoint: steps 3.. give the uninterrupted result
    cfg2 = _tiny_config(tmp_path / "resumed")
    res2 = ttrainer.train(cfg2, prompts, rank=2, device="cpu",
                          resume_from=str(tmp_path / "full" / "tinyxl_slider_resume.pt"))
    assert res2.losses == res.losses[3:]
    resumed = tst.load_file(str(tmp_path / "resumed" / "tinyxl_slider_last.safetensors"))
    for k, v in saved.items():
        assert torch.equal(resumed[k], v), k


def test_debug_nans_raises_at_the_first_non_finite_step(slice_setup, tmp_path, monkeypatch):
    """``tpu.debug_nans``: a tiny-xl step whose prompt embeddings hold a NaN
    raises ``FloatingPointError`` before the update (JAX stops at its first
    NaN); without the flag the same step runs on and leaves NaN factors. The
    trainer passes the flag and names the step."""
    _, _, port, _, jlp, tsites, _, tbank = slice_setup
    nan_bank = dataclasses.replace(tbank, text=tbank.text.clone())
    nan_bank.text[:, :, 0, 0] = float("nan")
    tsched = tscheduler("euler_a")
    schedule = tsched.set_timesteps(MAX_STEPS)
    draws = _jax_draws(jax.random.PRNGKey(11), schedule, 2)
    for debug_nans in (True, False):
        tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(tsites, jlp), tsites)
        for leaf in tlp.values():
            for t in leaf.values():
                t.requires_grad_(True)
        topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
        step = tesd.make_esd_train_step(
            port, tsites, tlp, tsched, schedule, topt,
            tesd.ESDConfig(max_denoising_steps=MAX_STEPS, height=64, width=64), add_time_ids=torch.from_numpy(
                tsampling.get_add_time_ids(64, 64)), debug_nans=debug_nans)
        before = tlora.state_dict_numpy(tsites, tlp)
        state = topt.init(toptim.flat_params(tsites, tlp))
        if debug_nans:
            with pytest.raises(FloatingPointError, match="non-finite"):
                step(state, nan_bank, draws=draws)
            after = tlora.state_dict_numpy(tsites, tlp)
            assert all(np.array_equal(after[k], before[k]) for k in before)  # no update was made
        else:
            m = step(state, nan_bank, draws=draws)
            assert not np.isfinite(float(m["loss"]))
    cfg = _tiny_config(tmp_path)
    cfg.tpu.debug_nans = True
    real_bank = tesd.build_prompt_bank

    def nan_prompt_bank(*a, **k):
        bank = real_bank(*a, **k)
        bank.text[:, :, 0, 0] = float("nan")
        return bank

    monkeypatch.setattr(tesd, "build_prompt_bank", nan_prompt_bank)
    prompts = tprompts.load_prompts_from_yaml(cfg.prompts_file)
    with pytest.raises(FloatingPointError, match="step 0: non-finite"):
        ttrainer.train(cfg, prompts, rank=2, device="cpu", save_file=False)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """Meshes are ported (tests/test_torch_mesh_trainers.py): in one
    process, as on one JAX device, the mesh knobs train the one-device step,
    and a world of processes without a coordinator cannot be joined; the int8 base trains
    (tests/test_torch_quant_train.py) under JAX's rules — DoRA over an int8
    base, or on the dual-tree W8A8 warm-up, raises — and the ESD knobs train
    (tests/test_torch_esd_knobs.py), with the JAX trainer's ValueErrors for
    their invalid combinations."""
    prompts = tprompts.load_prompts_from_yaml(os.path.join(REPO, "data", "prompts-tiny.yaml"))
    for knob, match in (("quantize_base", "requires full-precision base magnitudes"),
                        ("w8a8_warmup", "rides the LoRA overlay on the int8 warm-up copy")):
        cfg = _tiny_config(tmp_path)
        setattr(cfg.tpu, knob, True)
        with pytest.raises(NotImplementedError, match=match):
            ttrainer.train(cfg, prompts, peft_type="dora", device="cpu")
    one = ttrainer.train(_tiny_config(tmp_path, iterations=1), prompts, device="cpu", save_file=False)
    for knobs in (dict(mesh_model=2), dict(mesh_data=4), dict(sequence_parallel=True)):
        cfg = _tiny_config(tmp_path, iterations=1)
        for k, v in knobs.items():
            setattr(cfg.tpu, k, v)
        assert ttrainer.train(cfg, prompts, device="cpu", save_file=False).losses == one.losses
    cfg = _tiny_config(tmp_path)
    cfg.tpu.num_processes = 2
    with pytest.raises(ValueError, match="coordinator_address"):
        ttrainer.train(cfg, prompts, device="cpu")
    for knobs, match in ((dict(share_warmup=True), "share_warmup needs"),
                         (dict(pipeline_warmup=True, samples_per_step=2), "pipeline_warmup supports"),
                         (dict(fuse_teacher_student=True, samples_per_step=2), "fuse_teacher_student supports")):
        cfg = _tiny_config(tmp_path)
        for k, v in knobs.items():
            setattr(cfg.tpu, k, v)
        with pytest.raises(ValueError, match=match):
            ttrainer.train(cfg, prompts, device="cpu")
    cfg = _tiny_config(tmp_path)
    cfg.tpu.fuse_teacher_student, cfg.train.cfg = True, 2.0
    with pytest.raises(ValueError, match="guidance == 1"):
        ttrainer.train(cfg, prompts, device="cpu")
    cfg = _tiny_config(tmp_path)
    cfg.tpu.fuse_teacher_student = True
    with pytest.raises(ValueError, match="LoRA overlay only"):
        ttrainer.train(cfg, prompts, peft_type="dora", device="cpu")
    cfg = _tiny_config(tmp_path)
    cfg.tpu.pipeline_warmup = True
    dyn = [dataclasses.replace(p, dynamic_resolution=True) for p in prompts]
    with pytest.raises(ValueError, match="dynamic_resolution"):
        ttrainer.train(cfg, dyn, device="cpu")
    # the merged routes train since they were ported; the JAX trainer's refusals of them stay
    cfg = _tiny_config(tmp_path)
    cfg.tpu.student_overlay, cfg.tpu.overlay_warmup = False, True
    with pytest.raises(ValueError, match="requires tpu.student_overlay"):
        ttrainer.train(cfg, prompts, device="cpu")
    cfg = _tiny_config(tmp_path)
    cfg.tpu.student_overlay = True
    with pytest.raises(NotImplementedError, match="LoRA only"):
        ttrainer.train(cfg, prompts, peft_type="dora", device="cpu")
    with pytest.raises(ValueError, match="peft_type"):
        ttrainer.train(_tiny_config(tmp_path), prompts, peft_type="lokr", device="cpu")
    # SD1/SD2 trains since the SD slice (tests/test_torch_sd_train.py); a path
    # on disk in either family loads when it is a diffusers directory or a
    # checkpoint file (tests/test_torch_loaders.py), and any other path raises
    for name in ("tiny", "tiny-xl"):
        cfg = _tiny_config(tmp_path)
        cfg.pretrained_model.name_or_path = str(tmp_path / name)
        (tmp_path / name).mkdir(exist_ok=True)
        with pytest.raises(ValueError, match="neither a diffusers directory"):
            ttrainer.train(cfg, prompts, device="cpu")


def test_train_lora_api_writes_prompts_and_returns_the_state_dict(tmp_path):
    """``train_lora`` writes its prompts YAML beside the config (read back by
    the port's YAML reader) and returns the reference-schema state dict."""
    text = open(os.path.join(REPO, "data", "config-tiny-xl.yaml")).read()
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"')
    config = tmp_path / "config.yaml"
    config.write_text(text)
    sd = tcli.train_lora("person", "old person", "young person", "", steps=2, rank=2, device="cpu",
                         resolution=64, config_file=str(config))
    written = tprompts.load_prompts_from_yaml(str(tmp_path / "prompts-xl.yaml"))
    assert [p.model_dump() for p in written] == [tprompts.PromptSettings.from_dict(dict(
        target="person", positive="old person", negative="young person", unconditional="", neutral="person",
        action="enhance", resolution=64, dynamic_resolution=False, batch_size=1)).model_dump()]
    assert len(sd) == 3 * 32 and all(k.startswith("lora_unet_") for k in sd)
    assert not any(f.endswith(".safetensors") for _, _, fs in os.walk(tmp_path / "out") for f in fs)


def test_cli_parser_and_save_name():
    args = tcli.build_parser().parse_args(["--config_file", "c.yaml", "--alpha", "1"])
    assert (args.device, args.rank, args.peft_type, args.resume_from) == ("cuda", 4, "lora", None)
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", "config-xl.yaml"))
    tcli._decorate(cfg, 1.0, 4)
    assert cfg.save.name == "slider_alpha1.0_rank4_full" and cfg.save.path == "./models/slider_alpha1.0_rank4_full"


def test_sampling_helpers_match_jax():
    sched_t, sched_j = tscheduler("euler_a"), jscheduler("euler_a")
    st, sj = sched_t.set_timesteps(12), sched_j.set_timesteps(12)
    for t_to in range(1, 12):
        assert tsampling.current_train_timestep(t_to, 12) == int(jsampling.current_train_timestep(t_to, 12))
    noise = np.random.default_rng(2).standard_normal((2, 4, 8, 8)).astype(np.float32)
    got = tsampling.get_initial_latents(st, 2, 64, 64, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), noise * float(sj.init_noise_sigma), rtol=1e-6)
