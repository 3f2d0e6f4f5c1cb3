"""The port's SD1/SD2 textual-slider training slice against the JAX package's.

* the SD configs (``UNetConfig.sd15`` / ``sd21`` / ``tiny``, the SD1/SD2
  CLIP towers, ``VAEConfig.sd``) equal the JAX package's, and their
  full-width structures (meta device) equal ``jax.eval_shape`` of the JAX
  inits, path by path;
* the tiny SD UNet — and a variant whose mid block has one head of 160,
  which takes the k-grid attention — against the JAX UNet through the weight
  bridge, nothing left over (fp32, 2e-4);
* ``clip_skip`` 1/2 (and None) through ``factory.encode_prompts`` against
  the JAX factory's;
* (the DDIM ESD steps against the JAX step are tests/test_torch_sd_esd.py)
* ``cli/train_lora.py`` on ``data/config-tiny.yaml`` through ``main``: the
  saved key set is the JAX trainer's, a resumed run is bit-identical; its
  parser and save name are the JAX CLI's;
* ``factory.load_models``: the family rule, v-prediction, the refusals;
  ``factory.load_for_training`` and ``unet_config_for``: the family's UNet,
  encoder (``clip_skip``, pooled or not) and ``add_time_ids``.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.cli import train_lora as jcli
from sliders_conceptmod_tpu.models import clip as jclip
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models import tokenizer as jtok
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.models import vae as jvae
from sliders_conceptmod_tpu_torch.cli import train_lora as tcli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.io.jax_params import jax_layout_shapes, load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import clip as tclip
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.models import vae as tvae
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-4)
STEP_TOL = 2e-4
MAX_STEPS, SEQ, CTX = 3, 11, 32
# the tiny SD topology with a 160-channel single-head mid block: head dim 160
D160 = dict(block_out_channels=(32, 160), attention_head_dim=1)


def _unet_configs(variant):
    if variant == "tiny":
        return junet.UNetConfig.tiny(), tunet.UNetConfig.tiny()
    return dataclasses.replace(junet.UNetConfig.tiny(), **D160), dataclasses.replace(tunet.UNetConfig.tiny(), **D160)


@functools.lru_cache(maxsize=None)
def _random_unet(variant, seed):
    """JAX params (N(0, 0.1²) leaves) and the port's UNet holding them (made
    once per process; callers only read them)."""
    jcfg, tcfg = _unet_configs(variant)
    model = junet.UNet2DConditionModel(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, SEQ, CTX)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params["params"])
    port = tunet.UNet2DConditionModel(tcfg)
    assert load_jax_params(port, to_numpy_tree(params)) == []  # the whole tree, nothing left over
    return model, params, port.eval().requires_grad_(False)


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------------
# configs and models
# ---------------------------------------------------------------------------


def test_sd_configs_match_jax_and_count_attentions_by_head_dim():
    for name in ("sd15", "sd21", "tiny"):
        assert dataclasses.asdict(getattr(tunet.UNetConfig, name)()) == dataclasses.asdict(
            getattr(junet.UNetConfig, name)())
    for name in ("sd15_te", "sd2_te"):
        assert dataclasses.asdict(getattr(tclip.CLIPTextConfig, name)()) == dataclasses.asdict(
            getattr(jclip.CLIPTextConfig, name)())
    jsd, tsd = dataclasses.asdict(jvae.VAEConfig.sd()), dataclasses.asdict(tvae.VAEConfig.sd())
    assert {k: jsd[k] for k in tsd} == tsd and tsd["scaling_factor"] == 0.18215
    # diffusers' attention_head_dim means heads: SD1.5's 8 heads give head dims 40, 80 and 160
    assert tunet.UNetConfig.sd15().attention_calls_by_head_dim() == {40: 10, 80: 10, 160: 12}
    assert tunet.UNetConfig.sd15().attention_calls_per_forward() == 32
    assert tunet.UNetConfig.sd21().attention_calls_by_head_dim() == {64: 32}
    assert tunet.UNetConfig.sdxl().attention_calls_by_head_dim() == {64: 140}
    assert dataclasses.replace(tunet.UNetConfig.tiny(), **D160).attention_calls_by_head_dim() == {32: 6, 160: 2}


@pytest.mark.parametrize("family", ["unet_sd15", "unet_sd21", "clip_sd15_te", "clip_sd2_te", "vae_sd"])
def test_full_width_sd_structures_match_jax_eval_shape(family):
    """Every full-width parameter's JAX path and shape, from the port's module
    on the meta device, equals ``jax.eval_shape`` of the JAX package's init."""
    init = {
        "unet_sd15": lambda: junet.UNet2DConditionModel(junet.UNetConfig.sd15()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 2, 768))),
        "unet_sd21": lambda: junet.UNet2DConditionModel(junet.UNetConfig.sd21()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 2, 1024))),
        "clip_sd15_te": lambda: jclip.CLIPTextEncoder(jclip.CLIPTextConfig.sd15_te()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)),
        "clip_sd2_te": lambda: jclip.CLIPTextEncoder(jclip.CLIPTextConfig.sd2_te()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)),
        "vae_sd": lambda: jvae.AutoencoderKL(jvae.VAEConfig.sd()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))),
    }[family]
    port = {
        "unet_sd15": lambda: tunet.UNet2DConditionModel(tunet.UNetConfig.sd15()),
        "unet_sd21": lambda: tunet.UNet2DConditionModel(tunet.UNetConfig.sd21()),
        "clip_sd15_te": lambda: tclip.CLIPTextEncoder(tclip.CLIPTextConfig.sd15_te()),
        "clip_sd2_te": lambda: tclip.CLIPTextEncoder(tclip.CLIPTextConfig.sd2_te()),
        "vae_sd": lambda: tvae.AutoencoderKL(tvae.VAEConfig.sd()),
    }[family]
    want = _flat_shapes(jax.eval_shape(init)["params"])
    with torch.device("meta"):
        assert jax_layout_shapes(port()) == want


@pytest.mark.parametrize("variant", ["tiny", "d160"])
def test_tiny_sd_unet_matches_jax(variant):
    model, params, port = _random_unet(variant, seed=1)
    rng = np.random.default_rng(2)
    sample = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, SEQ, CTX)).astype(np.float32)
    t = np.asarray([3.0, 977.0], np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)))
    before = kg.flash_attention_kgrid_fwd.launches
    with torch.no_grad():
        got = port(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert kg.flash_attention_kgrid_fwd.launches == before  # the CPU takes the plain versions


@pytest.mark.parametrize("clip_skip", [None, 1, 2])
def test_clip_skip_encode_matches_jax(clip_skip):
    jcfg, tcfg = jclip.CLIPTextConfig.tiny(), tclip.CLIPTextConfig.tiny()
    model = jclip.CLIPTextEncoder(jcfg)
    tok = jtok.load_tokenizer("", component="tokenizer")
    prompts = ["a photo of a person, smiling", "person"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                          model.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"])
    want = np.asarray(jfactory.encode_prompts(jfactory.TextEncoderBundle(model, params, tok), prompts, clip_skip))
    port = tclip.CLIPTextEncoder(tcfg)
    assert load_jax_params(port, to_numpy_tree(params)) == []
    bundle = tfactory.TextEncoderBundle(port.eval(), tfactory.load_tokenizer("", component="tokenizer"))
    got = tfactory.encode_prompts(bundle, prompts, clip_skip)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    out = port(torch.from_numpy(tok(prompts).astype(np.int64)))
    if clip_skip == 2:  # the pre-LN state before the last layer, not the final LN output
        assert torch.equal(got, out.hidden_states[-2])
    else:
        assert torch.equal(got, out.last_hidden_state)


# ---------------------------------------------------------------------------
# the trainer through the CLI
# ---------------------------------------------------------------------------


def _tiny_yaml(tmp_path):
    """data/config-tiny.yaml saving under ``tmp_path`` every 2 steps."""
    text = open(os.path.join(REPO, "data", "config-tiny.yaml")).read()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{os.path.join(REPO, "data", "prompts-tiny.yaml")}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"').replace("per_steps: 200", "per_steps: 2")
    (tmp_path / "config.yaml").write_text(text.replace("verbose: true", "verbose: false"))
    return str(tmp_path / "config.yaml")


def test_cli_trains_tiny_sd_saves_the_jax_key_set_and_resumes_bit_identically(tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "1", "--rank", "2", "--device", "cpu"]
    res = tcli.main(tcli.build_parser().parse_args(argv))
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    assert {r["timesteps_to"] for r in res.metrics} <= set(range(1, 4))
    out = tmp_path / "out" / "tiny_slider_alpha1.0_rank2_full"
    assert sorted(os.listdir(out)) == [f"tiny_slider_alpha1.0_rank2_full_{s}" for s in (
        "2steps.safetensors", "last.safetensors", "metrics.jsonl", "resume.pt")]
    saved = tst.load_file(str(out / "tiny_slider_alpha1.0_rank2_full_last.safetensors"))
    shapes = jax.eval_shape(lambda: junet.UNet2DConditionModel(junet.UNetConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))["params"])
    jsites = jlora.create_sites(shapes, rank=2, alpha=1.0, train_method="full")
    assert set(saved) == {f"{s.lora_name}.{k}" for s in jsites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    assert all(v.abs().max() > 0 for k, v in saved.items() if k.endswith("lora_up.weight"))

    os.replace(out, tmp_path / "first")
    resumed = tcli.main(tcli.build_parser().parse_args(argv + ["--resume_from", str(tmp_path / "first")]))
    assert resumed.losses == res.losses[3:]
    again = tst.load_file(str(out / "tiny_slider_alpha1.0_rank2_full_last.safetensors"))
    for k, v in saved.items():
        assert torch.equal(again[k], v), k


def test_cli_parser_and_save_name_match_the_jax_cli(monkeypatch, tmp_path):
    argv = ["--config_file", _tiny_yaml(tmp_path), "--alpha", "0.5", "--rank", "8", "--name", "old",
            "--attributes", "male, female"]
    got, want = {}, {}
    monkeypatch.setattr(jcli.trainer, "train", lambda config, prompts, **kw: want.update(c=config, p=prompts, kw=kw))
    monkeypatch.setattr(tcli.trainer, "train", lambda config, prompts, **kw: got.update(c=config, p=prompts, kw=kw))
    jcli.main(jcli.build_parser().parse_args(argv))
    tcli.main(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert (got["c"].save.name, got["c"].save.path) == (want["c"].save.name, want["c"].save.path)
    assert got["c"].save.name == "old_alpha0.5_rank8_full"
    assert (got["c"].network.alpha, got["c"].network.rank) == (want["c"].network.alpha, want["c"].network.rank)
    assert [p.model_dump() for p in got["p"]] == [p.model_dump() for p in want["p"]]
    assert (got["kw"]["rank"], got["kw"]["peft_type"], got["kw"]["device"]) == (8, "lora", "cpu")
    jargs, targs = jcli.build_parser().parse_args(argv), tcli.build_parser().parse_args(argv)
    for flag in ("config_file", "alpha", "rank", "name", "attributes", "peft_type", "resume_from"):
        assert getattr(targs, flag) == getattr(jargs, flag), flag
    assert targs.device == "cuda"


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------


def test_load_models_family_rule_v_prediction_and_refusals(tmp_path):
    for name, v2, family in (("tiny", False, "tiny"), ("runwayml/stable-diffusion-v1-5", False, "sd15"),
                             ("stabilityai/stable-diffusion-2-1", False, "sd21"), ("my-sd2-model", False, "sd21"),
                             ("runwayml/stable-diffusion-v1-5", True, "sd21"), ("tiny-xl", False, "tiny-xl"),
                             ("stabilityai/stable-diffusion-xl-base-1.0", False, "sdxl")):
        assert tfactory._family(name, v2) == family == jfactory._family_from_path(name, v2)
    tok, te, unet, sched, vae = tfactory.load_models("tiny", v_pred=True, with_vae=True, device="cpu")
    assert unet.config == tunet.UNetConfig.tiny() and te.model.config == tclip.CLIPTextConfig.tiny()
    assert vae.config == tvae.VAEConfig.sd()  # every SD family encodes with the full SD VAE, as in JAX
    assert sched.set_timesteps(3).prediction_type == "v_prediction"
    assert not any(p.requires_grad for p in unet.parameters())
    again = tfactory.load_models("tiny", device="cpu")[2]  # seeded: the same weights twice
    assert all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(), again.state_dict().values()))
    assert tfactory.encode_prompts(te, ["a", "b"], 2).shape == (2, 77, 32)
    with pytest.raises(ValueError, match="neither a diffusers directory"):  # no unet/, not a checkpoint file
        tfactory.load_models(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="load_models_xl"):
        tfactory.load_models("tiny-xl", device="cpu")
    with pytest.raises(ValueError, match="tiny-xl"):
        tfactory.load_models_xl("tiny", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfactory.load_models("tiny")  # the default device is the card: no CPU fallback


def test_load_for_training_picks_the_family_its_unet_and_its_encoder():
    for name, v2, want in (("tiny", False, "tiny"), ("runwayml/stable-diffusion-v1-5", False, "sd15"),
                           ("runwayml/stable-diffusion-v1-5", True, "sd21"), ("tiny-xl", False, "tiny_xl"),
                           ("stabilityai/stable-diffusion-xl-base-1.0", False, "sdxl")):
        assert tfactory.unet_config_for(name, v2) == getattr(tunet.UNetConfig, want)()
    sd = tfactory.load_for_training(tconfig.PretrainedModelConfig("tiny", v_pred=True, clip_skip=2), "ddim",
                                    torch.float32, with_vae=True, device="cpu")
    text, pooled = sd.encode("a photo")
    _, te, _, _ = tfactory.load_models("tiny", device="cpu")
    assert torch.equal(text, tfactory.encode_prompts(te, ["a photo"], 2)[0]) and pooled is None
    assert not sd.is_xl and sd.add_time_ids(256, "cpu") is None and sd.vae.config == tvae.VAEConfig.sd()
    assert sd.scheduler.set_timesteps(3).prediction_type == "v_prediction"
    xl = tfactory.load_for_training(tconfig.PretrainedModelConfig("tiny-xl"), "euler_a", torch.float32, device="cpu")
    text, pooled = xl.encode("a photo")
    assert xl.is_xl and xl.vae is None and xl.unet.config == tunet.UNetConfig.tiny_xl()
    assert text.shape == (77, 32) and pooled.shape == (32,)
    np.testing.assert_array_equal(xl.add_time_ids(512, "cpu").numpy(), [[512, 512, 0, 0, 512, 512]])
