"""SD3 checkpoints and the SD3 int8 base in the port against the JAX package,
on the CPU.

* a tiny SD3 diffusers directory (``_sd3_assets.write_tiny_sd3_dir``) and an
  ``*_incl_clips`` single file written by JAX's ``export_sd3_checkpoint``
  load in both packages' ``load_models_sd3`` to the same trees, bit for bit
  (the single file's 2·dim AdaLN heads swapped on the way in); the VAE
  config's ``shift_factor`` and missing quant convs;
* the port's ``export_sd3_mmdit`` / ``export_sd3_checkpoint`` are JAX's dicts
  bit for bit and its written file JAX's byte for byte; export → the port's
  ``ldm_convert`` gives back the model exactly; ``cli/export_single_file
  --sd3`` with a slider baked in writes the JAX CLI's file byte for byte;
* a single file without the CLIP towers is refused by both loaders;
* ``cli/quantize_checkpoint --family sd3`` in both packages writes the same
  artifact (tensors and metadata), which both loaders read as ``--base``;
* the int8 ESD step (``quantize_base``; the dual-tree ``w8a8_warmup``) on the
  tiny MMDiT against JAX's (fp32, within 2e-4), and the int8 service
  (``quantize_base`` within 1 of 255, ``w8a8`` within the W8A8 bound of
  tests/test_torch_quant_serve.py) against JAX's.

Tiny widths hold no Linear of 65,536 elements, so both packages quantize
with a limit of 1 element here (the JAX package's own tests do the same)."""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu import serve as jserve
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.cli import export_single_file as jexport_cli
from sliders_conceptmod_tpu.cli import quantize_checkpoint as jqc
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu.diffusion import flow_match as jflow
from sliders_conceptmod_tpu.io import ldm_export as jle
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import esd_sd3 as jesd3
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.cli import export_single_file as texport_cli
from sliders_conceptmod_tpu_torch.cli import quantize_checkpoint as tqc
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.io import ldm_convert as tldm
from sliders_conceptmod_tpu_torch.io import ldm_export as tle
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_jax_tree, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, read_metadata
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import mmdit as tmmdit
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import esd_sd3 as tesd3
from sliders_conceptmod_tpu_torch.train import optim as toptim
from _sd3_assets import STEP_TOL, emb, random_mmdit, write_sd3_slider, write_tiny_sd3_dir
from test_torch_quant import _quantized_port
from test_torch_sd3_esd import MAX_STEPS, SETTINGS, _draws
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

SERVE_PIXEL = {"quantize_base": (1, 0.05), "w8a8": (12, 1.5)}  # tests/test_torch_quant_serve.py's bounds


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd3_io")
    base = write_tiny_sd3_dir(root)
    _, params, _ = random_mmdit()
    slider = write_sd3_slider(root / "sd3_slider_full_rank2_alpha1.safetensors", params)
    return dict(root=root, base=str(base), slider=slider)


@pytest.fixture
def min_elems_1(monkeypatch):
    """Both packages quantize every Linear / Dense of the tiny models."""
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    for name in ("quantize_host_tree", "quantize_init", "quantize_params"):
        monkeypatch.setattr(jquant, name, functools.partial(getattr(jquant, name), min_elems=1))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_same_tree(module, jtree):
    got = dict(_leaves(to_jax_tree(module)))
    want = {p: np.asarray(v) for p, v in _leaves(jtree)}
    assert set(got) == set(want)
    for p, v in want.items():
        assert np.array_equal(got[p].float().numpy() if got[p].dtype != torch.int8 else got[p].numpy(), v), p


def test_diffusers_dir_loads_bit_equal_to_jax(assets):
    _, jtes, jtr, _ = jfactory.load_models_sd3(assets["base"])
    _, ttes, ttr, sched, vae = tfactory.load_models_sd3(assets["base"], device="cpu", with_vae=True)
    assert isinstance(sched, tflow.FlowMatchScheduler) and sched.shift == 3.0
    assert ttr.config == tmmdit.MMDiTConfig.tiny()
    assert_same_tree(ttr, jtr.params)
    for t, j in zip(ttes, jtes):
        assert_same_tree(t.model, j.params)
    jvae = jfactory._load_or_init_vae(assets["base"], "sd3", jnp.float32)
    assert_same_tree(vae, jvae.params)
    assert (vae.config.shift_factor, vae.config.scaling_factor) == (jvae.config.shift_factor,
                                                                    jvae.config.scaling_factor) == (0.0609, 1.5305)
    assert vae.quant_conv is None and vae.post_quant_conv is None and vae.config.latent_channels == 16


def test_incl_clips_single_file_loads_bit_equal_and_round_trips(tmp_path):
    _, jtes, jtr, _ = jfactory.load_models_sd3("tiny-sd3")
    path = str(tmp_path / "tiny-sd3_incl_clips.safetensors")
    jle.save_ldm_checkpoint(path, jle.export_sd3_checkpoint(jtr.params, jtes[0].params, jtes[1].params))
    _, jtes2, jtr2, _ = jfactory.load_models_sd3(path)
    _, ttes, ttr, _ = tfactory.load_models_sd3(path, device="cpu")
    assert_same_tree(ttr, jtr2.params)
    assert_same_tree(ttr, jtr.params)  # the swap undoes the export's swap
    for t, j in zip(ttes, jtes2):
        assert_same_tree(t.model, j.params)
    # the swap is real: norm_out's two halves are exchanged in the file
    sd = load_file(path)
    w = sd["model.diffusion_model.final_layer.adaLN_modulation.1.weight"]
    half = w.shape[0] // 2
    assert torch.equal(w[:half], ttr.norm_out.linear.weight[half:])
    back = tldm.convert_ldm_checkpoint(tle.export_sd3_checkpoint(
        ttr.state_dict(), ttes[0].model.state_dict(), ttes[1].model.state_dict()))
    assert set(back["transformer"]) == set(ttr.state_dict())
    for k, v in ttr.state_dict().items():
        assert torch.equal(back["transformer"][k], v), k


def test_single_file_and_artifact_load_at_their_depth(tmp_path):
    """An MMDiT cut in depth (3 blocks at the tiny widths, its last block
    context-only) loads from an ``*_incl_clips`` single file and from an
    int8 artifact at the depth its blocks hold, bit for bit."""
    import dataclasses

    from sliders_conceptmod_tpu_torch.models import mmdit as tmmdit

    _, ttes, _, _ = tfactory.load_models_sd3("tiny-sd3", device="cpu")
    cfg = dataclasses.replace(tmmdit.MMDiTConfig.tiny(), num_layers=3)
    cut = tfactory.build_module(lambda: tmmdit.SD3Transformer2DModel(cfg), "cpu", torch.float32, 7)
    path = str(tmp_path / "tiny-sd3-cut_incl_clips.safetensors")
    tle.save_ldm_checkpoint(path, tle.export_sd3_checkpoint(cut.state_dict(), ttes[0].model.state_dict(),
                                                            ttes[1].model.state_dict()))
    _, _, got, _ = tfactory.load_models_sd3(path, device="cpu")
    assert got.config.num_layers == 3
    for k, v in cut.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    art = str(tmp_path / "tiny-sd3-cut.int8.safetensors")
    tquant.quantize_module(cut, min_elems=1)
    assert tqc.quant_cache.save_quantized(art, cut) > 0
    _, _, got, _ = tfactory.load_models_sd3(art, device="cpu")
    assert got.config.num_layers == 3 and tquant.is_quantized(got)
    for k, v in cut.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_single_file_without_towers_is_refused(tmp_path):
    _, _, jtr, _ = jfactory.load_models_sd3("tiny-sd3")
    path = str(tmp_path / "tiny-sd3.safetensors")
    jle.save_ldm_checkpoint(path, jle.export_sd3_mmdit(jtr.params))
    with pytest.raises(ValueError, match="no bundled text encoders"):
        jfactory.load_models_sd3(path)
    with pytest.raises(ValueError, match="no bundled text encoders"):
        tfactory.load_models_sd3(path, device="cpu")


def test_export_sd3_matches_jax_byte_for_byte(assets, tmp_path):
    _, params, port = random_mmdit()
    want = jle.export_sd3_mmdit(params)
    got = tle.export_sd3_mmdit(port.state_dict())
    assert set(got) == set(want) and any(".attn.qkv." in k for k in got)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    jle.save_ldm_checkpoint(str(tmp_path / "jax.safetensors"), want)
    tle.save_ldm_checkpoint(str(tmp_path / "port.safetensors"), got)
    assert (tmp_path / "jax.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()

    def argv(out):
        return ["--base", assets["base"], "--slider", assets["slider"], "--scale", "2", "--output", str(out),
                "--sd3"]

    jexport_cli.main(argv(tmp_path / "jcli.safetensors"))
    texport_cli.main(argv(tmp_path / "tcli.safetensors") + ["--device", "cpu"])
    assert (tmp_path / "jcli.safetensors").read_bytes() == (tmp_path / "tcli.safetensors").read_bytes()


def test_quantize_checkpoint_sd3_matches_jax(assets, tmp_path, min_elems_1, capsys):
    jout, tout = str(tmp_path / "tiny-sd3.jax.int8.safetensors"), str(tmp_path / "tiny-sd3.port.int8.safetensors")
    jqc.run(jqc.build_parser().parse_args(["--base", assets["base"], "--family", "sd3", "--out", jout,
                                           "--precision", "float32"]))
    n = tqc.main(["--base", assets["base"], "--family", "sd3", "--out", tout, "--precision", "float32",
                  "--device", "cpu"])
    assert n > 0 and f"{n} int8 kernels (family=sd3)" in capsys.readouterr().out
    a, b = load_file(jout), load_file(tout)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert read_metadata(jout) == read_metadata(tout)
    # the artifact as --base: the transformer the directory quantizes to, in both packages
    _, _, jtr, _ = jfactory.load_models_sd3(tout, quantize_base=True)
    _, _, ttr, _ = tfactory.load_models_sd3(tout, device="cpu")
    _, _, ref, _ = tfactory.load_models_sd3(assets["base"], device="cpu", quantize_base=True)
    assert len(tquant.quant_scales(ttr)) == n
    assert_same_tree(ttr, jtr.params)
    r = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in (r.standard_normal((1, 16, 8, 8)).astype(np.float32),
                                          np.array([500.0], np.float32),
                                          r.standard_normal((1, 5, 32)).astype(np.float32),
                                          r.standard_normal((1, 32)).astype(np.float32))]
    assert torch.equal(ttr(*args), ref(*args))


ROUTES = ["quantize_base", "w8a8_dual"]


@pytest.mark.parametrize("route", ROUTES)
def test_int8_esd_step_matches_jax(route, min_elems_1):
    model, params, port = random_mmdit()
    rng = np.random.default_rng(5)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jlp = jlora.init_lora_params(jax.random.PRNGKey(1), jsites)
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    jparams = jax.tree.map(jnp.asarray, params)
    qtree, scales = jquant.quantize_params(jparams, min_elems=1)
    plain = lambda p, *a: model.apply({"params": p}, *a)  # noqa: E731
    weight_only = jquant.make_quant_apply(model, scales, jnp.float32)
    w8a8 = jquant.make_quant_apply(model, scales, jnp.float32, act_quant=True)
    if route == "quantize_base":
        japply, jwarm, base, extra = weight_only, None, qtree, ()
        tmodel, twarm = _quantized_port(port, qtree), None
    else:
        japply, jwarm, base, extra = plain, w8a8, jparams, (qtree,)
        tmodel, twarm = port, tquant.quantized_copy(port, act_quant=True, min_elems=1)
    jschedule = jflow.FlowMatchScheduler().set_timesteps(MAX_STEPS)
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    jstep = jesd3.make_sd3_esd_train_step(
        japply, jsites, jschedule, jopt,
        jesd3.SD3ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=7.0, height=64, width=64, remat=False),
        student_overlay=True, overlay_warmup=True, warm_apply=jwarm)
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), grad_clip_norm=0.2)
    tstep = tesd3.make_sd3_esd_train_step(
        tmodel, tsites, tlp, tflow.FlowMatchScheduler().set_timesteps(MAX_STEPS), topt,
        tesd3.SD3ESDConfig(max_denoising_steps=MAX_STEPS, train_cfg_scale=7.0, height=64, width=64, remat=True,
                           student_overlay=True, overlay_warmup=True), warm_transformer=twarm)
    jbank = jesd.build_prompt_bank([jprompts.PromptSettings(**s) for s in SETTINGS],
                                   lambda p: tuple(jnp.asarray(a) for a in emb(p)))
    tbank = tesd.build_prompt_bank([tprompts.PromptSettings.from_dict(s) for s in SETTINGS],
                                   lambda p: tuple(torch.from_numpy(a) for a in emb(p)))
    lp = jax.tree.map(jnp.array, jlp)
    jstate = jopt.init(lp)
    tstate = topt.init(toptim.flat_params(tsites, tlp))
    before = tlora.state_dict_numpy(tsites, tlp)
    key = jax.random.PRNGKey(11)
    lp, jstate, jm = jstep(base, lp, jstate, key, jbank, *extra)
    tm = tstep(tstate, tbank, draws=_draws(key, len(SETTINGS), 1, False))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_TOL, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=STEP_TOL)
    want, got = jlora.state_dict_numpy(jsites, lp), tlora.state_dict_numpy(tsites, tlp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=k)
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 5e-3


@pytest.mark.parametrize("mode", ["quantize_base", "w8a8"])
def test_int8_service_matches_jax(assets, monkeypatch, min_elems_1, mode):
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(jserve, "jnp", proxy)
    monkeypatch.setattr(tserve.SliderService, "weight_dtype", torch.float32)
    kw = dict(image_size=64, steps=3, start_noise=900, **{mode: True})
    jsvc = jserve.SD3SliderService(assets["base"], assets["slider"], microbatch=False, **kw)
    tsvc = tserve.SD3SliderService(assets["base"], assets["slider"], device="cpu", **kw)
    try:
        acts = {m.act_quant for m in tsvc.unet.modules() if isinstance(m, tquant.QuantLinear)}
        assert acts == {mode == "w8a8"}
        assert load_jax_params(tsvc.unet, to_numpy_tree(jsvc.transformer.params)) == []
        monkeypatch.setattr(tsvc, "_draw_latents", lambda seeds: torch.cat([torch.from_numpy(np.array(
            jax.random.normal(jax.random.PRNGKey(s), (1, 16, 8, 8), jnp.float32))) for s in seeds]))
        padded = [("a photo of a person", 1.5, 7, 7.0, "default"), ("a red car", -2.0, 9, 7.0, "default")]
        want = jsvc._sample_group(padded, 7.0, jsvc._resolve("default"))
        got = tsvc._sample_group(padded, 7.0, tsvc._resolve("default"))
        diff = np.abs(np.stack(got).astype(int) - np.stack([np.asarray(w) for w in want]).astype(int))
        print(f"{mode}: pixel gap max {diff.max()}, mean {diff.mean():.3f}")
        assert diff.max() <= SERVE_PIXEL[mode][0] and diff.mean() <= SERVE_PIXEL[mode][1]
    finally:
        tsvc.close()
    cls, kwargs = tserve.service_settings(tserve.build_parser().parse_args(
        ["--slider", "s", "--base", "stabilityai/stable-diffusion-3-medium", f"--{mode}"]))
    assert cls is tserve.SD3SliderService and kwargs[mode]
