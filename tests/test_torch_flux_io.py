"""Flux's loaders, int8 artifact, single-file export, T5 text-encoder part and
notrigger towers in the port against the JAX package, on the CPU.

* a tiny Flux diffusers directory (``_flux_assets.write_tiny_flux_dir``)
  loaded by both packages: the transformer, T5 and CLIP bit-equal, the
  spiece tokenizer's ids equal, one prompt's (T5 text, CLIP pool) within
  2e-4, the VAE's factors;
* BFL single files (schnell and dev, JAX-written) load bit-equal, dev read
  off the tree, the depth off the file's blocks;
* ``quantize_checkpoint --family flux`` writes JAX's artifact (every tensor
  and the metadata) and the artifact loads as ``--base`` in both packages,
  its forward bit-equal to the directory quantized in memory;
* ``export_single_file --flux`` with a slider baked in writes the JAX CLI's
  file byte for byte and reloads through the BFL loader bit-equal to the
  merge;
* a T5 text-encoder part (``lora_te2_encoder_block_…``) bound with
  ``te2_is_t5``: merged weights against JAX's ``TEPart.merged_params``;
* ``cli/train_notrigger --model tiny-flux``: CLIP-L (clip_index 0) and T5
  (1) sliders with the JAX trainer's key set, factor shapes and alphas.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.adapters import slider_file as jsfile
from sliders_conceptmod_tpu.cli import export_single_file as jexport_cli
from sliders_conceptmod_tpu.cli import quantize_checkpoint as jqc
from sliders_conceptmod_tpu.cli import train_notrigger as jnt_cli
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu.io import ldm_export as jle
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.adapters import slider_file as tsfile
from sliders_conceptmod_tpu_torch.cli import export_single_file as texport_cli
from sliders_conceptmod_tpu_torch.cli import quantize_checkpoint as tqc
from sliders_conceptmod_tpu_torch.cli import train_notrigger as tnt_cli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.diffusion import flow_match as tflow
from sliders_conceptmod_tpu_torch.io.jax_params import to_jax_tree
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, read_metadata
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.tokenizer import T5SpmTokenizer
from _flux_assets import FLUX_VAE, STEP_TOL, random_flux, write_flux_slider, write_tiny_flux_dir
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("flux_io")
    base = write_tiny_flux_dir(root)
    _, params, _ = random_flux()
    slider = write_flux_slider(root / "flux_slider_full_rank2_alpha1.safetensors", params)
    return dict(root=root, base=str(base), slider=slider)


@pytest.fixture
def min_elems_1(monkeypatch):
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


def test_diffusers_dir_loads_bit_equal_and_encodes_as_jax(assets):
    jtoks, jenc, jtr, _ = jfactory.load_models_flux(assets["base"])
    ttoks, tenc, ttr, sched = tfactory.load_models_flux(assets["base"], device="cpu")
    assert isinstance(sched, tflow.FlowMatchScheduler) and sched.use_dynamic_shifting
    assert isinstance(ttoks[0], T5SpmTokenizer) and ttoks[0].max_length == 8
    assert_same_tree(ttr, jtr.params)
    clip_params, t5_params = jenc.text_encoder_params
    assert_same_tree(tenc.text_encoders[0], clip_params)
    assert_same_tree(tenc.text_encoders[1], t5_params)
    for prompt in ("a photo of a person, smiling", "a red car at night"):
        assert np.array_equal(ttoks[0]([prompt]), np.asarray(jtoks[0]([prompt])))
        jt, jp = jenc(prompt)
        tt, tp = tenc(prompt)
        assert tt.shape == (8, 32) and tp.shape == (32,)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=STEP_TOL, rtol=0)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=STEP_TOL, rtol=0)
    vae = tfactory.sd3_vae(assets["base"], "cpu", torch.float32)
    jvae = jfactory._load_or_init_vae(assets["base"], "flux", jnp.float32)
    assert_same_tree(vae, jvae.params)
    assert (vae.config.scaling_factor, vae.config.shift_factor) == (FLUX_VAE["scaling_factor"],
                                                                    FLUX_VAE["shift_factor"])


def test_weightless_stand_in_encoder():
    _, enc, tr, _ = tfactory.load_models_flux("tiny-flux", device="cpu")
    assert enc.text_encoders is None
    a, b, c = enc("a cat"), enc("a cat"), enc("a dog")
    assert a[0].shape == (8, 32) and a[1].shape == (32,)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert 0.05 < float(a[0].std()) < 0.2  # N(0, 0.1²)


@pytest.mark.parametrize("dev", [False, True])
def test_bfl_single_file_loads_bit_equal(tmp_path, dev):
    _, params, _ = random_flux(dev=dev)
    path = str(tmp_path / f"tiny-flux1-{'dev' if dev else 'schnell'}.safetensors")
    jle.save_ldm_checkpoint(path, jle.export_flux_bfl(params))
    _, enc, ttr, _ = tfactory.load_models_flux(path, device="cpu")
    _, _, jtr, _ = jfactory.load_models_flux(path)
    assert ttr.config.guidance_embeds == dev and enc.text_encoders is None
    assert_same_tree(ttr, params)
    assert_same_tree(ttr, jtr.params)


def test_bfl_single_file_depth_from_file(tmp_path):
    """A BFL file cut in depth (1 double and 3 single blocks at the tiny
    widths, written by the JAX exporter) loads at the file's depth."""
    _, params, _ = random_flux(num_layers=1, num_single_layers=3)
    path = str(tmp_path / "tiny-flux1-cut.safetensors")
    jle.save_ldm_checkpoint(path, jle.export_flux_bfl(params))
    _, _, ttr, _ = tfactory.load_models_flux(path, device="cpu")
    assert (ttr.config.num_layers, ttr.config.num_single_layers, ttr.config.guidance_embeds) == (1, 3, False)
    assert_same_tree(ttr, params)


def test_int8_artifact_depth_from_file(tmp_path, min_elems_1):
    """An int8 artifact of a transformer cut in depth (1 double and 3 single
    blocks at the tiny widths) loads at the artifact's depth, its forward
    bit-equal to the cut transformer quantized in memory."""
    _, _, port = random_flux(num_layers=1, num_single_layers=3)
    path = str(tmp_path / "tiny-flux-cut.int8.safetensors")
    tquant.quantize_module(port)
    assert tqc.quant_cache.save_quantized(path, port) > 0
    _, _, ttr, _ = tfactory.load_models_flux(path, device="cpu")
    assert (ttr.config.num_layers, ttr.config.num_single_layers) == (1, 3) and tquant.is_quantized(ttr)
    r = np.random.default_rng(1)
    args = [torch.from_numpy(x) for x in (r.standard_normal((1, 16, 16)).astype(np.float32),
                                          np.array([0.5], np.float32), r.standard_normal((1, 8, 32)).astype(np.float32),
                                          r.standard_normal((1, 32)).astype(np.float32), np.zeros((8, 3), np.float32),
                                          np.zeros((16, 3), np.float32))]
    with torch.no_grad():
        assert torch.equal(ttr(*args), port(*args))


def test_quantize_checkpoint_flux_matches_jax(assets, tmp_path, min_elems_1, capsys):
    jout, tout = str(tmp_path / "tiny-flux.jax.int8.safetensors"), str(tmp_path / "tiny-flux.port.int8.safetensors")
    jqc.run(jqc.build_parser().parse_args(["--base", assets["base"], "--family", "flux", "--out", jout,
                                           "--precision", "float32"]))
    n = tqc.main(["--base", assets["base"], "--family", "flux", "--out", tout, "--precision", "float32",
                  "--device", "cpu"])
    assert n > 0 and f"{n} int8 kernels (family=flux)" in capsys.readouterr().out
    a, b = load_file(jout), load_file(tout)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert read_metadata(jout) == read_metadata(tout)
    _, _, jtr, _ = jfactory.load_models_flux(tout, quantize_base=True)
    _, _, ttr, _ = tfactory.load_models_flux(tout, device="cpu")
    _, _, ref, _ = tfactory.load_models_flux(assets["base"], device="cpu", quantize_base=True)
    assert len(tquant.quant_scales(ttr)) == n and tquant.is_quantized(ttr)
    assert_same_tree(ttr, jtr.params)
    r = np.random.default_rng(0)
    args = [torch.from_numpy(x) for x in (r.standard_normal((1, 16, 16)).astype(np.float32),
                                          np.array([0.5], np.float32), r.standard_normal((1, 8, 32)).astype(np.float32),
                                          r.standard_normal((1, 32)).astype(np.float32), np.zeros((8, 3), np.float32),
                                          np.zeros((16, 3), np.float32))]
    with torch.no_grad():
        assert torch.equal(ttr(*args), ref(*args))


@pytest.mark.parametrize("half", [False, True])
def test_export_flux_matches_jax_and_reloads(assets, tmp_path, half):
    def argv(out):
        return ["--base", assets["base"], "--slider", assets["slider"], "--scale", "2", "--output", str(out),
                "--flux"] + (["--half"] if half else [])

    jexport_cli.main(argv(tmp_path / "jcli.safetensors"))
    texport_cli.main(argv(tmp_path / "tiny-tcli.safetensors") + ["--device", "cpu"])
    assert (tmp_path / "jcli.safetensors").read_bytes() == (tmp_path / "tiny-tcli.safetensors").read_bytes()
    sd = load_file(str(tmp_path / "tiny-tcli.safetensors"))
    assert any(k.endswith("linear1.weight") for k in sd) and any(".img_attn.qkv." in k for k in sd)
    if half:
        return
    _, _, merged, _ = tfactory.load_models_flux(str(tmp_path / "tiny-tcli.safetensors"), device="cpu")
    _, _, base, _ = tfactory.load_models_flux(assets["base"], device="cpu")
    from sliders_conceptmod_tpu_torch.adapters import lora as tlora
    from sliders_conceptmod_tpu_torch.cli.generate_images_sd3 import sd3_slider

    sites, lp = sd3_slider(base, assets["slider"], tsfile.load_slider_file(assets["slider"]).unet)
    want = dict(base.state_dict(), **tlora.merge_lora_params(base, sites, lp, 2.0))
    got = merged.state_dict()
    assert set(got) == set(want) and len(sites) == 8
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_t5_text_encoder_part_matches_jax(assets, tmp_path):
    _, jenc, _, _ = jfactory.load_models_flux(assets["base"])
    _, tenc, _, _ = tfactory.load_models_flux(assets["base"], device="cpu")
    t5_params = jenc.text_encoder_params[1]
    sites = jlora.create_sites(t5_params, rank=2, alpha=1.0, target_replace=["T5Attention"], prefix="lora_te2",
                               train_method="t5attn", name_path_prefix=jsfile.T5_NAME_PATH_PREFIX)
    assert sites and all(s.lora_name.startswith("lora_te2_encoder_block_") for s in sites)
    rng = np.random.default_rng(3)
    lp = jax.tree.map(lambda a: jnp.asarray(0.5 * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(3), sites))
    path = str(tmp_path / "te2.safetensors")
    jlora.save_weights(path, sites, lp)
    jparts = jsfile.load_slider_file(path, jenc.text_encoder_params, te2_is_t5=True)
    tparts = tsfile.load_slider_file(path, tenc.text_encoders, te2_is_t5=True)
    assert [p.index for p in tparts.te_parts] == [1] and tparts.unet is None
    assert [s.lora_name for s in tparts.te_parts[0].sites] == [s.lora_name for s in jparts.te_parts[0].sites]
    want = dict(_leaves(jparts.te_parts[0].merged_params(t5_params, 1.5)))
    t5 = tenc.text_encoders[1]
    merged = tparts.te_parts[0].merged_params(1.5)
    from sliders_conceptmod_tpu_torch.adapters import lora as tlora

    with tlora.model_lock(t5), tlora.merged_weights(t5, merged):
        got = dict(_leaves(to_jax_tree(t5)))
    for p, v in want.items():
        np.testing.assert_allclose(got[p].numpy(), np.asarray(v), atol=1e-6, rtol=0, err_msg=str(p))
    with pytest.raises(ValueError):  # a te part on the stand-in encoder has no tower to bind to
        tsfile.load_slider_file(path, None, te2_is_t5=True)


@pytest.mark.parametrize("clip_index", [0, 1])
def test_notrigger_tiny_flux_matches_jax(tmp_path, clip_index):
    def config(mod):
        cfg = mod.load_config_from_yaml(os.path.join(REPO, "data", "config-notrigger-xl.yaml"))
        cfg.train.iterations = 3
        cfg.train.lr = 1.0
        cfg.save.path = str(tmp_path)
        cfg.logging.verbose = False
        return cfg

    want = jnt_cli.train(config(jconfig), positive="smiling", negative="frowning", clip_index=clip_index,
                         peft_type="lora", rank=2, model="tiny-flux", save_file=False)
    got = tnt_cli.train(config(tconfig), positive="smiling", negative="frowning", clip_index=clip_index,
                        peft_type="lora", rank=2, model="tiny-flux", save_file=False, device="cpu")
    prefix = "lora_te1_text_model_encoder_" if clip_index == 0 else "lora_te2_encoder_block_"
    assert set(got) == set(want) and all(k.startswith(prefix) for k in got)
    for k in want:  # the factors start from different draws: shapes and the alphas
        assert got[k].shape == np.asarray(want[k]).shape, k
        if k.endswith(".alpha"):
            assert float(got[k]) == float(np.asarray(want[k])), k
        else:
            assert np.isfinite(got[k]).all(), k
