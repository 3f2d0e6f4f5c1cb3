"""The port's Stable Cascade prior (``models/cascade.py``), its weight bridge
(``io/jax_params.py``), its ``prior/`` loader (``io/torch_convert.py::
load_cascade_prior_state``, ``models/factory.py::load_models_cascade``) and
``encode_prompts_cascade`` against the JAX package's, fp32, from the same
weights and inputs made from a numpy seed:

* each block (ResBlock with and without the skip, GlobalResponseNorm,
  TimestepBlock, AttnBlock, the channel norm, the ratio embedding) within
  2e-4 — the ratio embedding at the prior's width 64 within two fp32
  spacings of its largest argument, 10⁴ (the frequency tables may differ by
  an ulp: XLA's exp is not correctly rounded);
* the tiny prior on a 4 × 4 grid, on the odd 5 × 5 grid (the up path's
  half-pixel bilinear resize) and on the 15 × 15 grid of a 640px input;
* the module names of ``tests/test_cascade.py``: 16 LoRA sites of JAX's
  names, the ``2·c`` skip width, the 256 sites of the full prior (on the
  meta device); K2's and K3's split rules pick 1 at its attention shapes;
* the bridge both ways (the ConvTranspose kernel's flip, the depthwise conv,
  the GRN's gamma and beta);
* a diffusers-layout ``prior/`` directory written from seeded weights (two
  shards and an index) loaded by the port and run against JAX's
  ``convert_cascade_state_dict`` of the same state dict; the lite prior's
  widths and stray keys or shapes refused;
* ``encode_prompts_cascade`` on the tiny CLIP tower.
"""

import dataclasses
import json
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.models import cascade as jcascade
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.io import torch_convert as tc
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_jax_tree, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import save_file
from sliders_conceptmod_tpu_torch.models import cascade as tcascade
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from _cascade_assets import STEP_TOL, random_prior
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TINY = tcascade.CascadeConfig.tiny()


def _randomized(params, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)


def _ported(module, params):
    assert load_jax_params(module, to_numpy_tree(params)) == []
    return module.eval()


def _inputs(rng, hw, batch=2):
    cfg = TINY
    return (rng.standard_normal((batch, cfg.in_channels, hw, hw)).astype(np.float32),
            rng.random(batch).astype(np.float32),
            rng.standard_normal((batch, 3, cfg.clip_text_in_channels)).astype(np.float32),
            rng.standard_normal((batch, 1, cfg.clip_text_pooled_in_channels)).astype(np.float32),
            rng.standard_normal((batch, 1, cfg.clip_image_in_channels)).astype(np.float32))


def _close(got, want, tol=STEP_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


# -- the blocks ------------------------------------------------------------------

BLOCKS = {
    "resblock": (lambda: jcascade.CascadeResBlock(8, kernel_size=3), lambda: tcascade.CascadeResBlock(8, 0, 3), 0),
    "resblock_skip": (lambda: jcascade.CascadeResBlock(8, c_skip=8, kernel_size=3),
                      lambda: tcascade.CascadeResBlock(8, 8, 3), 8),
    "grn": (lambda: jcascade.GlobalResponseNorm(8), lambda: tcascade.GlobalResponseNorm(8), None),
    "timestep": (lambda: jcascade.CascadeTimestepBlock(8), lambda: tcascade.CascadeTimestepBlock(8, 4), "r"),
    "attn": (lambda: jcascade.CascadeAttnBlock(8, 2), lambda: tcascade.CascadeAttnBlock(8, 6, 2), "clip"),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_jax(name):
    jmake, tmake, extra = BLOCKS[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)  # NHWC, a non-square grid
    args = {0: (), None: (), 8: (rng.standard_normal((2, 5, 3, 8)).astype(np.float32),),
            "r": (rng.standard_normal((2, 12)).astype(np.float32),),
            "clip": (rng.standard_normal((2, 7, 6)).astype(np.float32),)}[extra]
    jmod = jmake()
    params = _randomized(jmod.init(jax.random.PRNGKey(0), x, *args)["params"], 2)
    want = jmod.apply({"params": params}, x, *args)
    with torch.no_grad():
        got = _ported(tmake(), params)(torch.from_numpy(x), *(torch.from_numpy(a) for a in args))
    _close(got, want)


def test_channel_norm_and_ratio_embedding_match_jax():
    rng = np.random.default_rng(2)
    x = (3 + 2 * rng.standard_normal((2, 4, 4, 32))).astype(np.float32)
    _close(tcascade.channel_layer_norm(torch.from_numpy(x)), jcascade._channel_layer_norm(jnp.asarray(x)))
    r = np.concatenate([np.linspace(1, 0, 21, dtype=np.float32), rng.random(64).astype(np.float32)])
    for dim in (8, 7):
        _close(tcascade.ratio_embedding(torch.from_numpy(r), dim), jcascade.ratio_embedding(jnp.asarray(r), dim))
    # the prior's width: the arguments reach 10⁴, whose fp32 spacing is ~1e-3
    _close(tcascade.ratio_embedding(torch.from_numpy(r), 64), jcascade.ratio_embedding(jnp.asarray(r), 64),
           tol=2 * float(np.spacing(np.float32(1e4))))


# -- the whole tiny prior ---------------------------------------------------------


@pytest.mark.parametrize("hw", [4, 5, 15], ids=["4x4", "5x5_odd", "15x15_640px"])
def test_tiny_prior_matches_jax(hw):
    model, params, port = random_prior()
    args = _inputs(np.random.default_rng(hw), hw)
    want = model.apply({"params": params}, *args)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    assert got.shape == (2, 16, hw, hw) and got.dtype == torch.float32
    _close(got, want)
    if hw == 15:  # the grid of a 640px input
        assert math.ceil(640 / tcascade.CascadeConfig().resolution_multiple) == 15


def test_checkpointed_forward_and_pooled_without_seq_axis():
    """remat_blocks gives the same output and gradients; 2-D pooled and
    image embeddings take a sequence axis of 1."""
    _, _, port = random_prior()
    x, r, text, pooled, img = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(7), 4))
    outs = []
    for remat in (False, True):
        xx = x.clone().requires_grad_(True)
        out = port(xx, r, text, pooled[:, 0], img[:, 0], remat_blocks=remat)
        (g,) = torch.autograd.grad(out.square().sum(), xx)
        outs.append((out.detach(), g))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-7)


# -- names and sites --------------------------------------------------------------


def test_module_names_and_sites_match_jax():
    model, params, port = random_prior()
    jsites = jlora.create_sites(params, rank=2, target_replace=["Attention"])
    tsites = tlora.create_sites(port, rank=2, target_replace=["Attention"])
    assert len(tsites) == 16
    assert [(s.lora_name, s.module_path, s.in_dim, s.out_dim) for s in tsites] == \
        [(s.lora_name, s.module_path, s.in_dim, s.out_dim) for s in jsites]
    names = {s.lora_name for s in tsites}
    assert {"lora_unet_down_blocks_0_2_attention_to_q", "lora_unet_up_blocks_1_2_attention_to_out_0"} <= names
    c = TINY.block_out_channels[0]
    assert port.up_blocks[1][0].channelwise[0].in_features == 2 * c
    assert port.up_blocks[0][0].channelwise[0].in_features == c
    sd = port.state_dict()
    for key in ("embedding.1.weight", "clf.1.weight", "clip_txt_mapper.weight", "clip_txt_pooled_mapper.weight",
                "clip_img_mapper.weight", "down_downscalers.1.1.weight", "up_upscalers.0.1.weight",
                "down_blocks.0.0.depthwise.weight", "down_blocks.0.0.channelwise.2.gamma",
                "down_blocks.0.1.mapper_crp.weight", "down_blocks.0.2.attention.to_out.0.weight",
                "down_blocks.0.2.kv_mapper.1.weight"):
        assert key in sd, key
    # c3lier's conv classes match nothing in the prior
    assert [s.lora_name for s in tlora.create_sites(port, rank=2, target_replace=list(tlora.DEFAULT_TARGET_REPLACE)
                                                    + tlora.UNET_TARGET_REPLACE_MODULE_CONV)] == \
        [s.lora_name for s in tsites]


def test_full_prior_structure():
    """The prior's widths on the meta device against ``jax.eval_shape`` of the
    JAX prior: every leaf's path and shape in the JAX layout, the 256 LoRA
    sites of JAX's names, 64 attention calls of head dim 64, 3.6 B
    parameters."""
    from sliders_conceptmod_tpu_torch.io.jax_params import jax_layout_shapes

    cfg = tcascade.CascadeConfig.prior()
    with torch.device("meta"):
        prior = tcascade.StableCascadeUNet(cfg)
    jmodel = jcascade.StableCascadeUNet(jcascade.CascadeConfig.prior())
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 4, 4)), jnp.zeros((1,)), jnp.zeros((1, 2, 1280)),
        jnp.zeros((1, 1, 1280)), jnp.zeros((1, 1, 768))))["params"]
    want = {"/".join(k.key for k in path): tuple(v.shape) for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert jax_layout_shapes(prior) == want
    sites = tlora.create_sites(prior, rank=4, target_replace=["Attention"])
    jsites = jlora.create_sites(shapes, rank=4, target_replace=["Attention"])
    assert len(sites) == 256 and [s.lora_name for s in sites] == [s.lora_name for s in jsites]
    assert cfg.attention_calls_by_head_dim() == {64: 64}
    assert 3.5e9 < sum(p.numel() for p in prior.parameters()) < 3.7e9


@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("sq,sk", [(144, 229), (36, 121)], ids=["level0_144x229", "level1_36x121"])
def test_split_rules_pick_one_at_the_prior_attentions(sq, sk, rows):
    """At 512px (a 12 × 12 grid: 144 queries over 144 + 77 + 4 + 4 keys, 36
    over 121 after the stride-2 conv) and 32 heads, K2's key split and K3's
    query split are 1 in bf16 and fp32."""
    from sliders_conceptmod_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        assert fa.pick_k2_splits(rows * 32, sq, sk, dtype) == fa.pick_k3_splits(rows * 32, sq, sk, dtype) == 1


# -- the bridge -------------------------------------------------------------------


def test_bridge_round_trips_and_flips_the_transposed_conv():
    _, params, port = random_prior()
    back = to_jax_tree(port)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_t = {jax.tree_util.keystr(k): v.numpy() for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        assert np.array_equal(flat_j[k], flat_t[k]), k
    assert back["down_blocks_0_0"]["channelwise_2"]["gamma"].shape == (1, 1, 1, 4 * TINY.block_out_channels[0])
    assert port.down_blocks[0][0].depthwise.weight.shape == (32, 1, 3, 3)

    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 3, 5, 6)).astype(np.float32)
    up = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), padding="VALID")
    p = _randomized(up.init(jax.random.PRNGKey(0), x)["params"], 5)
    conv_t = _ported(nn.ConvTranspose2d(6, 4, 2, stride=2), p)
    with torch.no_grad():
        got = conv_t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, up.apply({"params": p}, x), tol=1e-5)
    dw = fnn.Conv(6, (3, 3), padding=1, feature_group_count=6)
    p = _randomized(dw.init(jax.random.PRNGKey(0), x)["params"], 6)
    conv = _ported(nn.Conv2d(6, 6, 3, padding=1, groups=6), p)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, dw.apply({"params": p}, x), tol=1e-5)


# -- the prior/ directory -----------------------------------------------------------


def _write_prior_dir(root, sd, config):
    """A diffusers ``prior/`` in two shards with an index, and config.json."""
    sub = root / "prior"
    sub.mkdir(parents=True)
    keys, weight_map = sorted(sd), {}
    for i in range(2):
        name = f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: sd[k].contiguous() for k in keys[i::2]}, str(sub / name))
        weight_map.update({k: name for k in keys[i::2]})
    (sub / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    (sub / "config.json").write_text(json.dumps(dataclasses.asdict(config)))


def test_prior_dir_loads_and_runs_as_jax_convert_cascade_state_dict(tmp_path, monkeypatch):
    from sliders_conceptmod_tpu_torch.io.ldm_export import export_clip_text

    _, _, src = random_prior()
    sd = src.state_dict()
    root = tmp_path / "tiny-cascade-diffusers"
    _write_prior_dir(root, sd, TINY)
    te_cfg = CLIPTextConfig.tiny(hidden_size=16, projection_dim=16)
    te_src = tfactory.build_module(lambda: CLIPTextEncoder(te_cfg), "cpu", torch.float32, 9)
    (root / "text_encoder").mkdir()
    save_file(export_clip_text(te_src.state_dict(), prefix=""), str(root / "text_encoder" / "model.safetensors"))
    (root / "text_encoder" / "config.json").write_text(json.dumps(dataclasses.asdict(te_cfg)))

    # the prior this port (and JAX) builds for a directory is the full one: its widths refuse the tiny config
    with pytest.raises(ValueError, match="conditioning_dim is 32"):
        tc.load_cascade_prior_state(str(root))
    monkeypatch.setattr(tcascade.CascadeConfig, "prior", classmethod(lambda cls: cls.tiny()))
    _, te, prior, sched = tfactory.load_models_cascade(str(root), scheduler_name="wuerstchen", device="cpu")
    assert type(sched).__name__ == "WuerstchenScheduler" and prior.config == TINY
    for k, v in prior.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k, v in te.model.state_dict().items():
        assert torch.equal(v, te_src.state_dict()[k]), k

    jtree = jcascade.convert_cascade_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(jtree)}
    flat_t = {jax.tree_util.keystr(k): v.numpy()
              for k, v in jax.tree_util.tree_leaves_with_path(to_jax_tree(prior))}
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        assert np.array_equal(flat_j[k], flat_t[k]), k
    args = _inputs(np.random.default_rng(3), 5)
    want = jcascade.StableCascadeUNet(jcascade.CascadeConfig.tiny()).apply({"params": jtree}, *args)
    with torch.no_grad():
        got = prior(*(torch.from_numpy(a) for a in args))
    _close(got, want)


def test_single_files_are_refused(tmp_path):
    path = tmp_path / "stable_cascade_prior.safetensors"
    save_file({"clip_txt_mapper.weight": torch.zeros(2, 2)}, str(path))
    with pytest.raises(NotImplementedError, match="no single-file loader for Stable Cascade"):
        tfactory.load_models_cascade(str(path), device="cpu")


@pytest.mark.parametrize("edit,exc,match", [
    ("stray", KeyError, "tensors have no parameter"),
    ("shape", ValueError, "in the checkpoint"),
    ("lite", ValueError, "block_out_channels is \\[1536, 1536\\]"),
])
def test_prior_dir_refusals(tmp_path, monkeypatch, edit, exc, match):
    _, _, src = random_prior()
    sd = dict(src.state_dict())
    config = TINY
    if edit == "stray":
        sd["effnet_mapper.0.weight"] = torch.zeros(2, 2)
    elif edit == "shape":
        sd["clf.1.weight"] = torch.zeros(8, 32, 1, 1)
    else:
        config = dataclasses.replace(tcascade.CascadeConfig.prior(), block_out_channels=(1536, 1536),
                                     down_num_layers_per_block=(4, 12), up_num_layers_per_block=(12, 4))
    _write_prior_dir(tmp_path / "tiny-cascade", sd, config)
    if edit != "lite":
        monkeypatch.setattr(tcascade.CascadeConfig, "prior", classmethod(lambda cls: cls.tiny()))
    with pytest.raises(exc, match=match):
        tfactory.load_models_cascade(str(tmp_path / "tiny-cascade"), device="cpu")


# -- the prompt encoding ------------------------------------------------------------


def test_encode_prompts_cascade_matches_jax():
    jtok, jte, jprior, jsched = jfactory.load_models_cascade("tiny-cascade")
    ttok, tte, tprior, tsched = tfactory.load_models_cascade("tiny-cascade", device="cpu")
    assert tprior.config == TINY and type(tsched).__name__ == type(jsched).__name__ == "NoiseScheduler"
    assert load_jax_params(tte.model, to_numpy_tree(jte.params)) == []
    prompts = ["pixel art", "", "a photo of a person, very old"]
    assert np.array_equal(ttok(prompts), np.asarray(jtok(prompts)))
    jt, jp = jfactory.encode_prompts_cascade(jte, prompts)
    tt, tp = tfactory.encode_prompts_cascade(tte, prompts)
    assert tt.shape == (3, 77, 16) and tp.shape == (3, 1, 16)
    _close(tt, jt, tol=1e-5)
    _close(tp, jp, tol=1e-5)
