"""The port's CLIP, UNet and VAE against the JAX package's, on the same
random weights (moved across by io/jax_params.py), fp32 on the CPU, within
the 2e-4 bound of tests/test_backbone_parity.py; full-width structures
against tests/golden/model_structures.json; tokenizer ids."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.models import clip as jclip
from sliders_conceptmod_tpu.models import tokenizer as jtok
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.models import vae as jvae
from sliders_conceptmod_tpu_torch.io.jax_params import jax_layout_shapes, load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import clip as tclip
from sliders_conceptmod_tpu_torch.models import tokenizer as ttok
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.models import vae as tvae
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "model_structures.json")
TOL = dict(atol=2e-4, rtol=1e-4)


def random_tree(params, seed, scale=0.1):
    """Replace every leaf with N(0, scale²) so zero-init biases / unit norm
    scales cannot hide a transpose or an affine bug."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)


def bridge(module, tree):
    unused = load_jax_params(module, to_numpy_tree(tree))
    return module.eval(), unused


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_matches_jax(act):
    from dataclasses import replace

    jcfg = replace(jclip.CLIPTextConfig.tiny(hidden_size=16, projection_dim=32), hidden_act=act)
    tcfg = replace(tclip.CLIPTextConfig.tiny(hidden_size=16, projection_dim=32), hidden_act=act)
    ids = jtok.HashTokenizer()(["a photo of a cat", "", "portrait, very old man"])
    model = jclip.CLIPTextEncoder(jcfg)
    params = random_tree(model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"], seed=1)
    want = model.apply({"params": params}, jnp.asarray(ids))
    port, unused = bridge(tclip.CLIPTextEncoder(tcfg), params)
    assert unused == []
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_allclose(
        tclip.penultimate_hidden_state(got).numpy(), np.asarray(jclip.penultimate_hidden_state(want)), **TOL
    )
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(want.last_hidden_state), **TOL)
    np.testing.assert_allclose(got.pooled_output.numpy(), np.asarray(want.pooled_output), **TOL)
    np.testing.assert_allclose(got.projected.numpy(), np.asarray(want.projected), **TOL)


def test_tiny_xl_unet_matches_jax():
    cfg = junet.UNetConfig.tiny_xl()
    model = junet.UNet2DConditionModel(cfg)
    rng = np.random.default_rng(2)
    sample = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    t = np.asarray([3.0, 977.0], np.float32)
    added = {
        "text_embeds": rng.standard_normal((2, 32)).astype(np.float32),
        "time_ids": np.tile(np.asarray([[512, 512, 0, 0, 512, 512]], np.float32), (2, 1)),
    }
    added_j = {k: jnp.asarray(v) for k, v in added.items()}
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                        added_cond_kwargs=added_j)["params"]
    params = random_tree(params, seed=3)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                                  added_cond_kwargs=added_j))
    port, unused = bridge(tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()), params)
    assert unused == []
    with torch.no_grad():
        got = port(torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(ctx),
                   added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()}).numpy()
        # a host-number timestep broadcasts over the batch like the JAX scalar
        got_scalar = port(torch.from_numpy(sample), 500, torch.from_numpy(ctx),
                          added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()}).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want_scalar = np.asarray(model.apply({"params": params}, jnp.asarray(sample), 500, jnp.asarray(ctx),
                                         added_cond_kwargs=added_j))
    np.testing.assert_allclose(got_scalar, want_scalar, **TOL)
    assert port.config.attention_calls_per_forward() == 8


def test_full_width_sdxl_transformer_block_matches_jax():
    """One SDXL mid-level Transformer2DModel at full width (640 channels, 10
    heads of 64, 2 layers, 2048-dim context) at 8×8 spatial."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 640)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 2048)).astype(np.float32)
    model = junet.Transformer2DModel(heads=10, cross_attention_dim=2048, num_layers=2,
                                     use_linear_projection=True, groups=32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))["params"]
    params = random_tree(params, seed=5, scale=0.02)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))
    port, unused = bridge(tunet.Transformer2DModel(640, 10, 2048, num_layers=2, use_linear_projection=True), params)
    assert unused == []
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_tiny_vae_decode_matches_jax():
    cfg = jvae.VAEConfig.tiny()
    model = jvae.AutoencoderKL(cfg)
    rng = np.random.default_rng(6)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"]
    params = random_tree(params, seed=7)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(latents), method=model.decode))
    port, unused = bridge(tvae.AutoencoderKL(tvae.VAEConfig.tiny()), params)
    assert unused == []  # the whole JAX tree, encoder included
    with torch.no_grad():
        got = port.decode(torch.from_numpy(latents)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_tiny_vae_encode_matches_jax():
    """Posterior moments of the encoder (asymmetric-pad downsample, mid-block
    attention through the dispatch, quant_conv, the logvar clip) and a
    posterior sample from the same normal draw."""
    cfg = jvae.VAEConfig.tiny()
    model = jvae.AutoencoderKL(cfg)
    rng = np.random.default_rng(8)
    params = random_tree(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"], seed=9, scale=0.3)
    images = rng.uniform(-1, 1, (2, 3, 18, 14)).astype(np.float32)  # odd halves: the (0, 1) pad matters
    want_mean, want_logvar = (np.asarray(x) for x in model.apply({"params": params}, jnp.asarray(images),
                                                                    method=model.encode))
    port, unused = bridge(tvae.AutoencoderKL(tvae.VAEConfig.tiny()), params)
    assert unused == []
    with torch.no_grad():
        mean, logvar = port.encode(torch.from_numpy(images))
    assert tuple(mean.shape) == want_mean.shape == (2, 4, 9, 7)
    np.testing.assert_allclose(mean.numpy(), want_mean, **TOL)
    np.testing.assert_allclose(logvar.numpy(), want_logvar, **TOL)
    noise = rng.standard_normal(want_mean.shape).astype(np.float32)
    sample = tvae.sample_latents(mean, logvar, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(sample, want_mean + np.exp(0.5 * want_logvar) * noise, **TOL)
    # the decoder's parameters come first, so its seeded initialisation is the decode-only one's
    names = [n for n, _ in port.named_parameters()]
    assert names.index("post_quant_conv.weight") < names.index("encoder.conv_in.weight")


@pytest.mark.parametrize(
    "family,factory",
    [
        ("unet_sdxl", lambda: tunet.UNet2DConditionModel(tunet.UNetConfig.sdxl())),
        ("clip_sdxl_te1", lambda: tclip.CLIPTextEncoder(tclip.CLIPTextConfig.sdxl_te1())),
        ("clip_sdxl_te2", lambda: tclip.CLIPTextEncoder(tclip.CLIPTextConfig.sdxl_te2())),
        ("vae_sdxl", lambda: tvae.AutoencoderKL(tvae.VAEConfig.sdxl())),
    ],
)
def test_full_width_structures_match_golden(family, factory):
    """Every full-width parameter's JAX path and shape equals the pinned
    structure of the JAX package (built on the meta device: no memory)."""
    with open(GOLDEN) as f:
        golden = {k: tuple(v) for k, v in json.load(f)[family].items()}
    with torch.device("meta"):
        shapes = jax_layout_shapes(factory())
    assert shapes == golden  # the VAE's encoder and quant_conv included


def test_sdxl_config_matches_jax_and_counts_140_attentions():
    from dataclasses import asdict

    assert asdict(tunet.UNetConfig.sdxl()) == asdict(junet.UNetConfig.sdxl())
    assert asdict(tunet.UNetConfig.tiny_xl()) == asdict(junet.UNetConfig.tiny_xl())
    assert asdict(tclip.CLIPTextConfig.sdxl_te2()) == asdict(jclip.CLIPTextConfig.sdxl_te2())
    assert tunet.UNetConfig.sdxl().attention_calls_per_forward() == 140


def test_hash_tokenizer_ids_match_jax():
    prompts = ["a photo of a person", "", "Portrait,  VERY old man!", " ".join(["word"] * 100)]
    for pad in (None, 0):
        np.testing.assert_array_equal(
            ttok.HashTokenizer(pad=pad)(prompts), jtok.HashTokenizer(pad=pad)(prompts)
        )
    tok = ttok.load_tokenizer("", component="tokenizer_2", pad_token_id=0)
    assert isinstance(tok, ttok.HashTokenizer) and tok.pad == 0
