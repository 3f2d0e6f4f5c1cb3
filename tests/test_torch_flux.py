"""The port's Flux transformer (``models/flux.py``) against the JAX package's.

* ``apply_rope`` (on the same tables), ``pack_latents`` / ``unpack_latents``
  and ``prepare_latent_image_ids``: exact; ``rope_freqs`` within 2e-7 (the
  two libraries' fp32 ``cos``/``sin`` differ by an ulp) at 1024px's 512 +
  4096 positions;
* a dual-stream and a single-stream block from the same weights, and the
  tiny schnell and dev forwards (dev with and without a guidance: JAX's
  bundle default 3.5), fp32 within 2e-4;
* one single-stream block at schnell's full width (3072, 24 heads of 128);
* schnell's and dev's full-width parameter shapes against
  ``jax.eval_shape`` of the JAX init (the port built on the meta device),
  and the 76 site names of ``create_sites(..., delimiter="-")``;
* the diffusers conversion (JAX's renames; the port loads diffusers' names
  as they are) and the BFL single-file
  conversion against JAX's, and ``export_flux_bfl`` against JAX's, bit for
  bit; the weight bridge both ways;
* the student with every block under ``torch.utils.checkpoint`` (the
  overlay re-entered for each recompute) against the plain student.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.io import ldm_convert as jldm
from sliders_conceptmod_tpu.io import ldm_export as jexport
from sliders_conceptmod_tpu.models import flux as jflux
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.io import ldm_convert as tldm
from sliders_conceptmod_tpu_torch.io import ldm_export as texport
from sliders_conceptmod_tpu_torch.io.jax_params import jax_layout_shapes, load_jax_params, to_jax_tree, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import flux as tflux
from _flux_assets import STEP_TOL, jax_init, random_flux
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _inputs(cfg, b=2, gh=4, gw=3, seq=7, seed=0):
    r = np.random.default_rng(seed)
    tokens = r.standard_normal((b, gh * gw, cfg.in_channels)).astype(np.float32)
    t = np.array([0.93, 0.21][:b], np.float32)
    ctx = r.standard_normal((b, seq, cfg.joint_attention_dim)).astype(np.float32)
    pooled = r.standard_normal((b, cfg.pooled_projection_dim)).astype(np.float32)
    return tokens, t, ctx, pooled, np.zeros((seq, 3), np.float32), jflux.prepare_latent_image_ids(gh, gw)


def test_configs_match_jax():
    for name in ("schnell", "dev", "tiny"):
        j, t = getattr(jflux.FluxConfig, name)(), getattr(tflux.FluxConfig, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.inner_dim == j.inner_dim
    assert tflux.FluxConfig.schnell().attention_calls_by_head_dim() == {128: 57}


def test_rope_pack_and_ids_match_jax():
    ids = np.concatenate([np.zeros((512, 3), np.float32), jflux.prepare_latent_image_ids(64, 64)])[None]
    assert np.array_equal(tflux.prepare_latent_image_ids(64, 64), jflux.prepare_latent_image_ids(64, 64))
    jc, js = (np.array(a) for a in jflux.rope_freqs(jnp.asarray(ids), (16, 56, 56)))
    tc, ts = tflux.rope_freqs(torch.from_numpy(ids), (16, 56, 56))
    assert tc.shape == (1, 4608, 128) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-7, rtol=0)
    np.testing.assert_allclose(ts.numpy(), js, atol=2e-7, rtol=0)
    x = np.random.default_rng(1).standard_normal((2, 4608, 3, 128)).astype(np.float32)
    want = np.asarray(jflux.apply_rope(jnp.asarray(x), jnp.asarray(jc), jnp.asarray(js)))
    assert np.array_equal(tflux.apply_rope(torch.from_numpy(x), torch.from_numpy(jc), torch.from_numpy(js)).numpy(),
                          want)
    lat = np.random.default_rng(2).standard_normal((2, 16, 8, 6)).astype(np.float32)
    packed = tflux.pack_latents(torch.from_numpy(lat))
    assert np.array_equal(packed.numpy(), np.asarray(jflux.pack_latents(jnp.asarray(lat))))
    assert np.array_equal(tflux.unpack_latents(packed, 8, 6).numpy(), lat)


def test_blocks_match_jax():
    _, params, port = random_flux()
    cfg = jflux.FluxConfig.tiny()
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 12, 32)).astype(np.float32)
    ctx = r.standard_normal((2, 7, 32)).astype(np.float32)
    temb = r.standard_normal((2, 32)).astype(np.float32)
    ids = np.concatenate([np.zeros((7, 3), np.float32), jflux.prepare_latent_image_ids(4, 3)])[None]
    cos, sin = (np.asarray(a) for a in jflux.rope_freqs(jnp.asarray(ids), cfg.axes_dims_rope))
    tcs = [torch.from_numpy(a) for a in (cos, sin)]
    jx, jc = jflux.FluxTransformerBlock(cfg).apply({"params": params["transformer_blocks_1"]}, x, ctx, temb, cos, sin)
    tx, tc = port.transformer_blocks[1](torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(temb), *tcs)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), atol=STEP_TOL, rtol=0)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=STEP_TOL, rtol=0)
    comb = np.concatenate([ctx, x], axis=1)
    want = jflux.FluxSingleTransformerBlock(cfg).apply({"params": params["single_transformer_blocks_0"]}, comb, temb,
                                                       cos, sin)
    got = port.single_transformer_blocks[0](torch.from_numpy(comb), torch.from_numpy(temb), *tcs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=STEP_TOL, rtol=0)


@pytest.mark.parametrize("dev,guidance", [(False, None), (True, 4.0), (True, None)])
def test_tiny_forward_matches_jax(dev, guidance):
    model, params, port = random_flux(dev=dev)
    args = _inputs(port.config)
    kw = {"guidance": 3.5 if guidance is None else guidance} if dev else {}  # JAX's bundle injects 3.5
    want = np.asarray(model.apply({"params": params}, *args, **kw))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args), **({"guidance": guidance} if guidance else {}))
    assert got.shape == (2, 12, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=STEP_TOL, rtol=0)


def test_single_block_at_full_width_matches_jax():
    cfg = jflux.FluxConfig.schnell()
    block = jflux.FluxSingleTransformerBlock(cfg)
    r = np.random.default_rng(6)
    x = r.standard_normal((1, 24, cfg.inner_dim)).astype(np.float32)
    temb = r.standard_normal((1, cfg.inner_dim)).astype(np.float32)
    ids = np.concatenate([np.zeros((8, 3), np.float32), jflux.prepare_latent_image_ids(4, 4)])[None]
    cos, sin = (np.asarray(a) for a in jflux.rope_freqs(jnp.asarray(ids), cfg.axes_dims_rope))
    shapes = jax.eval_shape(lambda: block.init(jax.random.PRNGKey(0), x, temb, cos, sin))["params"]
    params = jax.tree.map(lambda a: (0.02 * r.standard_normal(a.shape)).astype(np.float32), shapes)
    port = tflux.FluxSingleTransformerBlock(tflux.FluxConfig.schnell())
    holder = torch.nn.Module()
    holder.single_transformer_blocks = torch.nn.ModuleList([port])
    holder.jax_path = tflux.FluxTransformer2DModel.jax_path
    assert load_jax_params(holder, {"single_transformer_blocks_0": to_numpy_tree(params)}) == []
    want = np.asarray(block.apply({"params": params}, x, temb, cos, sin))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(temb), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), want, atol=STEP_TOL, rtol=0)


@pytest.mark.parametrize("name", ["schnell", "dev"])
def test_full_width_structure_and_sites_match_jax(name):
    jcfg = getattr(jflux.FluxConfig, name)()
    _, shapes = jax_init(jcfg)
    with torch.device("meta"):
        port = tflux.FluxTransformer2DModel(getattr(tflux.FluxConfig, name)())
    want = {k: tuple(v.shape) for k, v in _flat_shapes(shapes).items()}
    assert jax_layout_shapes(port) == want
    jsites = jlora.create_sites(shapes, rank=4, target_replace=["Attention"], delimiter="-")
    tsites = tlora.create_sites(port, rank=4, target_replace=["Attention"], delimiter="-")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites] and len(tsites) == 76
    assert [s.module_path for s in tsites] == [tuple(s.module_path) for s in jsites]


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("dev", [False, True])
def test_conversions_and_bridge_match_jax(dev):
    _, params, port = random_flux(dev=dev)
    sd = port.state_dict()
    want = _flat(params)
    # diffusers: JAX renames into its flat tree; the port's names are diffusers'
    got = _flat(jflux.convert_flux_state_dict({k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    # BFL: the port's export is JAX's, and both converters invert it
    bfl = texport.export_flux_bfl(sd)
    jbfl = jexport.export_flux_bfl(params)
    assert set(bfl) == set(jbfl) and all(np.array_equal(bfl[k].numpy(), np.asarray(jbfl[k])) for k in jbfl)
    back = tldm.convert_flux_bfl_state_dict(bfl)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    got = _flat(jldm.convert_flux_bfl_state_dict({k: v.numpy() for k, v in bfl.items()}))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert tldm.convert_ldm_checkpoint(bfl).keys() == {"transformer"}
    # the bridge both ways
    got = _flat(to_jax_tree(port))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_checkpointed_student_matches_plain():
    _, _, port = random_flux()
    sites = tlora.create_sites(port, rank=2, target_replace=["Attention"], delimiter="-")
    g = torch.Generator().manual_seed(0)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = 0.1 * torch.randn(leaf["up"].shape, generator=g)
        for t in leaf.values():
            t.requires_grad_(True)
    overlay = tlora.LoRAOverlay(port, sites, lp)
    args = [torch.from_numpy(a) for a in _inputs(port.config)]
    params = [t for leaf in lp.values() for t in leaf.values()]
    one = torch.ones(1)

    def grads(remat):
        with overlay(one):
            out = port(*args, remat_blocks=remat, remat_context=(lambda: overlay(one)) if remat else None)
        return torch.autograd.grad((out ** 2).mean(), params)

    for a, b in zip(grads(False), grads(True)):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-5)
