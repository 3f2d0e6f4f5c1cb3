"""The port's SD3 MMDiT (``models/mmdit.py``) against the JAX package's.

* the tiny MMDiT forward from the same weights (through ``io/jax_params.py``),
  latents, timesteps and context, fp32 within 2e-4;
* the centre-cropped sin-cos table bit-equal to the JAX table's crop;
* a LoRA factor's gradient through the overlay and through the merge against
  ``jax.grad`` of the JAX overlay and merge;
* the student with every block under ``torch.utils.checkpoint`` (the
  overlay re-entered for each recompute) against the plain student;
* SD3-Medium's full-width parameter shapes against ``jax.eval_shape`` of the
  JAX init, built on the meta device (no allocation), and the weight bridge
  both ways on the tiny model;
* the 96 full-width site names equal the JAX ``create_sites(...,
  delimiter="-")``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.models import mmdit as jmmdit
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.io.jax_params import jax_layout_shapes, to_jax_tree
from sliders_conceptmod_tpu_torch.models import mmdit as tmmdit
from _sd3_assets import STEP_TOL, jax_init, random_mmdit
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


def _inputs(b=2, hw=8, seq=12, seed=0):
    r = np.random.default_rng(seed)
    lat = r.standard_normal((b, 16, hw, hw)).astype(np.float32)
    t = np.array([937.5, 120.25][:b], np.float32)
    ctx = r.standard_normal((b, seq, 32)).astype(np.float32)
    pooled = r.standard_normal((b, 32)).astype(np.float32)
    return lat, t, ctx, pooled


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def test_configs_match_jax():
    for name in ("sd3_medium", "tiny"):
        j, t = getattr(jmmdit.MMDiTConfig, name)(), getattr(tmmdit.MMDiTConfig, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.inner_dim == j.inner_dim
    assert tmmdit.MMDiTConfig.sd3_medium().inner_dim == 1536


@pytest.mark.parametrize("hw", [8, 6])
def test_tiny_forward_matches_jax(hw):
    model, params, port = random_mmdit()
    lat, t, ctx, pooled = _inputs(hw=hw)
    want = np.asarray(model.apply({"params": params}, lat, t, ctx, pooled))
    got = port(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx), torch.from_numpy(pooled))
    assert got.shape == (2, 16, hw, hw) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=STEP_TOL, rtol=0)


@pytest.mark.parametrize("dim,max_size,gh,gw", [(32, 16, 4, 4), (32, 16, 3, 5), (1536, 192, 64, 64),
                                                (1536, 192, 128, 128)])
def test_sincos_crop_equals_jax_table(dim, max_size, gh, gw):
    table = jmmdit._sincos_2d_pos_embed(dim, max_size).reshape(max_size, max_size, dim)
    top, left = (max_size - gh) // 2, (max_size - gw) // 2
    want = table[top:top + gh, left:left + gw].reshape(gh * gw, dim)
    got = tmmdit.sincos_pos_embed_crop(dim, max_size, gh, gw)
    assert got.dtype == np.float64 and np.array_equal(got, want)


def _lora(sites, seed=1):
    """JAX-layout factors with N(0, 0.3²) leaves."""
    r = np.random.default_rng(seed)
    lp = jlora.init_lora_params(jax.random.PRNGKey(0), sites)
    return jax.tree.map(lambda a: (0.3 * r.standard_normal(a.shape)).astype(np.float32), lp)


def _port_lora(jsites, lp, tsites):
    """The same factors in the port's layout, as trainable leaves."""
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, lp), tsites)
    return {n: {k: v.requires_grad_(True) for k, v in leaf.items()} for n, leaf in tlp.items()}


@pytest.mark.parametrize("route", ["overlay", "merge"])
def test_lora_factor_gradients_match_jax(route):
    model, params, port = random_mmdit()
    lat, t, ctx, pooled = _inputs()
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites] and len(tsites) == 8
    lp = _lora(jsites)
    w = np.random.default_rng(9).standard_normal((2, 16, 8, 8)).astype(np.float32)

    def jloss(jlp):
        if route == "overlay":
            with jlora.lora_overlay(jsites, jlp, jnp.ones((1,), jnp.float32)):
                out = model.apply({"params": params}, lat, t, ctx, pooled)
        else:
            out = model.apply({"params": jlora.merge_lora_params(params, jsites, jlp, 1.0)}, lat, t, ctx, pooled)
        return jnp.sum(out * w)

    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, lp))
    tlp = _port_lora(jsites, lp, tsites)
    args = [torch.from_numpy(a) for a in (lat, t, ctx, pooled)]
    if route == "overlay":
        with tlora.LoRAOverlay(port, tsites, tlp)(torch.ones(1)):
            out = port(*args)
    else:
        merged = tlora.merge_lora_params(port, tsites, tlp, 1.0, grad=True)
        with tlora.merged_weights(port, merged):
            out = port(*args)
    (out * torch.from_numpy(w)).sum().backward()
    want = jlora.state_dict_numpy(jsites, jgrads)
    got = {f"{n}.lora_{'down' if k == 'down' else 'up'}.weight": v.grad.numpy()
           for n, leaf in tlp.items() for k, v in leaf.items()}
    assert set(got) <= set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], atol=STEP_TOL * 10, rtol=1e-4, err_msg=f"{route} {k}")


@pytest.mark.parametrize("route", ["overlay", "merge"])
def test_checkpointed_blocks_match_plain_student(route):
    _, params, port = random_mmdit()
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    sites = tlora.create_sites(port, rank=2, alpha=1.0, target_replace=["Attention"], delimiter="-")
    lp = _lora(jsites, seed=4)
    args = [torch.from_numpy(a) for a in _inputs(seed=2)]
    grads = []
    for remat in (False, True):
        tlp = _port_lora(jsites, lp, sites)
        overlay = tlora.LoRAOverlay(port, sites, tlp)
        if route == "overlay":
            ctx = lambda: overlay(torch.ones(1))  # noqa: E731
        else:
            merged = tlora.merge_lora_params(port, sites, tlp, 1.0, grad=True)

            def ctx():
                return tlora.merged_weights(port, merged)
        with ctx():
            out = port(*args, remat_blocks=remat, remat_context=ctx if remat else None)
        (out ** 2).mean().backward()
        grads.append({f"{n}.{k}": v.grad.clone() for n, leaf in tlp.items() for k, v in leaf.items()})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6, rtol=1e-5, msg=k)


def test_full_width_shapes_and_sites_match_jax():
    jcfg = jmmdit.MMDiTConfig.sd3_medium()
    jshapes = jax.eval_shape(lambda: jax_init(jcfg)[1])
    with torch.device("meta"):
        port = tmmdit.SD3Transformer2DModel(tmmdit.MMDiTConfig.sd3_medium())
    assert jax_layout_shapes(port) == _flat(jshapes)
    assert sum(p.numel() for p in port.parameters()) > 2.0e9
    jsites = jlora.create_sites(jshapes, rank=4, alpha=1.0, target_replace=["Attention"], train_method="full",
                                delimiter="-")
    tsites = tlora.create_sites(port, rank=4, alpha=1.0, target_replace=["Attention"], train_method="full",
                                delimiter="-")
    assert len(tsites) == 96
    assert [(s.lora_name, s.module_path, s.in_dim, s.out_dim) for s in tsites] == [
        (s.lora_name, s.module_path, s.in_dim, s.out_dim) for s in jsites]
    assert tsites[0].lora_name == "lora_unet-transformer_blocks-0-attn-to_k"


def test_weight_bridge_round_trip():
    _, params, port = random_mmdit()
    back = to_jax_tree(port)
    flat_j, flat_t = _flat(params), _flat(back)
    assert flat_j == flat_t

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    got = dict(leaves(back))
    for path, v in leaves(params):
        assert np.array_equal(got[path].numpy(), np.asarray(v)), path
