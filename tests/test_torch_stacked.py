"""Cross-slider stacks in the port against the JAX package, on tiny-xl.

* ``adapters/lora.py::stack_adapters``: two sliders of ranks 1 and 4 with
  different alphas (over noxattn's dense and conv sites) stack to JAX's
  factors, transposed to the port's layout (down ``[S, r, in(, kh, kw)]``,
  up ``[S, out, r(, 1, 1)]``), bit for bit, pad adapters included; the pad
  adapters are zero and rows routed to them are the base model; incompatible
  site sets raise in both packages;
* the indexed overlay: one UNet forward with three rows routed to two
  adapters equals JAX's ``lora_overlay(adapter_idx=…)`` and the port's own
  per-adapter overlay runs, fp32 ≤ 2e-4;
* ``sample_loop_scales(adapter_idx=…)`` against JAX's, with CFG and on the
  cond-only path (a Python guidance of 1), fp32 ≤ 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.infer import generate as jgen
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.diffusion import schedulers as tsched
from sliders_conceptmod_tpu_torch.infer import generate as tgen
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CONV = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV
TOL = 2e-4
SLIDERS = [("noxattn", 1, 4.0), ("noxattn", 4, 1.0)]  # (train_method, rank, alpha)


@pytest.fixture(scope="module")
def setup():
    """tiny-xl's UNet in both packages; two noxattn sliders and an xattn one,
    JAX factors with non-zero ups loaded into the port."""
    _, _, junet_b, jsched = jfactory.load_models_xl("tiny-xl", scheduler_name="ddim")
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    assert load_jax_params(port, to_numpy_tree(junet_b.params)) == []
    port.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    sliders = []
    for i, (method, rank, alpha) in enumerate(SLIDERS + [("xattn", 2, 1.0)]):
        jsites = jlora.create_sites(junet_b.params, rank=rank, alpha=alpha, target_replace=CONV, train_method=method)
        jlp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                           jlora.init_lora_params(jax.random.PRNGKey(i), jsites))
        tsites = tlora.create_sites(port, rank=rank, alpha=alpha, target_replace=CONV, train_method=method)
        assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]
        tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
        sliders.append(((jsites, jlp), (tsites, tlp)))
    rows = dict(
        x=rng.standard_normal((3, 4, 8, 8)).astype(np.float32),
        t=np.asarray([100.0, 500.0, 900.0], np.float32),
        ctx=rng.standard_normal((3, 77, 32)).astype(np.float32),
        text_embeds=rng.standard_normal((3, 32)).astype(np.float32),
        time_ids=np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (3, 1)),
    )
    return junet_b, jsched, port, sliders, rows


def _to_port_layout(site, name, a):
    """A JAX stacked factor ``[S, ...]`` in the port's layout."""
    if site.kind == "dense":
        return np.transpose(a, (0, 2, 1))  # [S, in, r] → [S, r, in]; [S, r, out] → [S, out, r]
    return np.transpose(a, (0, 4, 3, 1, 2))  # [S, kh, kw, in, r] → [S, r, in, kh, kw]; up likewise


def test_stack_adapters_is_jaxs_transposed_bit_for_bit(setup):
    _, _, _, sliders, _ = setup
    (ja, ta), (jb, tb), (jx, tx) = sliders
    jsites, jstack = jlora.stack_adapters([ja, jb], pad_to=4)
    tsites, tstack = tlora.stack_adapters([ta, tb], pad_to=4)
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]
    assert {s.kind for s in tsites} == {"dense", "conv"}
    for site in tsites:
        for k in ("down", "up"):
            got = tstack[site.lora_name][k]
            assert got.dtype == torch.float32 and got.shape[0] == 4
            np.testing.assert_array_equal(got.numpy(), _to_port_layout(site, k, np.asarray(jstack[site.lora_name][k])),
                                          err_msg=f"{site.lora_name}.{k}")
            assert not got[2:].any()  # the pad adapters are zero
        assert tstack[site.lora_name]["down"].shape[1] == 4  # rank 1 zero-padded to 4
    assert tlora.sites_stack_compatible(ta[0], tb[0]) and jlora.sites_stack_compatible(ja[0], jb[0])
    assert not tlora.sites_stack_compatible(ta[0], tx[0]) and not jlora.sites_stack_compatible(ja[0], jx[0])
    with pytest.raises(ValueError, match="different module sets"):
        tlora.stack_adapters([ta, tx])
    with pytest.raises(ValueError, match="different module sets"):
        jlora.stack_adapters([ja, jx])


def _jax_forward(junet_b, rows, sites=None, lp=None, scales=None, idx=None):
    added = {k: jnp.asarray(rows[k]) for k in ("text_embeds", "time_ids")}
    apply = junet_b.apply_fn()
    args = (junet_b.params, jnp.asarray(rows["x"]), jnp.asarray(rows["t"]), jnp.asarray(rows["ctx"]))
    if sites is None:
        return np.asarray(apply(*args, added_cond_kwargs=added))
    with jlora.lora_overlay(sites, lp, jnp.asarray(scales), adapter_idx=None if idx is None else jnp.asarray(idx)):
        return np.asarray(apply(*args, added_cond_kwargs=added))


def _port_forward(port, rows, overlay=None, scales=None, idx=None):
    added = {k: torch.from_numpy(rows[k]) for k in ("text_embeds", "time_ids")}
    args = (torch.from_numpy(rows["x"]), torch.from_numpy(rows["t"]), torch.from_numpy(rows["ctx"]))
    with torch.inference_mode():
        if overlay is None:
            return port(*args, added_cond_kwargs=added).numpy()
        with overlay(torch.tensor(scales), None if idx is None else torch.tensor(idx)):
            return port(*args, added_cond_kwargs=added).numpy()


def test_indexed_overlay_matches_jax_and_the_per_adapter_runs(setup):
    junet_b, _, port, sliders, rows = setup
    (ja, ta), (jb, tb), _ = sliders
    scales, idx = [0.8, -1.3, 2.0], [0, 1, 3]  # row 2 rides a pad adapter
    jsites, jstack = jlora.stack_adapters([ja, jb], pad_to=4)
    tsites, tstack = tlora.stack_adapters([ta, tb], pad_to=4)
    overlay = tlora.LoRAOverlay(port, tsites, tstack)
    got = _port_forward(port, rows, overlay, scales, idx)
    np.testing.assert_allclose(got, _jax_forward(junet_b, rows, jsites, jstack, scales, idx), atol=TOL, rtol=0)
    for row, (sites, lp) in ((0, ta), (1, tb)):
        solo = _port_forward(port, rows, tlora.LoRAOverlay(port, sites, lp), scales)
        np.testing.assert_allclose(got[row], solo[row], atol=TOL, rtol=0)
    base = _port_forward(port, rows)
    np.testing.assert_allclose(got[2], base[2], atol=1e-6, rtol=0)  # a pad adapter adds nothing
    assert np.abs(got[0] - base[0]).max() > 1e-2 and np.abs(got[1] - base[1]).max() > 1e-2  # the sliders bite
    assert all(not m._forward_hooks for m in port.modules())


@pytest.mark.parametrize("guidance", [7.5, 1.0], ids=["cfg", "cond_only"])
def test_sample_loop_scales_with_adapter_idx_matches_jax(setup, guidance):
    junet_b, jsched, port, sliders, _ = setup
    (ja, ta), (jb, tb), _ = sliders
    jsites, jstack = jlora.stack_adapters([ja, jb], pad_to=2)
    tsites, tstack = tlora.stack_adapters([ta, tb], pad_to=2)
    rng = np.random.default_rng(5)
    scales, idx = np.asarray([1.5, -2.0, 0.7], np.float32), [1, 0, 1]
    latents = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    emb = rng.standard_normal((6, 77, 32)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((6, 32)).astype(np.float32),
             "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (6, 1))}
    want = jgen.sample_loop_scales(
        junet_b.apply_fn(), junet_b.params, jsites, jstack, jnp.asarray(scales), 1, jsched, jsched.set_timesteps(3),
        jnp.asarray(latents), jnp.asarray(emb), jax.random.PRNGKey(0), guidance_scale=guidance,
        added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()}, adapter_idx=jnp.asarray(idx))
    tsch = tsched.create_noise_scheduler("ddim")
    got = tgen.sample_loop_scales(
        port, tsites, tstack, scales, 1, tsch, tsch.set_timesteps(3), torch.from_numpy(latents),
        torch.from_numpy(emb), guidance_scale=guidance, added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()},
        adapter_idx=idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    # row 1 (adapter 0) against the first slider alone
    solo = tgen.sample_loop_scales(
        port, *ta, scales, 1, tsch, tsch.set_timesteps(3), torch.from_numpy(latents), torch.from_numpy(emb),
        guidance_scale=guidance, added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()})
    np.testing.assert_allclose(got[1].numpy(), solo[1].numpy(), atol=TOL, rtol=0)
