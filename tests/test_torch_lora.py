"""The port's LoRA sites, checkpoint I/O and per-row overlay against the JAX
package's, on the tiny-xl UNet; the port's own .safetensors reader/writer
against the ``safetensors`` package the JAX side uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import slider_file as tslider
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CONV = jlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + jlora.UNET_TARGET_REPLACE_MODULE_CONV
SITE_CASES = [
    (["Attention"], "full"),
    (["Attention"], "noxattn"),
    (["Attention"], "xattn-strict"),
    (CONV, "noxattn"),
    (CONV, "full"),
    (CONV, "noxattn-hspace-last"),
]


@pytest.fixture(scope="module")
def tiny_xl():
    cfg = junet.UNetConfig.tiny_xl()
    model = junet.UNet2DConditionModel(cfg)
    added = {"text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 7, 32)),
                        added_cond_kwargs=added)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    return model, params, port.eval()


def _site_tuple(s):
    return (s.module_path, s.lora_name, s.kind, s.rank, s.alpha, s.in_dim, s.out_dim, tuple(s.kernel_size))


@pytest.mark.parametrize("targets,method", SITE_CASES)
def test_create_sites_match_jax(tiny_xl, targets, method):
    _, params, port = tiny_xl
    want = jlora.create_sites(params, rank=4, alpha=1.0, target_replace=targets, train_method=method)
    got = tlora.create_sites(port, rank=4, alpha=1.0, target_replace=targets, train_method=method)
    assert want, "case selects no site"
    assert [_site_tuple(s) for s in got] == [_site_tuple(s) for s in want]


def _jax_slider(params, seed=1, rank=4):
    sites = jlora.create_sites(params, rank=rank, alpha=2.0, target_replace=CONV, train_method="noxattn")
    lp = jlora.init_lora_params(jax.random.PRNGKey(seed), sites)
    rng = np.random.default_rng(seed)
    lp = jax.tree.map(lambda a: jnp.asarray(0.2 * rng.standard_normal(a.shape), jnp.float32), lp)
    return sites, lp


def test_jax_saved_slider_loads_identically(tiny_xl, tmp_path):
    _, params, port = tiny_xl
    jsites, jlp = _jax_slider(params)
    path = tmp_path / "xl_noxattn_rank4.safetensors"
    jlora.save_weights(str(path), jsites, jlp)
    want = jlora.state_dict_numpy(jsites, jlp)

    sd = tslider.read_tensors(str(path))
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)

    tsites = tlora.filter_sites_to_keys(sd.keys(), tlora.create_sites(
        port, rank=4, alpha=2.0, target_replace=CONV, train_method="noxattn"))
    tlp = tlora.load_weights(str(path), tsites)
    back = tlora.state_dict_numpy(tsites, tlp)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_written_slider_loads_identically_in_jax(tiny_xl, tmp_path):
    _, params, port = tiny_xl
    tsites = tlora.create_sites(port, rank=4, alpha=1.0, target_replace=CONV, train_method="noxattn")
    g = torch.Generator().manual_seed(3)
    tlp = tlora.init_lora_params(tsites, generator=g)
    for leaf in tlp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g)
    path = tmp_path / "port.safetensors"
    tlora.save_weights(str(path), tsites, tlp)
    want = tlora.state_dict_numpy(tsites, tlp)

    from safetensors.numpy import load_file

    got = load_file(str(path))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jsites = jlora.create_sites(params, rank=4, alpha=1.0, target_replace=CONV, train_method="noxattn")
    jback = jlora.state_dict_numpy(jsites, jlora.load_weights(str(path), jsites))
    for k, v in want.items():
        np.testing.assert_array_equal(jback[k], v, err_msg=k)


def test_safetensors_dtypes_and_metadata_round_trip(tmp_path):
    from safetensors.numpy import load_file, save_file

    tensors = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b16": torch.randn(5, 3).to(torch.bfloat16),
        "i": torch.arange(7, dtype=torch.int64),
        "scalar": torch.tensor(4.0),
        "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
    }
    path = tmp_path / "t.safetensors"
    tst.save_file(tensors, str(path), metadata={"format": "pt"})
    back = tst.load_file(str(path))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k].view(torch.uint8) if v.dtype == torch.bfloat16 else back[k],
                           v.view(torch.uint8) if v.dtype == torch.bfloat16 else v)
    ref = load_file(str(path))  # the reference reader accepts the port's file
    np.testing.assert_array_equal(ref["a"], tensors["a"].numpy())
    # and the port reads the reference writer's file
    save_file({"x": np.ones((2, 2), np.float32), "y": np.arange(3, dtype=np.int32)}, str(tmp_path / "r.safetensors"))
    r = tst.load_file(str(tmp_path / "r.safetensors"))
    np.testing.assert_array_equal(r["x"].numpy(), np.ones((2, 2), np.float32))
    np.testing.assert_array_equal(r["y"].numpy(), np.arange(3, dtype=np.int32))


def test_overlay_per_row_scales_match_jax(tiny_xl):
    """Per-row scales [0, 1.5, -2] through the overlay: the port's forward
    hooks vs the JAX interceptor, same base weights and factors."""
    model, params, port = tiny_xl
    jsites, jlp = _jax_slider(params, seed=5)
    tsites = tlora.create_sites(port, rank=4, alpha=2.0, target_replace=CONV, train_method="noxattn")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    rng = np.random.default_rng(6)
    sample = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 32)).astype(np.float32)
    added = {
        "text_embeds": rng.standard_normal((3, 32)).astype(np.float32),
        "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (3, 1)),
    }
    scales = np.asarray([0.0, 1.5, -2.0], np.float32)
    with jlora.lora_overlay(jsites, jlp, jnp.asarray(scales)):
        want = np.asarray(model.apply({"params": params}, jnp.asarray(sample), 500, jnp.asarray(ctx),
                                      added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()}))
    added_t = {k: torch.from_numpy(v) for k, v in added.items()}
    with torch.no_grad():
        with tlora.LoRAOverlay(port, tsites, tlp)(torch.from_numpy(scales)):
            got = port(torch.from_numpy(sample), 500, torch.from_numpy(ctx), added_cond_kwargs=added_t).numpy()
        base = port(torch.from_numpy(sample), 500, torch.from_numpy(ctx), added_cond_kwargs=added_t).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(got[0], base[0])  # scale 0 is the base model
    assert np.abs(got[1] - base[1]).max() > 1e-3  # and the slider bites
    # hooks are gone after the block
    assert all(not m._forward_hooks for m in port.modules())


def test_slider_file_parts(tmp_path):
    sd = {
        "lora_unet_a_to_q.lora_down.weight": torch.zeros(2, 4),
        "lora_unet_a_to_q.lora_up.weight": torch.zeros(4, 2),
        "lora_unet_a_to_q.alpha": torch.tensor(1.0),
    }
    parts = tslider.split_parts(sd)
    assert set(parts) == {"unet"} and set(parts["unet"]) == set(sd)
    with pytest.raises(ValueError):
        tslider.split_parts({"mystery.weight": torch.zeros(1)})
    combined = dict(sd, **{"lora_te1_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight": torch.zeros(2, 4)})
    path = tmp_path / "te.safetensors"
    tst.save_file(combined, str(path))
    with pytest.raises(ValueError, match="no matching text encoder"):  # a te part needs its tower
        tslider.load_slider_file(str(path))
    tst.save_file(sd, str(tmp_path / "u.safetensors"))
    assert set(tslider.load_slider_file(str(tmp_path / "u.safetensors")).unet) == set(sd)
