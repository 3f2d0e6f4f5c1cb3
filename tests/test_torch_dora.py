"""The port's DoRA adapter (``adapters/dora.py``) against the JAX package's.

On the tiny SD UNet with c3lier sites (Linear and 3×3 conv), from the same
weights:

* ``dora_scale`` at init — the base weights' per-input-column norms, in fp32
  and over a bf16 base (bf16 norms, as JAX computes them);
* the merge at several multipliers, in fp32 (≤ 2e-4 of the weight scale) and
  over bf16 weights (within a bf16 ulp of the delta and of the sum, at a few
  elements);
* the state dict: keys, ``[1, in]`` / ``[1, in, 1, 1]`` shapes and values
  equal to JAX ``state_dict_numpy``; a port-written ``.safetensors`` is the
  JAX-written file byte for byte, loads back bit-equal in the port, and loads
  in JAX ``dora.load_weights`` to the JAX factors; ``.pt`` too;
* one tiny-SD DDIM ESD step with DoRA (the merged route): loss, factors and
  ``dora_scale`` within 2e-4 of JAX; and, with LoRA, one tiny-SD step on each
  of the routes ``(True, False)`` and ``(False, None)``
  (tests/test_torch_merged_routes.py has the tiny-xl ones);
* ``trainer.train(peft_type="dora")`` on ``data/config-tiny.yaml``: the saved
  keys are the JAX trainer's (with ``.dora_scale``), the file reloads
  bit-equal, and a resumed run ends bit-identical, ``dora_scale`` included;
  ``cli/train_lora_xl.train_lora(peft_type="dora")`` returns ``.dora_scale``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu_torch.adapters import dora as tdora
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import train_lora_xl as tcli_xl
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.train import trainer as ttrainer
from test_torch_sd_esd import esd_steps_match_jax
from test_torch_merged_routes import ROUTE_IDS, ROUTES
from test_torch_sd_train import _random_unet
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = tlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + tlora.UNET_TARGET_REPLACE_MODULE_CONV


@pytest.fixture(scope="module")
def sd_setup():
    """The tiny SD UNet (JAX params, the port's module) and its c3lier sites
    in both packages; JAX DoRA factors with non-zero ups and moved scales."""
    _, params, port = _random_unet("tiny", seed=4)
    jsites = jlora.create_sites(params, rank=2, alpha=1.0, target_replace=TARGETS, train_method="full")
    tsites = tdora.create_sites(port, rank=2, alpha=1.0, target_replace=TARGETS, train_method="full")
    assert [s.lora_name for s in tsites] == [s.lora_name for s in jsites]
    assert {s.kind for s in tsites} == {"dense", "conv"}
    rng = np.random.default_rng(6)
    jlp = jdora.init_lora_params(jax.random.PRNGKey(1), jsites, base_params=params)
    jlp = {n: {k: (jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32) if k == "up"
                   else v * (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k == "dora_scale"
                   else v) for k, v in leaf.items()} for n, leaf in jlp.items()}
    return params, port, jsites, tsites, jlp


def _port_at(params, dtype):
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny()).to(dtype)
    load_jax_params(port, to_numpy_tree(params))
    return port.eval().requires_grad_(False)


def _torch_layout(kernel: np.ndarray) -> np.ndarray:
    return kernel.T if kernel.ndim == 2 else kernel.transpose(3, 2, 0, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_dora_scale_matches_jax(sd_setup, dtype):
    params, _, jsites, tsites, _ = sd_setup
    jparams = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), params)
    want = jdora.state_dict_numpy(jsites, jdora.init_lora_params(jax.random.PRNGKey(2), jsites, base_params=jparams))
    tlp = tdora.init_lora_params(tsites, _port_at(params, getattr(torch, dtype)), generator=torch.Generator())
    got = tdora.state_dict_numpy(tsites, tlp)
    assert set(got) == set(want)
    for s in tsites:
        k = f"{s.lora_name}.dora_scale"
        assert got[k].shape == want[k].shape == ((1, s.in_dim) if s.kind == "dense" else (1, s.in_dim, 1, 1))
        assert tlp[s.lora_name]["dora_scale"].dtype == torch.float32
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        else:  # the norm rounded to bf16 in both: equal bits
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert not np.any(got[f"{s.lora_name}.lora_up.weight"])
        assert got[f"{s.lora_name}.lora_down.weight"].shape == want[f"{s.lora_name}.lora_down.weight"].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multiplier", [1.0, -2.0])
def test_merge_matches_jax(sd_setup, dtype, multiplier):
    params, _, jsites, tsites, jlp = sd_setup
    jparams = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), params)
    jmerged = jdora.merge_lora_params(jparams, jsites, jlp, multiplier)
    port = _port_at(params, getattr(torch, dtype))
    tlp = tdora.load_weights_from_tensors(jdora.state_dict_numpy(jsites, jlp), tsites)
    merged = tdora.merge_lora_params(port, tsites, tlp, multiplier)
    assert len(merged) == len(tsites)
    for s, (key, got) in zip(tsites, merged.items()):
        assert got.dtype == getattr(torch, dtype) and not got.requires_grad
        want = _torch_layout(np.asarray(jlora._tree_at(jmerged, s.module_path + ("kernel",)), np.float32))
        base = port.get_parameter(key).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * np.abs(base).max(), err_msg=key)
        else:  # the fp32 deltas differ in their last bits (summation order), and one bf16
            # ulp (2^-7 relative) of the cast delta or of the sum may flip
            gap = np.abs(got.float().numpy() - want)
            assert np.all(gap <= 2**-7 * (np.abs(want - base) + np.abs(want))), (key, gap.max())
            assert np.mean(gap > 0) < 1e-3, key  # and only a few elements do
        assert np.abs(got.float().numpy() - base).max() > 0  # the adapter moved the weight


def test_state_dict_files_and_jax_load(sd_setup, tmp_path):
    _, _, jsites, tsites, jlp = sd_setup
    want = jdora.state_dict_numpy(jsites, jlp)
    tlp = tdora.load_weights_from_tensors(want, tsites)
    got = tdora.state_dict_numpy(tsites, tlp)
    assert set(got) == set(want) and any(k.endswith(".dora_scale") for k in got)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's file is the JAX package's, byte for byte
    tdora.save_weights(str(tmp_path / "port.safetensors"), tsites, tlp)
    jdora.save_weights(str(tmp_path / "jax.safetensors"), jsites, jlp)
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "jax.safetensors").read_bytes()
    for name in ("port.safetensors", "port.pt"):
        path = str(tmp_path / name)
        if name.endswith(".pt"):
            tdora.save_weights(path, tsites, tlp)
        back = tdora.load_weights(path, tsites)
        for n, leaf in tlp.items():
            for k, t in leaf.items():
                assert torch.equal(back[n][k], t), (name, n, k)
        jback = jdora.load_weights(path, jsites)  # a port-written DoRA file loads in JAX
        for n, leaf in jlp.items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(np.asarray(jback[n][k]), np.asarray(v), err_msg=f"{name} {n}.{k}")
    bad = dict(want)
    bad[f"{tsites[0].lora_name}.dora_scale"] = want[f"{tsites[0].lora_name}.dora_scale"].T
    with pytest.raises(ValueError, match="dora_scale shape"):
        tdora.load_weights_from_tensors(bad, tsites)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_sd_esd_step_routes_match_jax(route):
    esd_steps_match_jax("tiny", "epsilon", 1.0, route=route, seeds=(11,))


def test_sd_dora_esd_step_matches_jax():
    before, got = esd_steps_match_jax("tiny", "epsilon", 1.0, route=(False, None), peft="dora", seeds=(11,))
    moved = max(np.abs(got[k] - before[k]).max() for k in got if k.endswith(".dora_scale"))
    assert moved > 5e-3  # dora_scale is trained with the factors


def _tiny_config(path, yaml_name="config-tiny.yaml", iterations=4, per_steps=2):
    cfg = tconfig.load_config_from_yaml(os.path.join(REPO, "data", yaml_name))
    cfg.prompts_file = os.path.join(REPO, cfg.prompts_file)
    cfg.save.path = str(path)
    cfg.save.per_steps = per_steps
    cfg.train.iterations = iterations
    cfg.logging.verbose = False
    return cfg


def test_trainer_trains_dora_saves_and_resumes_bit_identically(tmp_path):
    cfg = _tiny_config(tmp_path / "full")
    prompts = tprompts.load_prompts_from_yaml(cfg.prompts_file)
    res = ttrainer.train(cfg, prompts, rank=2, peft_type="dora", device="cpu")
    assert len(res.losses) == 4 and all(np.isfinite(res.losses))
    last = str(tmp_path / "full" / f"{cfg.save.name}_last.safetensors")
    saved = tst.load_file(last)
    with torch.device("meta"):
        meta = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny())
    sites = tdora.create_sites(meta, rank=2, alpha=cfg.network.alpha, train_method=cfg.network.training_method)
    want_keys = {f"{s.lora_name}.{k}" for s in sites for k in ("lora_down.weight", "lora_up.weight", "alpha",
                                                                "dora_scale")}
    assert set(saved) == want_keys
    for s in sites:
        assert tuple(saved[f"{s.lora_name}.dora_scale"].shape) == (1, s.in_dim)
    back = tdora.load_weights(last, res.sites)
    for n, leaf in res.lora_params.items():
        for k, t in leaf.items():
            assert torch.equal(back[n][k], t.detach()), (n, k)

    cfg2 = _tiny_config(tmp_path / "resumed")
    res2 = ttrainer.train(cfg2, prompts, rank=2, peft_type="dora", device="cpu",
                          resume_from=str(tmp_path / "full"))
    assert res2.losses == res.losses[3:]
    resumed = tst.load_file(str(tmp_path / "resumed" / f"{cfg.save.name}_last.safetensors"))
    for k, v in saved.items():
        assert torch.equal(resumed[k], v), k


def test_train_lora_api_returns_dora_scale(tmp_path):
    text = open(os.path.join(REPO, "data", "config-tiny-xl.yaml")).read()
    config = tmp_path / "config.yaml"
    config.write_text(text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"'))
    sd = tcli_xl.train_lora("person", "old person", "young person", "", steps=1, rank=2, device="cpu",
                            resolution=64, config_file=str(config), peft_type="dora")
    assert len(sd) == 4 * 32 and sum(k.endswith(".dora_scale") for k in sd) == 32
