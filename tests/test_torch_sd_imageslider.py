"""The port's SD1/SD2 image-pair ("visual") slider slice against the JAX
package's.

* three tiny-SD image-pair steps (fp32, DDIM, no pooled embeddings and no
  ``add_time_ids``) from the same UNet weights, LoRA factors, bank and random
  draws — the port's draws derived from the JAX key as the JAX step draws
  them — against ``make_image_slider_step(student_overlay=True)``: loss,
  both halves and every factor within 2e-4;
* ``cli/train_lora_scale.py``'s SD branch through ``main`` on the CPU: the
  tiny SD UNet with the full SD VAE (the family's VAE, as in the JAX
  factory) over 256px PNG pairs, the resolution of the reference's SD
  trainer; the saved key set is the JAX trainer's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.train import imageslider as jimage
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import train_lora_scale as tcli
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.io import safetensors as tst
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.train import imageslider as timage
from sliders_conceptmod_tpu_torch.train import optim as toptim
from test_torch_imageslider import MAX_STEPS, _jax_draws, _write_folders
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 2e-4
SEQ, CTX = 11, 32


def test_sd_image_pair_steps_match_jax():
    model = junet.UNet2DConditionModel(junet.UNetConfig.tiny())
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, SEQ, CTX)))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params["params"])
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    port = port.eval().requires_grad_(False)

    jsites = jlora.create_sites(params, rank=2, alpha=1.0, train_method="full")
    jlp = jlora.init_lora_params(jax.random.PRNGKey(1), jsites)
    jlp = {n: {k: (v if k != "up" else jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32))
               for k, v in leaf.items()} for n, leaf in jlp.items()}
    tsites = tlora.create_sites(port, rank=2, alpha=1.0, train_method="full")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    for leaf in tlp.values():
        for t in leaf.values():
            t.requires_grad_(True)

    emb = {r: 0.5 * rng.standard_normal((SEQ, CTX)).astype(np.float32) for r in ("positive", "neutral", "uncond")}
    mean = rng.standard_normal((4, 3, 4, 8, 8)).astype(np.float32)
    logvar = (0.3 * rng.standard_normal((4, 3, 4, 8, 8)) - 1.0).astype(np.float32)
    table, pscales = [(1, 2), (0, 3)], [1.0, 2.0]
    jbank = jimage.ImageBank(jnp.asarray(mean), jnp.asarray(logvar), jnp.asarray(table, jnp.int32),
                             jnp.asarray(pscales, jnp.float32))
    tbank = timage.ImageBank(torch.from_numpy(mean), torch.from_numpy(logvar), table, pscales)

    def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
        return model.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

    jsched = jscheduler("ddim")
    jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10))
    icfg = dict(max_denoising_steps=MAX_STEPS, scaling_factor=0.18215)
    jstep = jimage.make_image_slider_step(
        unet_apply, jsites, jsched, jsched.set_timesteps(MAX_STEPS), jopt, jimage.ImageSliderConfig(**icfg),
        positive_emb=jnp.asarray(emb["positive"]), neutral_emb=jnp.asarray(emb["neutral"]),
        uncond_emb=jnp.asarray(emb["uncond"]), student_overlay=True)
    tsched = tscheduler("ddim")
    topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10))
    tstep = timage.make_image_slider_step(
        port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt, timage.ImageSliderConfig(**icfg),
        torch.from_numpy(emb["positive"]), torch.from_numpy(emb["neutral"]))
    tstate = topt.init(toptim.flat_params(tsites, tlp))

    lp = jax.tree.map(jnp.array, jlp)
    jstate = jopt.init(lp)
    before = tlora.state_dict_numpy(tsites, tlp)
    seen = set()
    for i, seed in enumerate((21, 22, 23)):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, jbank)
        seen.add((draws.pair, draws.timesteps_to))
        lp, jstate, jm = jstep(params, lp, jstate, key, jbank)
        tm = tstep(tstate, tbank, draws=draws)
        for name in ("loss", "loss_high", "loss_low"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=STEP_TOL, atol=1e-7, err_msg=name)
        want = jlora.state_dict_numpy(jsites, lp)
        got = tlora.state_dict_numpy(tsites, tlp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_TOL, rtol=0, err_msg=f"step {i}: {k}")
    assert len(seen) > 1  # the draws vary across steps
    assert max(np.abs(got[k] - before[k]).max() for k in got) > 5e-3  # the factors moved


def test_cli_sd_branch_trains_tiny_sd_at_256px_and_saves_the_jax_key_set(tmp_path, monkeypatch):
    """``main`` on data/config-tiny.yaml (the tiny SD family) on the CPU:
    256×256 PNG pairs through the full SD VAE (one encode per folder), two
    steps of the tiny SD UNet; the saved keys are the JAX trainer's."""
    _write_folders(str(tmp_path / "imgs"), ["low", "high"], ["x.png", "y.png"], tcli.SD_RESOLUTION, seed=7)
    text = open(os.path.join(REPO, "data", "config-tiny.yaml")).read()
    text = text.replace('"data/prompts-tiny.yaml"', f'"{os.path.join(REPO, "data", "prompts-tiny.yaml")}"')
    text = text.replace('"/tmp/slider_smoke"', f'"{tmp_path / "out"}"').replace("iterations: 4", "iterations: 2")
    (tmp_path / "config.yaml").write_text(text.replace("verbose: true", "verbose: false"))
    argv = ["--config_file", str(tmp_path / "config.yaml"), "--alpha", "1", "--rank", "2", "--device", "cpu",
            "--folder_main", str(tmp_path / "imgs"), "--folders", "low,high", "--scales=-1,1"]
    seen = []
    real_build = timage.build_image_bank

    def build(*args, **kw):
        seen.append(args[4])  # the resolution the bank is built at
        bank = real_build(*args, **kw)
        seen.append(tuple(bank.mean.shape))
        return bank

    monkeypatch.setattr(tcli.imageslider, "build_image_bank", build)
    res = tcli.main(tcli.build_parser().parse_args(argv))
    assert seen == [256, (2, 2, 4, 32, 32)]  # 256px → 32×32 latents of the SD VAE
    assert len(res.losses) == 2 and all(np.isfinite(res.losses)) and res.bank_seconds > 0
    assert {r["scale"] for r in res.metrics} == {1.0}
    out = tmp_path / "out" / "tiny_slider_alpha1.0_rank2_full"
    saved = tst.load_file(str(out / "tiny_slider_alpha1.0_rank2_full_last.safetensors"))
    shapes = jax.eval_shape(lambda: junet.UNet2DConditionModel(junet.UNetConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))["params"])
    jsites = jlora.create_sites(shapes, rank=2, alpha=1.0, train_method="full")
    assert set(saved) == {f"{s.lora_name}.{k}" for s in jsites for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    assert all(v.abs().max() > 0 for k, v in saved.items() if k.endswith("lora_up.weight"))
