"""Single-file export and ``combine_loras`` in the port against the JAX
package, on the CPU.

* ``io/ldm_export.py``: the SD1 (CLIP), SD2 (OpenCLIP) and SDXL (both towers)
  single-file dicts of the tiny families — the port's modules loaded from a
  JAX-written file — are the JAX exporter's dicts from the same weights, key
  for key and bit for bit; and export → the port's ``io/ldm_convert.py`` gives
  back every module's state bit-exactly;
* ``cli/export_single_file``: a slider baked into a tiny SD1 file (fp32 and
  ``--half``) and a tiny SDXL file writes the JAX CLI's file byte for byte;
  ``--flux`` writes the BFL layout and ``--sd3`` the SD3 layout;
* ``cli/combine_loras``: SD1/XL and SD3-style UNet keys, two text-encoder
  parts (one a torch ``.pt``), strengths on ``_down``, ``alpha`` and
  ``dora_scale`` unscaled: the JAX ``combine``'s tensors and file, byte for
  byte;
* (here for the files' time balance) bf16, the number the default route's
  flip waited for: one tiny-xl ESD step in bf16 weights, JAX's default route
  ``(True, False)`` against the port on that route and on its previous one
  ``(True, True)``, over four draws: the new default agrees within
  ``BF16_BOUND``; the previous route's gap and JAX's own gap between its
  two routes are printed as measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.cli import combine_loras as jcombine
from sliders_conceptmod_tpu.cli import export_single_file as jexport_cli
from sliders_conceptmod_tpu.core import config as jconfig
from sliders_conceptmod_tpu.diffusion import sampling as jsampling
from sliders_conceptmod_tpu.diffusion.schedulers import create_noise_scheduler as jscheduler
from sliders_conceptmod_tpu.io import ldm_export as jle
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu.train import esd as jesd
from sliders_conceptmod_tpu.train import optim as joptim
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import combine_loras as tcombine
from sliders_conceptmod_tpu_torch.cli import export_single_file as texport_cli
from sliders_conceptmod_tpu_torch.core import config as tconfig
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler as tscheduler
from sliders_conceptmod_tpu_torch.io import ldm_convert as tldm
from sliders_conceptmod_tpu_torch.io import ldm_export as tle
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import load_file
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.train import esd as tesd
from sliders_conceptmod_tpu_torch.train import optim as toptim
from test_torch_loaders import _tiny_vae_params
from test_torch_train import MAX_STEPS, _jax_draws, slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

FAMILIES = ["sd1", "sd2", "sdxl"]

# bf16 weights, one step: JAX (XLA, fused) and the port (ATen, op by op) round
# to bf16 at different points of the same graph, so the bound is bf16's. The
# ESD loss is the mean square of a residual small against the predictions,
# so its relative gap is the loosest; the gradient's norm and the AdamW update
# (eps 1e-4, lr 1e-2: 1e-4 is 1 % of a step) are well conditioned.
BF16_BOUND = dict(loss_rel=0.25, grad_norm_rel=0.1, factor_max_abs=1e-4)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Per family: the JAX exporter's dict, the file it makes (name with
    "tiny": the factories' tiny escape) and the port's modules loaded from it."""
    root = tmp_path_factory.mktemp("export")
    _, jte, junet, _ = jfactory.load_models("tiny")
    _, jtes, junet_xl, _ = jfactory.load_models_xl("tiny-xl")
    vae = _tiny_vae_params()
    out = {}
    for fam in FAMILIES:
        path = str(root / f"tiny-{fam}.safetensors")
        if fam == "sdxl":
            want = jle.export_sdxl_checkpoint(junet_xl.params, jtes[0].params, jtes[1].params, vae)
            jle.save_ldm_checkpoint(path, want)
            _, tes, unet, _, tvae = tfactory.load_models_xl(path, with_vae=True, device="cpu")
            modules = dict(unet=unet, vae=tvae, text_encoder=tes[0].model, text_encoder_2=tes[1].model)
        else:
            want = jle.export_ldm_checkpoint(junet.params, jte.params, vae, v2=fam == "sd2")
            jle.save_ldm_checkpoint(path, want)
            _, te, unet, _, tvae = tfactory.load_models(path, v2=fam == "sd2", with_vae=True, device="cpu")
            modules = dict(unet=unet, vae=tvae, text_encoder=te.model)
        out[fam] = dict(path=path, want=want, modules=modules, jax_unet=junet_xl if fam == "sdxl" else junet)
    return out


def _port_export(fam, modules):
    sd = {k: m.state_dict() for k, m in modules.items()}
    if fam == "sdxl":
        return tle.export_sdxl_checkpoint(sd["unet"], sd["text_encoder"], sd["text_encoder_2"], sd["vae"])
    return tle.export_ldm_checkpoint(sd["unet"], sd["text_encoder"], sd["vae"], v2=fam == "sd2")


@pytest.mark.parametrize("fam", FAMILIES)
def test_export_dict_matches_jax(tiny, fam):
    want, got = tiny[fam]["want"], _port_export(fam, tiny[fam]["modules"])
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == np.float32, k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("fam", FAMILIES)
def test_export_round_trips_through_ldm_convert(tiny, fam):
    back = tldm.convert_ldm_checkpoint(_port_export(fam, tiny[fam]["modules"]))
    assert set(back) == set(tiny[fam]["modules"])
    for comp, module in tiny[fam]["modules"].items():
        sd = module.state_dict()
        assert set(back[comp]) == set(sd), comp
        for k, v in sd.items():
            assert torch.equal(back[comp][k], v), (comp, k)


def _slider(tmp_path, jax_unet):
    """A JAX-written rank-2 attention slider with non-zero ups (the name
    carries the reference's settings for the file-name sniffing)."""
    sites = jlora.create_sites(jax_unet.params, rank=2, alpha=1.0, train_method="full")
    lp = jlora.init_lora_params(jax.random.PRNGKey(3), sites)
    rng = np.random.default_rng(3)
    lp = {n: {k: (jnp.asarray(0.2 * rng.standard_normal(v.shape), jnp.float32) if k == "up" else v)
              for k, v in leaf.items()} for n, leaf in lp.items()}
    path = str(tmp_path / "slider_full_rank2_alpha1.safetensors")
    jlora.save_weights(path, sites, lp)
    return path


@pytest.mark.parametrize("fam,extra", [("sd1", []), ("sd1", ["--half"]), ("sdxl", ["--xl"])],
                         ids=["sd1", "sd1_half", "sdxl"])
def test_export_single_file_cli_writes_the_jax_file(tiny, tmp_path, fam, extra):
    base = tiny[fam]["path"]
    argv = ["--base", base, "--slider", _slider(tmp_path, tiny[fam]["jax_unet"]), "--scale", "1.5"] + extra
    jexport_cli.main(argv + ["--output", str(tmp_path / "jax.safetensors")])
    sd = texport_cli.main(argv + ["--output", str(tmp_path / "port.safetensors"), "--device", "cpu"])
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "jax.safetensors").read_bytes()
    assert all(v.dtype == (torch.float16 if extra == ["--half"] else torch.float32) for v in sd.values())
    # the slider moved the site weights and nothing else
    src = load_file(base)
    moved = {k for k in src if not torch.equal(src[k].to(sd[k].dtype), sd[k])}
    assert moved and all(k.endswith(("to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight"))
                         for k in moved)


def test_export_cli_refuses_sd3_and_flux(tmp_path):
    """SD3 and Flux export since their slices (tests/test_torch_sd3_io.py and
    tests/test_torch_flux_io.py hold them against JAX): Flux writes BFL's
    transformer-only layout."""
    sd = texport_cli.main(["--base", "tiny-flux", "--output", str(tmp_path / "x.safetensors"), "--flux",
                           "--device", "cpu"])
    assert "double_blocks.0.img_attn.qkv.weight" in sd and "single_blocks.0.linear1.weight" in sd
    sd = texport_cli.main(["--base", "tiny-sd3", "--output", str(tmp_path / "sd3.safetensors"), "--sd3",
                           "--device", "cpu"])
    assert any(k.startswith("model.diffusion_model.joint_blocks.0.x_block.attn.qkv.") for k in sd)
    assert any(k.startswith("text_encoders.clip_g.transformer.") for k in sd)


def test_combine_loras_matches_jax(tmp_path):
    rng = np.random.default_rng(7)

    def part(names, tail_shapes):
        out = {}
        for n in names:
            for tail, shape in tail_shapes:
                out[f"{n}.{tail}"] = rng.standard_normal(shape).astype(np.float32)
        return out

    lora = [("lora_down.weight", (2, 8)), ("lora_up.weight", (8, 2)), ("alpha", ())]
    unet = part(["lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q",
                 "lora_unet-transformer_blocks-0-attn-to_k"], lora)
    unet["lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.dora_scale"] = np.ones((1, 8),
                                                                                                    np.float32)
    te1 = part(["lora_te1-text_model-encoder-layers-0-self_attn-q_proj"], lora)
    te2 = part(["lora_te2-encoder-block-0-layer-0-SelfAttention-q"], lora)
    paths = {n: str(tmp_path / f"{n}.safetensors") for n in ("unet", "te1")}
    np_save_file(unet, paths["unet"])
    np_save_file(te1, paths["te1"])
    paths["te2"] = str(tmp_path / "te2.pt")
    torch.save({k: torch.from_numpy(v) for k, v in te2.items()}, paths["te2"])
    want = jcombine.combine(paths["unet"], paths["te1"], paths["te2"], str(tmp_path / "jax.safetensors"),
                            0.8, 0.7, 1.3)
    got = tcombine.main([paths["unet"], paths["te1"], paths["te2"], str(tmp_path / "port.safetensors"),
                         "0.8", "0.7", "1.3"])
    assert set(got) == set(want) and len(got) == 4 * 3 + 1
    assert "transformer.transformer_blocks.0.attn.to_k.lora_A.weight" in got
    assert any(k.startswith("lora_te3_") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "jax.safetensors").read_bytes()
    with pytest.raises(ValueError, match="Unsupported"):
        tcombine.read_tensors(str(tmp_path / "x.ckpt"))


# ---------------------------------------------------------------------------
# bf16: the default route's number
# ---------------------------------------------------------------------------


def _gap(a, b) -> dict:
    """(loss, grad norm, factors) of ``a`` against ``b``: relative loss and
    grad-norm gaps, the factors' max abs gap."""
    return dict(loss_rel=abs(a[0] - b[0]) / abs(b[0]), grad_norm_rel=abs(a[1] - b[1]) / abs(b[1]),
                factor_max_abs=max(float(np.abs(a[2][k] - b[2][k]).max()) for k in b[2]))


def test_bf16_default_route_against_jax(slice_setup):
    """One tiny-xl ESD step in bf16 weights (fp32 factors), four draws: JAX's
    default route for a bf16 LoRA against the port's new default (the same
    route) and the port's previous route (the overlay warm-up), with JAX's own
    two routes as the yardstick. AdamW's eps is 1e-4 so that an update is a
    smooth function of its gradient (see the image-pair test above)."""
    model, params, _, jsites, jlp, tsites, jbank, tbank = slice_setup
    jmodel = junet.UNet2DConditionModel(model.config, dtype=jnp.bfloat16)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    port = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()).to(torch.bfloat16)
    load_jax_params(port, to_numpy_tree(params))
    port = port.eval().requires_grad_(False)
    add = jsampling.get_add_time_ids(64, 64)
    jsched = jscheduler("euler_a")
    jschedule = jsched.set_timesteps(MAX_STEPS)
    opt = dict(optimizer_args="eps=1e-4", grad_clip_norm=0.2)

    def unet_apply(p, sample, t, ctx, added_cond_kwargs=None):
        return jmodel.apply({"params": p}, sample, t, ctx, added_cond_kwargs=added_cond_kwargs)

    # JAX's default for a bf16 LoRA in the ESD trainers, and the port's
    default = jconfig.resolve_student_overlay(jconfig.TPUConfig(), False, "lora", default_overlay=True)
    assert default == tconfig.resolve_student_overlay(tconfig.TPUConfig(), False, "lora", default_overlay=True)
    previous = (True, True)
    jsteps = {}
    for route in (default, previous):
        jopt = joptim.get_optimizer("adamw", joptim.get_lr_schedule("constant", 1e-2, 10), **opt)
        jsteps[route] = jopt, jesd.make_esd_train_step(
            unet_apply, jsites, jsched, jschedule, jopt, jesd.ESDConfig(
                max_denoising_steps=MAX_STEPS, height=64, width=64, student_overlay=route[0],
                overlay_warmup=route[1], remat_unet=False), add_time_ids=jnp.asarray(add))

    def jax_step(route, key):
        jopt, step = jsteps[route]
        lp = jax.tree.map(jnp.array, jlp)
        lp, _, m = step(jparams, lp, jopt.init(lp), key, jbank)
        return float(m["loss"]), float(m["grad_norm"]), jlora.state_dict_numpy(jsites, lp)

    def port_step(route, draws):
        tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
        for leaf in tlp.values():
            for t in leaf.values():
                t.requires_grad_(True)
        tsched = tscheduler("euler_a")
        topt = toptim.get_optimizer("adamw", toptim.get_lr_schedule("constant", 1e-2, 10), **opt)
        step = tesd.make_esd_train_step(port, tsites, tlp, tsched, tsched.set_timesteps(MAX_STEPS), topt,
                                        tesd.ESDConfig(max_denoising_steps=MAX_STEPS, height=64, width=64,
                                                       student_overlay=route[0], overlay_warmup=route[1]),
                                        add_time_ids=torch.from_numpy(add))
        m = step(topt.init(toptim.flat_params(tsites, tlp)), tbank, draws=draws)
        return float(m["loss"]), float(m["grad_norm"]), tlora.state_dict_numpy(tsites, tlp)

    rows = []
    for seed in (13, 14, 15, 16):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, jschedule, 2)
        want = jax_step(default, key)
        rows.append(dict(seed=seed, timesteps_to=draws.timesteps_to,
                         new_default=_gap(port_step(default, draws), want),
                         previous_route=_gap(port_step(previous, draws), want),
                         jax_previous_route=_gap(jax_step(previous, key), want)))
    worst = {name: {m: max(r[name][m] for r in rows) for m in rows[0][name]}
             for name in ("new_default", "previous_route", "jax_previous_route")}
    print(f"bf16 tiny-xl ESD step against JAX's default route {default} (max over 4 draws): {worst}")
    assert all(np.isfinite(v) for g in worst.values() for v in g.values())
    for m, bound in BF16_BOUND.items():
        assert worst["new_default"][m] <= bound, (m, rows)
