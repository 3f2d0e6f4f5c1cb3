"""Text-encoder slider parts in the port against the JAX package, on the
tiny-xl CLIP towers (fp32).

* ``adapters/slider_file.py::load_te_part``: a file with a ``lora_te1`` and
  a ``lora_te2`` part — LoRA, and DoRA (``.dora_scale``) — with per-site
  alphas; the port's towers merged at scales −2, 0 and 1.5
  (``SliderParts.merged_text_encoders``) encode prompts to the embeddings and
  pooled outputs that JAX's ``TEPart.merged_params`` → JAX CLIP gives,
  ≤ 2e-4; scale 0 is the plain tower exactly. The refusals: a part whose keys
  match no site, a key that lands on no created site, a file with a part and
  no tower, ``te2_is_t5``;
* the tiny sweep: a ``cli/combine_loras.py`` file (the UNet slider of the
  sweep tests plus both towers' parts) through the port's
  ``cli/generate_images_xl.py``, merged and ``--batch_scales``: the
  embeddings handed to the sampler are JAX ``encode_case``'s (the CLI's
  merge-then-encode of prompt and negative prompt, ≤ 2e-4); the images
  equal a UNet-only run's at scale 0 and differ from them at ±1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import _sweep_cli_assets as A
from sliders_conceptmod_tpu.adapters import dora as jdora
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import slider_file as jsfile
from sliders_conceptmod_tpu.cli import generate_images_xl as jcli_xl
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import slider_file as tsfile
from sliders_conceptmod_tpu_torch.cli import combine_loras as tcombine
from sliders_conceptmod_tpu_torch.cli import generate_images_xl as tcli_xl
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import save_file
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

TOL = 2e-4
SCALES = (-2.0, 0.0, 1.5)
PROMPTS = ["a photo of a person", ""]


def jax_part(te_params, index, seed, dora=False):
    """The reference-schema tensors of a random ``lora_te{index+1}`` part over
    a JAX tower (JAX layout → torch layout through ``state_dict_numpy``), two
    of its sites with their own alpha."""
    peft = jdora if dora else jlora
    sites = jlora.create_sites(te_params, rank=2, alpha=1.0, target_replace=["CLIPAttention", "CLIPSdpaAttention"],
                               prefix=f"lora_te{index + 1}", train_method="full",
                               name_path_prefix=jsfile.CLIP_NAME_PATH_PREFIX)
    key = jax.random.PRNGKey(seed)
    lp = jdora.init_lora_params(key, sites, te_params) if dora else jlora.init_lora_params(key, sites)
    rng = np.random.default_rng(seed)
    lp = {n: {k: jnp.asarray(v * (1 + 0.3 * rng.standard_normal(v.shape)) if k == "dora_scale" else
                             (0.3 * rng.standard_normal(v.shape) if k == "up" else v), jnp.float32)
              for k, v in leaf.items()} for n, leaf in lp.items()}
    sd = {k: np.asarray(v) for k, v in peft.state_dict_numpy(sites, lp).items()}
    sd[f"{sites[0].lora_name}.alpha"] = np.asarray(4.0, np.float32)  # per-site alphas
    sd[f"{sites[-1].lora_name}.alpha"] = np.asarray(0.5, np.float32)
    return sd


def write(path, sd):
    save_file({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The sweep tests' JAX-written tiny-xl file and UNet slider, and its two
    CLIP towers in both packages, the port's holding JAX's weights."""
    root = A.make_assets(tmp_path_factory.mktemp("te"), "xl")
    _, jtes, _, _ = jfactory.load_models_xl(str(root / "tiny-xl.safetensors"))
    _, ttes, _, _ = tfactory.load_models_xl(str(root / "tiny-xl.safetensors"), device="cpu")
    for jte, tte in zip(jtes, ttes):
        assert load_jax_params(tte.model, to_numpy_tree(jte.params)) == []
        tte.model.eval().requires_grad_(False)
        np.testing.assert_array_equal(tte.tokenizer(PROMPTS), np.asarray(jte.tokenizer(PROMPTS)))
    return root, jtes, ttes


@pytest.fixture
def towers(assets):
    return assets[1:]


def jax_encode(jtes, jparts, scale, prompts):
    merged = jparts.merged_text_encoder_params([te.params for te in jtes], scale)
    text, pooled = jfactory.encode_prompts_xl([dataclasses.replace(te, params=p) for te, p in zip(jtes, merged)],
                                              prompts)
    return np.asarray(text), np.asarray(pooled)


@pytest.mark.parametrize("dora", [False, True], ids=["lora", "dora"])
def test_merged_towers_encode_as_jax_te_parts(towers, tmp_path, dora):
    jtes, ttes = towers
    sd = dict(jax_part(jtes[0].params, 0, 1, dora), **jax_part(jtes[1].params, 1, 2, dora))
    path = write(tmp_path / "te.safetensors", sd)
    jparts = jsfile.load_slider_file(path, [te.params for te in jtes])
    tparts = tsfile.load_slider_file(path, [te.model for te in ttes])
    assert tparts.has_te and tparts.unet is None and [p.index for p in tparts.te_parts] == [0, 1]
    for jp, tp in zip(jparts.te_parts, tparts.te_parts):
        assert [s.lora_name for s in tp.sites] == [s.lora_name for s in jp.sites]
        assert [s.alpha for s in tp.sites] == [s.alpha for s in jp.sites] and len({s.alpha for s in tp.sites}) == 3
        assert (tp.peft.__name__.endswith("dora"), jp.peft.__name__.endswith("dora")) == (dora, dora)
    with torch.inference_mode():
        base = tfactory.encode_prompts_xl(ttes, PROMPTS)
    for scale in SCALES:
        want = jax_encode(jtes, jparts, scale, PROMPTS)
        with tparts.merged_text_encoders(scale), torch.inference_mode():
            got = tfactory.encode_prompts_xl(ttes, PROMPTS)
        for g, w, name in zip(got, want, ("text", "pooled")):
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0, err_msg=f"{name} at {scale}")
        if scale == 0:
            assert all(torch.equal(g, b) for g, b in zip(got, base))  # m = 0 is the plain tower
        else:
            assert (got[0] - base[0]).abs().max() > 1e-3  # the part bites, the empty prompt's row too
            assert (got[0][1] - base[0][1]).abs().max() > 1e-3
    with torch.inference_mode():  # the block put every weight back
        assert all(torch.equal(a, b) for a, b in zip(tfactory.encode_prompts_xl(ttes, PROMPTS), base))


def test_te_part_refusals(towers, tmp_path):
    jtes, ttes = towers
    good = jax_part(jtes[0].params, 0, 3)
    foreign = {k.replace("self_attn_q_proj", "mlp_fc1"): v for k, v in good.items() if "self_attn_q_proj" in k}
    for name, sd, match in (("none", foreign, "no matching lora_te1 keys"),
                            ("partial", dict(good, **foreign), "match no full site")):
        path = write(tmp_path / f"{name}.safetensors", sd)
        with pytest.raises(ValueError, match=match):
            jsfile.load_slider_file(path, [te.params for te in jtes])
        with pytest.raises(ValueError, match=match):
            tsfile.load_slider_file(path, [te.model for te in ttes])
    path = write(tmp_path / "te.safetensors", dict(good, **jax_part(jtes[1].params, 1, 4)))
    for jargs, targs in (((), ()), (([jtes[0].params],), ([ttes[0].model],))):  # no tower, or no second tower
        with pytest.raises(ValueError, match="no matching text encoder"):
            jsfile.load_slider_file(path, *jargs)
        with pytest.raises(ValueError, match="no matching text encoder"):
            tsfile.load_slider_file(path, *targs)
    with pytest.raises(ValueError, match="no matching lora_te2 keys"):  # a CLIP part bound as T5 finds no site
        tsfile.load_slider_file(path, [te.model for te in ttes], te2_is_t5=True)


def test_combine_loras_file_through_the_xl_sweep(assets, tmp_path, monkeypatch):
    assets, jtes, _ = assets
    te1 = write(tmp_path / "te1.safetensors", jax_part(jtes[0].params, 0, 5))
    te2 = write(tmp_path / "te2.safetensors", jax_part(jtes[1].params, 1, 6))
    combined = str(tmp_path / "combined_full_rank2_alpha1.safetensors")
    tcombine.main([str(assets / "xl" / A.SLIDER), te1, te2, combined, "1.0", "1.0", "1.0"])
    jparts = jsfile.load_slider_file(combined, [te.params for te in jtes])
    assert jparts.has_te and len(jparts.te_parts) == 2

    A.fp32(monkeypatch, jcli_xl, tcli_xl)
    seen = []
    real_loop, real_scales = tcli_xl.sample_loop, tcli_xl.sample_loop_scales
    monkeypatch.setattr(tcli_xl, "sample_loop", lambda *a, **k: seen.append(
        (a[6], k["added_cond_kwargs"]["text_embeds"])) or real_loop(*a, **k))
    monkeypatch.setattr(tcli_xl, "sample_loop_scales", lambda *a, **k: seen.append(
        (a[8], k["added_cond_kwargs"]["text_embeds"])) or real_scales(*a, **k))
    scales = (-1.0, 0.0, 1.0)
    runs = {}
    for name, slider, extra in (("merged", combined, []), ("batched", combined, ["--batch_scales"]),
                                ("unet_only", str(assets / "xl" / A.SLIDER), [])):
        argv = A.args(assets, "xl", tmp_path / name, "--device", "cpu", "--scales=-1,0,1", *extra)
        argv[1] = slider
        tcli_xl.main(argv)
        runs[name] = {s: np.asarray(Image.open(tmp_path / name / slider.rsplit("/", 1)[1] / str(s) / "0_0.png"))
                      for s in scales}

    # JAX encode_case: the parts merged at the scale, then prompt and negative ("") encoded
    want = {s: jax_encode(jtes, jparts, s, ["", "a photo of a person"]) for s in scales}
    merged_calls, batched_call = seen[:3], seen[3]
    for s, (emb, pooled) in zip(scales, merged_calls):
        np.testing.assert_allclose(emb.numpy(), want[s][0], atol=TOL, rtol=0, err_msg=f"merged at {s}")
        np.testing.assert_allclose(pooled.numpy(), want[s][1], atol=TOL, rtol=0)
    # --batch_scales: scale-major uncond rows, then scale-major cond rows
    emb_b = np.concatenate([want[s][0][:1] for s in scales] + [want[s][0][1:] for s in scales])
    pooled_b = np.concatenate([want[s][1][:1] for s in scales] + [want[s][1][1:] for s in scales])
    np.testing.assert_allclose(batched_call[0].numpy(), emb_b, atol=TOL, rtol=0)
    np.testing.assert_allclose(batched_call[1].numpy(), pooled_b, atol=TOL, rtol=0)

    np.testing.assert_array_equal(runs["merged"][0.0], runs["unet_only"][0.0])  # the parts are off at 0
    for s in (-1.0, 1.0):
        assert not np.array_equal(runs["merged"][s], runs["unet_only"][s])  # and bite at ±1
        gap = np.abs(runs["merged"][s].astype(int) - runs["batched"][s].astype(int))
        assert gap.max() <= 1, (s, gap.max())  # merged and batched routes agree in fp32
