"""Real-weight loading in the port against the JAX package, on the CPU.

The JAX package writes tiny checkpoints into ``tmp_path``
(``io/ldm_export.py``): SD1 with a VAE, SD2 with the OpenCLIP tower, and
tiny-xl with both towers, as ``.safetensors`` single files; the same tensors
as a ``.ckpt`` (``torch.save``, nested under ``state_dict``); and diffusers
directories built from the JAX tiny parameters by inverting the documented
layout rules (sharded UNet, config.json files, a synthetic tokenizer). Each
loads through JAX ``factory.load_models``/``load_models_xl`` and through the
port's; every port tensor equals the JAX parameter moved by
``io/jax_params.py``, bit for bit in fp32, and one UNet forward agrees within
2e-4. The port's CLIP tokenizer (no ``transformers``) is held against
``transformers.CLIPTokenizer`` on the repo's prompts and edge cases."""

import dataclasses
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sliders_conceptmod_tpu.io import ldm_export as le
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models.unet import UNetConfig as JUNetConfig
from sliders_conceptmod_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from sliders_conceptmod_tpu.models.vae import VAEConfig as JVAEConfig
from sliders_conceptmod_tpu_torch.io import ldm_convert as tldm
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, save_file
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.tokenizer import CLIPTokenizerFiles, write_synthetic_bpe_files
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4


def _tiny_vae_params():
    model = JAutoencoderKL(JVAEConfig.tiny())
    return model.init(jax.random.PRNGKey(5), jnp.zeros((1, 3, 16, 16)))["params"]


def assert_same_weights(module, jax_params):
    """``module``'s state equals the JAX tree moved through io/jax_params.py,
    bit for bit."""
    want = type(module)(module.config) if hasattr(module, "config") else None
    assert want is not None
    assert load_jax_params(want, to_numpy_tree(jax_params)) == []
    got_sd, want_sd = module.state_dict(), want.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert got_sd[k].dtype == torch.float32, k
        assert torch.equal(got_sd[k], want_sd[k]), k


def assert_unet_forward_agrees(tunet, junet_bundle, xl: bool):
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((2, 4, 8, 8))).astype(np.float32)
    ctx = (0.5 * rng.standard_normal((2, 5, 32))).astype(np.float32)
    added = None
    if xl:
        added = {"text_embeds": rng.standard_normal((2, 32)).astype(np.float32),
                 "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))}
    want = junet_bundle.apply_fn()(junet_bundle.params, jnp.asarray(x), jnp.asarray([3.0, 500.0]), jnp.asarray(ctx),
                                   added_cond_kwargs=None if added is None else
                                   {k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        got = tunet(torch.from_numpy(x), torch.tensor([3.0, 500.0]), torch.from_numpy(ctx),
                    added_cond_kwargs=None if added is None else {k: torch.from_numpy(v) for k, v in added.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _write_ckpt(src: str, dst: str) -> None:
    torch.save({"state_dict": load_file(src), "global_step": 0}, dst)


@pytest.fixture(scope="module")
def tiny_sd():
    _, te, unet, _ = jfactory.load_models("tiny")
    return te, unet, _tiny_vae_params()


def test_sd1_single_file_with_vae_loads_equal(tiny_sd, tmp_path):
    jte, junet, vae_params = tiny_sd
    path = str(tmp_path / "tiny-sd1.safetensors")
    le.save_ldm_checkpoint(path, le.export_ldm_checkpoint(junet.params, jte.params, vae_params, v2=False))
    _, jte2, jvae2, junet2, _ = jfactory.load_models(path, with_vae=True)
    ckpt = str(tmp_path / "tiny-sd1.ckpt")
    _write_ckpt(path, ckpt)
    for p in (path, ckpt):
        tok, te, unet, sched, vae = tfactory.load_models(p, with_vae=True, device="cpu")
        assert_same_weights(unet, junet2.params)
        assert_same_weights(te.model, jte2.params)
        assert_same_weights(vae, jvae2.params)
        assert vae.config.block_out_channels == (16, 32)  # the tiny VAE, read off the checkpoint
    assert_unet_forward_agrees(unet, junet2, xl=False)
    model_cfg = types.SimpleNamespace(name_or_path=path, v2=False, v_pred=False, clip_skip=None)
    models = tfactory.load_for_training(model_cfg, "ddim", torch.float32, with_vae=True, device="cpu")
    assert_same_weights(models.unet, junet2.params)  # the trainers' loader takes the file too
    assert not models.is_xl and models.encode("a cat")[0].shape == (77, 32)
    with pytest.raises(ValueError, match="carries no VAE"):
        bare = str(tmp_path / "tiny-novae.safetensors")
        le.save_ldm_checkpoint(bare, le.export_ldm_checkpoint(junet.params, jte.params, v2=False))
        tfactory.load_models(bare, with_vae=True, device="cpu")


def test_sd2_openclip_single_file_loads_equal(tiny_sd, tmp_path):
    jte, junet, _ = tiny_sd
    path = str(tmp_path / "tiny-sd2.safetensors")
    le.save_ldm_checkpoint(path, le.export_ldm_checkpoint(junet.params, jte.params, v2=True))
    assert any(k.startswith("cond_stage_model.model.transformer.resblocks.") for k in load_file(path))
    _, jte2, junet2, jsched = jfactory.load_models(path, v2=True, v_pred=True)
    _, te, unet, sched = tfactory.load_models(path, v2=True, v_pred=True, device="cpu")
    assert_same_weights(unet, junet2.params)
    assert_same_weights(te.model, jte2.params)
    assert sched.prediction_type == jsched.prediction_type == "v_prediction"
    # the towers encode alike (the fused in_proj split right)
    ids = np.asarray(te.tokenizer(["a photo of a cat"]))
    want = np.asarray(jte2.apply(jnp.asarray(ids)).last_hidden_state)
    with torch.no_grad():
        got = te.model(torch.from_numpy(ids.astype(np.int64))).last_hidden_state.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_xl_single_file_loads_equal(tmp_path):
    _, jtes, junet, _ = jfactory.load_models_xl("tiny-xl")
    vae_params = _tiny_vae_params()
    path = str(tmp_path / "tiny-xl.safetensors")
    le.save_ldm_checkpoint(path, le.export_sdxl_checkpoint(junet.params, jtes[0].params, jtes[1].params, vae_params))
    _, jtes2, junet2, _, jvae2 = jfactory.load_models_xl(path, with_vae=True)
    ckpt = str(tmp_path / "tiny-xl.ckpt")
    _write_ckpt(path, ckpt)
    for p in (path, ckpt):
        _, tes, unet, _, vae = tfactory.load_models_xl(p, with_vae=True, device="cpu")
        assert_same_weights(unet, junet2.params)
        assert_same_weights(tes[0].model, jtes2[0].params)
        assert_same_weights(tes[1].model, jtes2[1].params)  # bigG layout, projection included
        assert_same_weights(vae, jvae2.params)
        assert tes[1].model.text_projection is not None
    assert_unet_forward_agrees(unet, junet2, xl=True)


# -- diffusers directories -----------------------------------------------------

_LISTS = ("down_blocks", "up_blocks", "attentions", "resnets", "transformer_blocks", "downsamplers",
          "upsamplers", "net", "to_out", "layers")


def _torch_key(path) -> str:
    """A JAX tree path → the diffusers/transformers key (the inverse of the
    documented rules: ``<list>_<i>`` → ``<list>.<i>``, kernel/scale/embedding
    → weight)."""
    parts = []
    for seg in path[:-1]:
        for cont in _LISTS:
            if seg.startswith(cont + "_") and seg[len(cont) + 1:].isdigit():
                parts.extend([cont, seg[len(cont) + 1:]])
                break
        else:
            parts.append(seg)
    parts.append("weight" if path[-1] in ("kernel", "scale", "embedding") else path[-1])
    return ".".join(parts)


def _torch_sd(tree, clip: bool = False):
    sd = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(k.key for k in keypath)
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        key = _torch_key(path)
        if clip:
            key = key.replace("mlp_fc1", "mlp.fc1").replace("mlp_fc2", "mlp.fc2")
            if key.startswith(("token_embedding", "position_embedding")):
                key = "text_model.embeddings." + key
            elif key.startswith("layers."):
                key = "text_model.encoder." + key
            elif key.startswith("final_layer_norm"):
                key = "text_model." + key
        sd[key] = np.ascontiguousarray(arr)
    if clip:
        sd["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    return sd


def _write_component(root, name, sd, config, shards: int = 1):
    sub = os.path.join(root, name)
    os.makedirs(sub)
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump(config, f)
    keys = sorted(sd)
    if shards == 1:
        save_file(sd, os.path.join(sub, "model.safetensors"))
        return
    weight_map = {}
    for i in range(shards):
        fname = f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: sd[k] for k in keys[i::shards]}
        save_file(part, os.path.join(sub, fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(sub, "diffusion_pytorch_model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def _clip_config(cfg, projection: bool):
    out = {k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                                        "num_attention_heads", "max_position_embeddings", "hidden_act")}
    if projection:
        out["projection_dim"] = cfg.projection_dim
    return out


@pytest.mark.parametrize("xl", [False, True], ids=["sd1", "xl"])
def test_diffusers_directory_loads_equal(tmp_path, xl):
    root = str(tmp_path / ("tiny-xl-dir" if xl else "tiny-sd-dir"))
    if xl:
        _, jtes, junet, _ = jfactory.load_models_xl("tiny-xl")
        unet_cfg = JUNetConfig.tiny_xl()
    else:
        _, jte, junet, _ = jfactory.load_models("tiny")
        jtes, unet_cfg = [jte], JUNetConfig.tiny()
    vae_params = _tiny_vae_params()
    _write_component(root, "unet", _torch_sd(junet.params), dataclasses.asdict(unet_cfg), shards=2)
    vae_sd = _torch_sd(vae_params)
    if not xl:  # the VAE attention under diffusers' older names, as SD1.x-era directories carry it
        old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        vae_sd = {next((k.replace(f".{a}.", f".{b}.") for a, b in old.items() if f".attentions.0.{a}." in k), k): v
                  for k, v in vae_sd.items()}
        assert "decoder.mid_block.attentions.0.proj_attn.weight" in vae_sd
    _write_component(root, "vae", vae_sd, dataclasses.asdict(JVAEConfig.tiny()))
    for comp, te in zip(("text_encoder", "text_encoder_2"), jtes):
        _write_component(root, comp, _torch_sd(te.params, clip=True), _clip_config(te.model.config, comp != "text_encoder"))
    write_synthetic_bpe_files(os.path.join(root, "tokenizer"), ["a photo of a cat", "a person smiling"])
    if xl:
        _, jtes2, junet2, _, jvae2 = jfactory.load_models_xl(root, with_vae=True)
        toks, tes, unet, _, vae = tfactory.load_models_xl(root, with_vae=True, device="cpu")
    else:
        _, jte2, jvae2, junet2, _ = jfactory.load_models(root, with_vae=True)
        jtes2 = [jte2]
        tok, te, unet, _, vae = tfactory.load_models(root, with_vae=True, device="cpu")
        toks, tes = [tok], [te]
    assert_same_weights(unet, junet2.params)
    # the source tree: the JAX loader reads the VAE's older names as they are
    assert_same_weights(vae, vae_params if not xl else jvae2.params)
    for te, jte2 in zip(tes, jtes2):
        assert_same_weights(te.model, jte2.params)
    assert isinstance(toks[0], CLIPTokenizerFiles)  # tokenizer/vocab.json is read
    assert_unet_forward_agrees(unet, junet2, xl=xl)


def test_loader_refusals(tmp_path):
    (tmp_path / "notes.txt").write_text("x")
    with pytest.raises(ValueError, match="neither a diffusers directory"):
        tfactory.load_models(str(tmp_path / "notes.txt"), device="cpu")
    with pytest.raises(ValueError, match="Unmapped SD3 MMDiT key"):  # SD3 converts since its slice: a bad key raises
        tldm.convert_ldm_checkpoint({"model.diffusion_model.joint_blocks.0.x.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="Unmapped BFL Flux key"):  # Flux converts since its slice: a bad key raises
        tldm.convert_ldm_checkpoint({"double_blocks.0.img_attn.bogus.weight": torch.zeros(3, 1)})
    with pytest.raises(NotImplementedError, match="no single-file loader for Stable Cascade"):
        tldm.convert_ldm_checkpoint({"clip_txt_mapper.weight": torch.zeros(1, 1)})


# -- the tokenizer ---------------------------------------------------------------

EDGE_CASES = [
    "A Photo Of A CAT", "PERSON, Very OLD!!", "don't it's we're i'll they've he'd i'm", "r2d2 at 1024px, 3.5 stars",
    "v1-5 / sd2.1 + (xl)", "a, b; c: d? e! f.", "  lots   of\t\twhite\nspace  ", "", " ", "under_score a_b __x__",
    "café naïve résumé", "emoji 😀 face", "中文 mixed text", "ctrl\x07char\x00s", "quotes \"x\" 'y'",
    " ".join(f"word{i}" for i in range(120)),  # truncated to 75 tokens + BOS/EOS
]


def _prompt_files_texts():
    texts = []
    for path in sorted(glob.glob(os.path.join(REPO, "data", "prompts*.yaml"))):
        for entry in yaml.safe_load(open(path)) or []:
            for key in ("target", "positive", "negative", "neutral", "unconditional"):
                if isinstance(entry.get(key), str):
                    texts.append(entry[key])
    assert len(texts) > 20
    return texts


@pytest.mark.parametrize("pad_token_id", [None, 0], ids=["pad_eos", "pad_0"])
def test_tokenizer_matches_transformers(tmp_path, pad_token_id):
    from transformers import CLIPTokenizer

    texts = _prompt_files_texts()
    write_synthetic_bpe_files(str(tmp_path), texts + EDGE_CASES, n_merges=300)
    ref = CLIPTokenizer(vocab_file=str(tmp_path / "vocab.json"), merges_file=str(tmp_path / "merges.txt"))
    if pad_token_id is not None:
        ref.pad_token_id = pad_token_id
    mine = CLIPTokenizerFiles(str(tmp_path), pad_token_id=pad_token_id)
    prompts = texts + EDGE_CASES
    want = np.asarray(ref(prompts, padding="max_length", max_length=77, truncation=True)["input_ids"], np.int32)
    got = mine(prompts)
    assert got.dtype == np.int32 and got.shape == (len(prompts), 77)
    for p, a, b in zip(prompts, got, want):
        np.testing.assert_array_equal(a, b, err_msg=repr(p))
    assert (got[:, -1] == (ref.eos_token_id if pad_token_id is None else 0))[:len(texts)].all()
    merged = [len(mine.bpe("".join(mine.byte_encoder[b] for b in w.encode()))) for w in ("person", "photo")]
    assert min(merged) < 6  # the merges bite: a word is fewer symbols than letters
