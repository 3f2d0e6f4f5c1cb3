"""The port's baseline helpers (``eval/baselines.py``) and its tokenizers'
added tokens against the JAX package on the CPU.

* ``add_tokens``: the port's BPE tokenizer gives the ids transformers'
  ``CLIPTokenizer.add_tokens`` gives in the JAX package's tokenizer, bit for
  bit, on prompts that put the token against whitespace, punctuation,
  letters, another added token and other case (the match is case-sensitive,
  in the raw text, before the split); the hash tokenizer gives JAX's ids
  (lower-cased, ``vocab_size + n``); a repeat, or a token the vocabulary
  holds, raises in both.
* The file readers (``load_edited_unet``, ``load_textual_inversion``,
  ``load_textual_inversion_xl``) return JAX's numbers bit for bit on every
  file kind JAX reads: ``.safetensors`` and ``.pt``, diffusers' and A1111's
  layouts, ``clip_l``/``clip_g`` in any case, two unnamed keys (file
  order), one key.
* ``add_inversion_token`` grows the tower's table as JAX's does: the old
  rows bit-equal, the new row JAX's, ``config.vocab_size`` following; the
  encoded prompt within fp32 2e-4 of JAX's; the pooled row stays at the
  first EOS although the added id (49408) is larger than EOS's.
* ``patch_custom_diffusion_kv`` writes JAX's weights: bit for bit in fp32
  (copies and ``u @ v`` additions), within one bf16 rounding in bf16; other
  tensors untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from sliders_conceptmod_tpu.eval import baselines as jb
from sliders_conceptmod_tpu.io import ldm_export as le
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models import tokenizer as jtok
from sliders_conceptmod_tpu_torch.eval import baselines as tb
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import tokenizer as ttok
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

PROMPTS = ["a photo with <new1>", "<new1>, smiling", "A <NEW1>", "x<new1>y", "a <new1><new1> b", "  <new1>  ",
           "<New1>", "a\t<new1>\nb", "<new1>s", "<sks> and <new1>", "<new1><sks>x", "a photo with <sks>!",
           "<new", "smiling person with a hat"]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    ttok.write_synthetic_bpe_files(str(d), ["a photo of a person", "smiling person with a hat", "red car"])
    return str(d)


def test_bpe_add_tokens_matches_transformers(bpe_dir):
    jt, tt = jtok.CLIPTokenizerFiles(bpe_dir), ttok.CLIPTokenizerFiles(bpe_dir)
    assert tt.vocab_size == jt.vocab_size
    for token in ("<new1>", "<sks>", "<new"):  # "<new" is a prefix of "<new1>": the longest match wins
        assert tt.add_tokens(token) == jt.add_tokens(token) == tt.vocab_size - 1
    np.testing.assert_array_equal(tt(PROMPTS), jt(PROMPTS))
    for bad in ("<new1>", "a</w>", "a", ""):  # added before, in the vocabulary, or empty
        with pytest.raises(ValueError):
            tt.add_tokens(bad)
    with pytest.raises(ValueError):
        jt.add_tokens("<new1>")


def test_hash_add_tokens_matches_jax():
    jt, tt = jtok.HashTokenizer(), ttok.HashTokenizer()
    for token in ("<sks>", "<NEW1>"):
        assert tt.add_tokens(token) == jt.add_tokens(token)
    assert tt.add_tokens("<x>") == 49408 + 2
    jt.add_tokens("<x>")
    prompts = ["a photo with <sks>", "<new1> and <SKS>", "x<sks>y", "plain words"]
    np.testing.assert_array_equal(tt(prompts), jt(prompts))
    for t in (tt, jt):
        with pytest.raises(ValueError):
            t.add_tokens("<Sks>")  # the key is lower-cased


def _tensor_files(tmp, sd_np, stem):
    """``sd_np`` as ``<stem>.safetensors`` and ``<stem>.pt``."""
    st, pt = tmp / f"{stem}.safetensors", tmp / f"{stem}.pt"
    np_save_file(sd_np, str(st))
    torch.save({k: torch.from_numpy(v) for k, v in sd_np.items()}, str(pt))
    return st, pt


def test_load_edited_unet_matches_jax(tmp_path):
    _, _, junet, _ = jfactory.load_models("tiny")
    sd = {k: np.asarray(v, np.float32) + 0.01 for k, v in le._flax_to_torch_entries(junet.params).items()}
    for path in _tensor_files(tmp_path, sd, "uce_edited"):
        want = le._flax_to_torch_entries(jb.load_edited_unet(str(path)))
        got = tb.load_edited_unet(str(path))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32), err_msg=k)


def test_load_textual_inversion_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    one, multi = rng.standard_normal(32).astype(np.float32), rng.standard_normal((3, 32)).astype(np.float32)
    files = [_tensor_files(tmp_path, {"<sks>": one}, "learned_embeds"),
             _tensor_files(tmp_path, {"<sks>": multi}, "multi_embeds")]
    a1111 = tmp_path / "a1111.pt"
    torch.save({"string_to_token": {"*": 265}, "string_to_param": {"*": torch.from_numpy(multi)}, "name": "sks",
                "step": 3000}, str(a1111))
    for path in [p for pair in files for p in pair] + [a1111]:
        np.testing.assert_array_equal(tb.load_textual_inversion(str(path)).numpy(), jb.load_textual_inversion(str(path)))


@pytest.mark.parametrize("keys", [("CLIP_L", "clip_g"), ("zeta", "alpha"), ("only",)], ids=["named", "unnamed", "one"])
def test_load_textual_inversion_xl_matches_jax(tmp_path, keys):
    rng = np.random.default_rng(1)
    sd = {k: rng.standard_normal(16 * (i + 1)).astype(np.float32) for i, k in enumerate(keys)}
    for path in _tensor_files(tmp_path, sd, "xl_embeds"):
        got, want = tb.load_textual_inversion_xl(str(path)), jb.load_textual_inversion_xl(str(path))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def towers():
    """The tiny SD1 tower of both packages with the same (JAX's) weights."""
    _, jte, _, _ = jfactory.load_models("tiny")
    _, tte, _, _ = tfactory.load_models("tiny", device="cpu")
    assert not load_jax_params(tte.model, to_numpy_tree(jte.params))
    return jte, tte


def test_add_inversion_token_grows_the_table_as_jax(towers):
    jte, tte = towers
    old = tte.model.token_embedding.weight.detach().clone()
    emb = np.random.default_rng(2).standard_normal((2, old.shape[1])).astype(np.float32)  # multi-vector: the first
    jid = jb.add_inversion_token(jte, "<sks>", emb)
    tid = tb.add_inversion_token(tte, "<sks>", torch.from_numpy(emb))
    assert tid == jid == 49408
    table = tte.model.token_embedding.weight
    assert table.shape == (49409, old.shape[1]) and tte.model.config.vocab_size == jte.model.config.vocab_size == 49409
    assert torch.equal(table[:49408], old)
    np.testing.assert_array_equal(table.detach().numpy(), np.asarray(jte.params["token_embedding"]["embedding"]))
    prompts = ["a photo with <sks>", "<sks>"]
    ids = tte.tokenizer(prompts)
    np.testing.assert_array_equal(ids, jte.tokenizer(prompts))
    with torch.no_grad():
        out = tte.encode(prompts)
    want = jte.apply(jnp.asarray(ids))
    np.testing.assert_allclose(out.last_hidden_state.numpy(), np.asarray(want.last_hidden_state), atol=2e-4)
    np.testing.assert_allclose(out.pooled_output.numpy(), np.asarray(want.pooled_output), atol=2e-4)
    # the pooled row is the first EOS (49407), not the argmax of the ids (the added 49408)
    eos = [int(np.argmax(r == 49407)) for r in ids]
    assert [int(np.argmax(r)) for r in ids] != eos
    np.testing.assert_array_equal(out.pooled_output.numpy(), out.last_hidden_state.numpy()[[0, 1], eos])


@pytest.fixture(scope="module")
def xl_unets():
    _, _, junet, _ = jfactory.load_models_xl("tiny-xl")
    _, _, tunet, _ = tfactory.load_models_xl("tiny-xl", device="cpu")
    assert not load_jax_params(tunet, to_numpy_tree(junet.params))
    return junet, tunet


def _delta(sd):
    kv = sorted(k for k in sd if "attn2" in k and (".to_k." in k or ".to_v." in k))
    rng = np.random.default_rng(3)
    w_add, w_add3 = np.asarray(sd[kv[1]]), np.asarray(sd[kv[2]])
    return {
        kv[0]: (np.asarray(sd[kv[0]], np.float32) + 0.05).astype(np.float32),
        kv[1]: {"u": rng.standard_normal((w_add.shape[0], 1)).astype(np.float32),
                "v": rng.standard_normal((1, w_add.shape[1])).astype(np.float32)},
        kv[2]: {"u": rng.standard_normal((w_add3.shape[0], 3)).astype(np.float32),
                "v": rng.standard_normal((3, w_add3.shape[1])).astype(np.float32)},
        next(k for k in sd if ".attn1.to_k." in k): np.zeros_like(np.asarray(sd[kv[0]]), np.float32),  # not attn2
    }, kv[:3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_patch_custom_diffusion_kv_matches_jax(xl_unets, dtype):
    junet, tunet = xl_unets
    jparams = junet.params if dtype == torch.float32 else jax.tree.map(lambda a: a.astype(jnp.bfloat16), junet.params)
    unet = type(tunet)(tunet.config).to(dtype)
    unet.load_state_dict(tunet.state_dict())
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    delta, touched = _delta(le._flax_to_torch_entries(junet.params))
    want = le._flax_to_torch_entries(jb.patch_custom_diffusion_kv(jparams, delta))
    tb.patch_custom_diffusion_kv(unet, {k: (v if isinstance(v, dict) else torch.from_numpy(v)) for k, v in
                                        delta.items()})
    after = unet.state_dict()
    for k, v in after.items():
        if k not in touched:
            assert torch.equal(v, before[k]), k
            continue
        w = torch.from_numpy(np.asarray(want[k], np.float32))
        assert not torch.equal(v, before[k]), k
        if dtype == torch.float32:
            assert torch.equal(v, w), k
        else:  # one bf16 rounding of the same sum
            torch.testing.assert_close(v.float(), w, atol=0, rtol=2 ** -8)

