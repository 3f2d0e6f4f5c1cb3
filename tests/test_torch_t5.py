"""The port's T5 encoder (``models/t5.py``) and SentencePiece tokenizer
(``models/tokenizer.py``) against the JAX package's.

* T5 tiny, and T5 at XXL's full width (d_model 4096, 64 heads of 64, FF
  10240) with one layer and a 1000-token vocabulary, from the same weights
  (``io/jax_params.py``) and ids: fp32 within 2e-4; the relative-position
  buckets equal JAX's at 8, 140 and 512 tokens;
* ``convert_t5_state_dict`` against JAX's on an HF-layout state dict (the
  tied ``encoder.embed_tokens`` included): the same tree, bit for bit;
* ``T5SpmTokenizer`` against JAX's (which builds a ``tokenizers`` Unigram) on
  ``tests/test_spm_tokenizer.py``'s file and on a synthetic file with a
  precompiled charsmap: ids equal; the protobuf reader against
  transformers' ``sentencepiece_model_pb2``;
* the charsmap reader against ``tokenizers``' ``normalizers.Precompiled`` on
  a darts-clone charsmap the test builds (``Ａ→A``, ``ﬁ→fi``, a two-character
  key, a grapheme with a combining mark);
* ``HashTokenizer`` as T5's stand-in (vocabulary 32128, bos 0, eos 1, pad 0)
  gives JAX's ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.models import t5 as jt5
from sliders_conceptmod_tpu.models import tokenizer as jtok
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_jax_tree, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import t5 as tt5
from sliders_conceptmod_tpu_torch.models import tokenizer as ttok
from _flux_assets import STEP_TOL, build_charsmap
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)
from test_spm_tokenizer import _write_tiny_spm

TEXTS = ["hello world", "hello", "", "  hello   world  ", "helloworld xyz", "hello\tworld", "a" * 40,
         "w o r l d", "Ａﬁ hello", "ẞ wörld"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_configs_match_jax():
    for name in ("xxl", "tiny"):
        assert dataclasses.asdict(getattr(tt5.T5Config, name)()) == dataclasses.asdict(getattr(jt5.T5Config, name)())
    assert tt5.T5Config.from_json({"d_model": 64, "num_layers": 3}) == tt5.T5Config(d_model=64, num_layers=3)


def _random_t5(cfg, seed=0, scale=0.05):
    model = jt5.T5EncoderModel(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    port = tt5.T5EncoderModel(tt5.T5Config(**dataclasses.asdict(cfg)))
    assert load_jax_params(port, to_numpy_tree(params)) == []
    return model, params, port


@pytest.mark.parametrize("which", ["tiny", "xxl_width_one_layer"])
def test_forward_matches_jax(which):
    cfg = jt5.T5Config.tiny() if which == "tiny" else jt5.T5Config(num_layers=1, vocab_size=1000)
    model, params, port = _random_t5(cfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 140)).astype(np.int32)
    want = np.asarray(model.apply({"params": params}, ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    assert got.shape == (2, 140, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=STEP_TOL, rtol=0)


@pytest.mark.parametrize("seq", [8, 140, 512])
def test_relative_position_buckets_match_jax(seq):
    pos = np.arange(seq)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(pos[None, :] - pos[:, None])))
    assert np.array_equal(tt5.relative_position_bucket(seq), want)


def test_convert_t5_state_dict_matches_jax():
    _, params, port = _random_t5(jt5.T5Config.tiny())
    hf = dict(port.state_dict(), **{"encoder.embed_tokens.weight": port.shared.weight.detach()})
    want = _flat(jt5.convert_t5_state_dict({k: v.numpy() for k, v in hf.items()}))
    clone = tt5.T5EncoderModel(tt5.T5Config.tiny())
    clone.load_state_dict(tt5.convert_t5_state_dict(hf))
    got = _flat(to_jax_tree(clone))
    assert set(got) == set(want) == set(_flat(params))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert tt5.T5EncoderModel.jax_path("encoder.block.0.layer.0.SelfAttention.q") == (
        "block_0", "layer_0", "SelfAttention", "q")


def _spm_with_charsmap(path):
    cm = build_charsmap({"Ａ": "A", "ﬁ": "fi", "ẞ": "ss"})
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁hello", -1.0, 1), ("▁world", -1.5, 1),
              ("▁A", -2.0, 1), ("fi", -2.5, 1), ("▁", -3.0, 1)] + [(c, -4.0, 1) for c in "helowrdAfi"]
    ttok.write_spm_model(str(path), pieces, precompiled_charsmap=cm)


@pytest.mark.parametrize("which", ["tiny", "charsmap", "synthetic"])
@pytest.mark.parametrize("max_length", [3, 8, 64])
def test_spm_tokenizer_ids_equal_jax(tmp_path, which, max_length):
    path = tmp_path / "spiece.model"
    if which == "tiny":
        _write_tiny_spm(path)
    elif which == "charsmap":
        _spm_with_charsmap(path)
    else:
        ttok.write_synthetic_spm(str(path), ["a photo of a person, smiling", "a red car", "hello world"])
    want = jtok.T5SpmTokenizer(str(path), max_length=max_length)(TEXTS)
    got = ttok.T5SpmTokenizer(str(path), max_length=max_length)(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), max_length)
    assert np.array_equal(got, want)


def test_spm_reader_matches_protobuf(tmp_path):
    try:
        from transformers.utils import sentencepiece_model_pb2_new as pb2
    except ImportError:
        from transformers.utils import sentencepiece_model_pb2 as pb2

    for make in (_write_tiny_spm, _spm_with_charsmap):
        path = tmp_path / f"{make.__name__}.model"
        make(path)
        m = pb2.ModelProto()
        m.ParseFromString(path.read_bytes())
        got = ttok.read_spm_model(str(path))
        assert got["pieces"] == [(p.piece, p.score, p.type) for p in m.pieces]
        assert (got["unk_id"], got["eos_id"], got["pad_id"]) == (m.trainer_spec.unk_id, m.trainer_spec.eos_id,
                                                                 m.trainer_spec.pad_id)
        assert got["precompiled_charsmap"] == m.normalizer_spec.precompiled_charsmap


def test_charsmap_matches_tokenizers_precompiled():
    from tokenizers import normalizers

    cm = build_charsmap({"Ａ": "A", "ﬁ": "fi", "AB": "y", "e": "E", "\u00e9": "<e-acute>", "ｶ": "カ"})
    want = normalizers.Precompiled(cm)
    got = ttok.PrecompiledCharsmap(cm)
    for text in ["Ａﬁ a", "AB", "A B", "éx", "éx", "ｶﾀｶﾅ", "plain text", "", "e" * 7, "ABAB"]:
        assert got(text) == want.normalize_str(text), repr(text)


def test_hash_tokenizer_as_t5_matches_jax():
    prompts = ["a photo of a person", "", "Green, RED  sky", "x " * 600]
    for length in (8, 16, 512):
        want = jtok.HashTokenizer(vocab_size=32128, max_length=length, bos=0, eos=1, pad=0)(prompts)
        got = ttok.HashTokenizer(vocab_size=32128, max_length=length, bos=0, eos=1, pad=0)(prompts)
        assert np.array_equal(got, want)
