"""Tokenization — CLIP's byte-level BPE from local files, or a deterministic stub.

Counterpart of ``sliders_conceptmod_tpu/models/tokenizer.py``; the same
callable interface ``tokenize(prompts) -> np.int32 [B, max_len]`` (padding to
77, truncation, input ids only).

* :class:`CLIPTokenizerFiles` — CLIP's tokenizer written out in plain Python
  on a model directory's ``tokenizer/vocab.json`` + ``merges.txt``: the ids
  ``transformers.CLIPTokenizer`` gives without ``ftfy`` (its default where
  ``ftfy`` is absent), with no package beyond the standard library.
* :class:`HashTokenizer` — the JAX package's deterministic ids for runs
  without tokenizer assets, so both packages condition on identical ids.

:func:`write_synthetic_bpe_files` writes a small ``vocab.json`` +
``merges.txt`` in CLIP's layout, learned from a word list, for the tests and
the card's smoke (no real vocabulary ships with the repo).
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
_MAX_MERGES = 49152 - 256 - 2  # the merges.txt lines CLIPTokenizer reads

# CLIP's split pattern is, in the ``regex`` package's syntax,
#   <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
# Written with ``re``: a letter is a word character that is neither a decimal
# digit nor "_" (``[^\W\d_]``), a number is a decimal digit (``\d``), and the
# rest is any run of characters that are neither whitespace nor word
# characters, or are "_". ``re`` counts the numbers outside the decimal digits
# (Unicode No and Nl: "²", "½", "Ⅻ") as word characters, so they join the
# letter runs here where ``regex`` makes each one a number token; every other
# input tokenizes as CLIPTokenizer tokenizes it.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible byte → printable-character table: the printable
    Latin-1 bytes map to themselves, the other 68 to U+0100 onwards."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clean_text(text: str) -> str:
    """What CLIPTokenizer does before its split without ``ftfy``: drop NUL,
    U+FFFD and control characters, turn whitespace into spaces, space out
    CJK ideographs, NFC-normalize, lower-case, and join the words with one
    space."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.extend((" ", ch, " "))
        else:
            out.append(ch)
    return " ".join(w.lower() for w in unicodedata.normalize("NFC", "".join(out)).split())


def _pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class CLIPTokenizerFiles:
    """CLIP's byte-level BPE on ``vocab.json`` + ``merges.txt``: clean and
    lower-case (:func:`clean_text`), split (``_PAT``), map each piece's UTF-8
    bytes through :func:`bytes_to_unicode`, mark its last symbol with
    ``</w>``, merge by rank, look the symbols up (unknown → ``<|endoftext|>``),
    then ``[BOS] + ids[:max_length - 2] + [EOS]`` padded to ``max_length``
    with ``pad_token_id`` (default: the EOS id; SDXL's tokenizer_2 pads with
    0)."""

    def __init__(self, tokenizer_dir: str, max_length: int = 77, pad_token_id=None):
        with open(os.path.join(tokenizer_dir, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1 : _MAX_MERGES + 1]  # line 0 is the "#version" header
        self.bpe_ranks = {tuple(line.split()): i for i, line in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id, self.eos_id = self.encoder[BOS], self.encoder[EOS]
        self.pad_id = self.eos_id if pad_token_id is None else int(pad_token_id)
        self.max_length = max_length
        self._cache: Dict[str, List[str]] = {BOS: [BOS], EOS: [EOS]}

    def bpe(self, token: str) -> List[str]:
        """One split piece (already byte-mapped) → its BPE symbols."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        while pairs:
            first, second = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if (first, second) not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            pairs = _pairs(word) if len(word) > 1 else set()
        self._cache[token] = list(word)
        return self._cache[token]

    def encode(self, text: str) -> List[int]:
        """Token ids without BOS/EOS, untruncated."""
        unk = self.eos_id
        ids = []
        for piece in _PAT.findall(clean_text(text)):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder.get(sym, unk) for sym in self.bpe(mapped))
        return ids

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        out = np.full((len(prompts), self.max_length), self.pad_id, dtype=np.int32)
        for row, text in enumerate(prompts):
            ids = [self.bos_id] + self.encode(text)[: self.max_length - 2] + [self.eos_id]
            out[row, : len(ids)] = ids
        return out


def write_synthetic_bpe_files(out_dir: str, texts: Iterable[str], n_merges: int = 400) -> None:
    """A ``vocab.json`` + ``merges.txt`` in CLIP's layout, learned from
    ``texts``: the 256 byte symbols and their ``</w>`` forms, then
    ``n_merges`` merges (the most frequent pair first; ties by the pair's
    text, so the files are the same on every machine), then BOS and EOS."""
    byte_encoder = bytes_to_unicode()
    words: collections.Counter = collections.Counter()
    for text in texts:
        for piece in _PAT.findall(clean_text(text)):
            mapped = "".join(byte_encoder[b] for b in piece.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    symbols = list(byte_encoder.values())
    vocab = symbols + [s + "</w>" for s in symbols]
    merges: List[Tuple[str, str]] = []
    for _ in range(n_merges):
        counts: collections.Counter = collections.Counter()
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                counts[pair] += n
        if not counts:
            break
        pair = min(counts, key=lambda p: (-counts[p], p))
        merges.append(pair)
        vocab.append(pair[0] + pair[1])
        new_words: collections.Counter = collections.Counter()
        for word, n in words.items():
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == pair:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            new_words[tuple(merged)] += n
        words = new_words
    vocab += [BOS, EOS]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


class HashTokenizer:
    """bos + word-hash ids + eos, padded with eos (CLIP pad==eos for te1).
    Deterministic ids for runs without tokenizer assets; NOT a language
    tokenizer."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77, bos: int = 49406, eos: int = 49407, pad=None):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos = bos, eos
        self.pad = eos if pad is None else pad

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        out = np.full((len(prompts), self.max_length), self.pad, dtype=np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos]
            for w in p.lower().split()[: self.max_length - 2]:
                h = 0
                for ch in w:  # stable across runs (unlike hash())
                    h = (h * 131 + ord(ch)) % (self.vocab_size - 3)
                ids.append(h + 1)
            ids.append(self.eos)
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(model_dir: str, component: str = "tokenizer", max_length: int = 77, pad_token_id=None):
    """CLIP tokenizer from <model_dir>/<component>; HashTokenizer otherwise."""
    tdir = os.path.join(model_dir, component) if model_dir else ""
    if tdir and os.path.isfile(os.path.join(tdir, "vocab.json")):
        return CLIPTokenizerFiles(tdir, max_length=max_length, pad_token_id=pad_token_id)
    return HashTokenizer(max_length=max_length, pad=pad_token_id)
