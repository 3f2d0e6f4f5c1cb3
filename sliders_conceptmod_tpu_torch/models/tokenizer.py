"""Tokenization — CLIP's byte-level BPE from local files, or a deterministic stub.

Counterpart of ``sliders_conceptmod_tpu/models/tokenizer.py``; the same
callable interface ``tokenize(prompts) -> np.int32 [B, max_len]`` (padding to
77, truncation, input ids only).

* :class:`CLIPTokenizerFiles` — CLIP's tokenizer written out in plain Python
  on a model directory's ``tokenizer/vocab.json`` + ``merges.txt``: the ids
  ``transformers.CLIPTokenizer`` gives without ``ftfy`` (its default where
  ``ftfy`` is absent), with no package beyond the standard library.
* :class:`HashTokenizer` — the JAX package's deterministic ids for runs
  without tokenizer assets, so both packages condition on identical ids
  (as T5's stand-in: vocabulary 32128, bos 0, eos 1, pad 0).
* :class:`T5SpmTokenizer` — T5's SentencePiece unigram tokenizer from a
  ``spiece.model`` alone: a protobuf reader, the precompiled charsmap
  normalizer (:class:`PrecompiledCharsmap`), the Metaspace split and Viterbi
  segmentation, giving the ids ``tokenizers`` gives (the JAX package builds
  it with ``tokenizers``; neither it nor ``sentencepiece`` is needed here).

:func:`write_synthetic_bpe_files` writes a small ``vocab.json`` +
``merges.txt`` in CLIP's layout, learned from a word list, and
:func:`write_synthetic_spm` a small ``spiece.model``, for the tests and the
card's smoke (no real vocabulary ships with the repo).
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import struct
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# T5's SentencePiece unigram tokenizer, from a ``spiece.model`` file
# ---------------------------------------------------------------------------

SPM_NORMAL, SPM_UNKNOWN, SPM_CONTROL = 1, 2, 3  # ModelProto.SentencePiece.Type
META = "▁"  # SentencePiece's whitespace symbol
_UNK_PENALTY = 10.0  # tokenizers' K_UNK_PENALTY: unk scores min(score) − 10


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """``(field number, wire type, value)`` of a protobuf message: varints as
    ints, fixed32 / fixed64 as raw bytes, length-delimited as bytes."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"spiece.model: unsupported protobuf wire type {wire}")
        yield num, wire, val


def _int32(v: int) -> int:
    """A varint-encoded int32 (negatives are 64-bit two's complement)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def read_spm_model(path: str) -> dict:
    """The parts of a SentencePiece ``ModelProto`` the T5 tokenizer uses:
    ``pieces`` [(piece, score, type)], the trainer spec's ``unk_id`` /
    ``bos_id`` / ``eos_id`` / ``pad_id`` (with the proto's defaults 0, 1, 2,
    −1) and the normalizer spec's ``precompiled_charsmap`` (bytes)."""
    with open(path, "rb") as f:
        buf = f.read()
    out = {"pieces": [], "unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": -1, "precompiled_charsmap": b""}
    ids = {40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}
    for num, wire, val in _fields(buf):
        if num == 1 and wire == 2:
            piece, score, ptype = "", 0.0, SPM_NORMAL
            for n, w, v in _fields(val):
                if n == 1:
                    piece = v.decode("utf-8")
                elif n == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
                elif n == 3:
                    ptype = v
            out["pieces"].append((piece, score, ptype))
        elif num == 2 and wire == 2:
            for n, w, v in _fields(val):
                if n in ids and w == 0:
                    out[ids[n]] = _int32(v)
        elif num == 3 and wire == 2:
            for n, w, v in _fields(val):
                if n == 2 and w == 2:
                    out["precompiled_charsmap"] = bytes(v)
    return out


def _put_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _put_field(num: int, wire: int, payload: bytes) -> bytes:
    if wire == 2:
        payload = _put_varint(len(payload)) + payload
    return _put_varint(num << 3 | wire) + payload


def write_spm_model(path: str, pieces, unk_id: int = 2, eos_id: int = 1, pad_id: int = -1,
                    precompiled_charsmap: bytes = b"") -> None:
    """Write a ``ModelProto`` with ``pieces`` [(piece, score, type)], the
    trainer spec's ids (bos −1) and, when given, a precompiled charsmap."""
    body = b"".join(_put_field(1, 2, _put_field(1, 2, p.encode("utf-8")) + _put_field(2, 5, struct.pack("<f", s))
                               + _put_field(3, 0, _put_varint(t))) for p, s, t in pieces)
    spec = b"".join(_put_field(n, 0, _put_varint(v)) for n, v in ((40, unk_id), (41, -1), (42, eos_id), (43, pad_id)))
    body += _put_field(2, 2, spec)
    if precompiled_charsmap:
        body += _put_field(3, 2, _put_field(2, 2, precompiled_charsmap))
    with open(path, "wb") as f:
        f.write(body)


def write_synthetic_spm(path: str, texts: Iterable[str]) -> None:
    """A small T5-style ``spiece.model`` for the tests and the card's smoke
    (no real vocabulary ships with the repo): ``<pad>`` 0, ``</s>`` 1,
    ``<unk>`` 2, then ``▁``-prefixed words of ``texts`` (more frequent, higher
    score), ``▁`` and every character seen, each at a low score."""
    counts = collections.Counter(w for t in texts for w in t.lower().split())
    pieces = [("<pad>", 0.0, SPM_CONTROL), ("</s>", 0.0, SPM_CONTROL), ("<unk>", 0.0, SPM_UNKNOWN)]
    pieces += [(META + w, -1.0 - i / 100.0, SPM_NORMAL) for i, (w, _) in enumerate(counts.most_common())]
    chars = sorted({c for w in counts for c in w})
    pieces += [(META, -8.0, SPM_NORMAL)] + [(c, -9.0, SPM_NORMAL) for c in chars]
    write_spm_model(path, pieces)


def _is_extend(ch: str) -> bool:
    cp = ord(ch)
    return (unicodedata.category(ch) in ("Mn", "Me", "Mc") or 0xFE00 <= cp <= 0xFE0F or 0xE0100 <= cp <= 0xE01EF
            or 0x1F3FB <= cp <= 0x1F3FF or 0x1160 <= cp <= 0x11FF or 0xD7B0 <= cp <= 0xD7FF or cp == 0x200D)


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters, as far as ``unicodedata`` can tell them:
    CR LF, a character with its following marks (Mn, Me, Mc), variation
    selectors, emoji modifiers, Hangul medial / final jamo and ZWJ (with the
    character a ZWJ joins), and regional-indicator pairs. Control
    characters stand alone. (UAX #29's prepend and Hangul-syllable rules
    are not modelled: no T5 prompt of the port's paths reaches them.)"""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        ch = text[i]
        if ch == "\r" and j < n and text[j] == "\n":
            j += 1
        elif unicodedata.category(ch) not in ("Cc", "Zl", "Zp"):
            if 0x1F1E6 <= ord(ch) <= 0x1F1FF and j < n and 0x1F1E6 <= ord(text[j]) <= 0x1F1FF:
                j += 1
            while j < n and _is_extend(text[j]):
                j += 2 if text[j] == "‍" and j + 1 < n else 1
        out.append(text[i:j])
        i = j
    return out


class PrecompiledCharsmap:
    """SentencePiece's precompiled normalizer (``normalizer_spec.
    precompiled_charsmap``) as ``tokenizers``' ``normalizers.Precompiled``
    applies it: a little-endian uint32 byte size, a darts-clone double array
    of that many bytes, then the pool of NUL-terminated normalized strings.
    Each grapheme shorter than 6 UTF-8 bytes is looked up whole; otherwise,
    or when it has no entry, each character is looked up alone. A lookup
    takes the first (shortest) prefix of the chunk's bytes that the array
    holds, and the whole chunk becomes that entry's string."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]

    def _lookup(self, chunk: str) -> Optional[str]:
        units = self.units
        pos = (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        for c in chunk.encode("utf-8"):
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                return self.pool[start:self.pool.index(b"\0", start)].decode("utf-8")
        return None

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self._lookup(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self._lookup(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


class T5SpmTokenizer:
    """T5's tokenizer from a ``spiece.model`` alone — the JAX package's
    ``T5SpmTokenizer``, which rebuilds the model as a ``tokenizers``
    ``Unigram``, written out with the standard library:

    * normalize: the precompiled charsmap (when the file has one), then runs
      of two or more spaces → one space;
    * pre-tokenize (Metaspace, prepend "always"): spaces → ``▁``, a ``▁`` in
      front unless the text starts with one, split before every ``▁``;
    * segment each piece by Viterbi over the vocabulary (every piece of the
      file at its score, its type ignored, as ``tokenizers`` builds it): a
      character that starts no vocabulary piece of its own length may be an
      unknown at min(score) − 10; consecutive unknowns fuse into one token;
      a token not in the vocabulary is ``unk_id``;
    * the ids, truncated to ``max_length − 1``, then eos (the trainer
      spec's, else 1), padded with the pad id (else 0).
    """

    def __init__(self, spm_file: str, max_length: int = 512):
        m = read_spm_model(spm_file)
        self.max_length = max_length
        self.unk_id = m["unk_id"]
        self.eos = m["eos_id"] if m["eos_id"] >= 0 else 1
        self.pad = m["pad_id"] if m["pad_id"] >= 0 else 0
        self.normalize_charsmap = (PrecompiledCharsmap(m["precompiled_charsmap"])
                                   if m["precompiled_charsmap"] else None)
        scores = [s for _, s, _ in m["pieces"]]
        self.scores = scores
        self.token_to_id = {p: i for i, (p, _, _) in enumerate(m["pieces"])}
        self.unk_score = min(scores) - _UNK_PENALTY
        self.trie: dict = {}
        for i, (piece, _, _) in enumerate(m["pieces"]):
            node = self.trie
            for ch in piece:
                node = node.setdefault(ch, {})
            node[None] = self.token_to_id[piece]  # a repeated piece: its last id, as the vocabulary map holds it

    def _segment(self, text: str) -> List[int]:
        n = len(text)
        best = [None] * (n + 1)  # (score, start, id) of the best path ending at each position
        best[0] = (0.0, None, None)
        for i in range(n):
            if best[i] is None:
                continue
            base = best[i][0]
            node, single = self.trie, False
            for j in range(i, n):
                node = node.get(text[j])
                if node is None:
                    break
                if None in node:
                    tid = node[None]
                    cand = base + self.scores[tid]
                    if best[j + 1] is None or cand > best[j + 1][0]:
                        best[j + 1] = (cand, i, tid)
                    single = single or j == i
            if not single:
                cand = base + self.unk_score
                if best[i + 1] is None or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, self.unk_id)
        tokens: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            _, start, tid = best[end]
            if tid == self.unk_id:
                fused.append(text[start:end])
            else:
                if fused:
                    tokens.append("".join(reversed(fused)))
                    fused = []
                tokens.append(text[start:end])
            end = start
        if fused:
            tokens.append("".join(reversed(fused)))
        return [self.token_to_id.get(t, self.unk_id) for t in reversed(tokens)]

    def encode(self, text: str) -> List[int]:
        if self.normalize_charsmap is not None:
            text = self.normalize_charsmap(text)
        text = re.sub(" {2,}", " ", text).replace(" ", META)
        if not text:  # an empty text takes no ▁ (tokenizers prepends to a character only)
            return []
        if not text.startswith(META):
            text = META + text
        ids: List[int] = []
        for piece in re.split(f"(?={META})", text):
            if piece:
                ids.extend(self._segment(piece))
        return ids

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        out = np.full((len(prompts), self.max_length), self.pad, dtype=np.int32)
        for i, p in enumerate(prompts):
            ids = self.encode(p)[: self.max_length - 1] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def load_t5_tokenizer(model_dir: str, max_length: int = 512):
    """``<model_dir>/tokenizer_2/spiece.model`` as :class:`T5SpmTokenizer`;
    else the JAX loader's T5 stand-in, :class:`HashTokenizer` (vocabulary
    32128, bos 0, eos 1, pad 0). A ``tokenizer.json`` is not read: the port
    carries no reader for it."""
    spm = os.path.join(model_dir, "tokenizer_2", "spiece.model") if model_dir else ""
    if spm and os.path.isfile(spm):
        return T5SpmTokenizer(spm, max_length=max_length)
    return HashTokenizer(vocab_size=32128, max_length=max_length, bos=0, eos=1, pad=0)
