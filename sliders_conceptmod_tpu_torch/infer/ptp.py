"""Prompt-to-prompt text helpers — word indices and attention alpha
schedules; the port's own copy of ``sliders_conceptmod_tpu/infer/ptp.py``
(numpy only), over the port's tokenizers (``models/tokenizer.py``).

Parity target: reference ``conceptmod/textsliders/ptp_utils.py:243-295``
(``get_word_inds``, ``get_time_words_attention_alpha``): locate which token
positions a word occupies in the tokenized prompt, and build per-timestep
per-token alpha tensors that gate when cross-attention edits apply.

These compose with ``models/unet.reweight_cross_attention`` (the controller
core): build a weight vector with :func:`token_weights`, or a full
[steps, S] schedule with :func:`time_words_attention_alpha` and apply row i
inside step i of a sampling loop.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def get_word_inds(text: str, word_place: Union[int, str], tokenizer) -> np.ndarray:
    """Token positions (including BOS offset) covered by ``word_place`` —
    reference ptp_utils.py get_word_inds semantics: a string matches every
    occurrence of the word; an int indexes the split prompt."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, word in enumerate(split_text) if word_place == word]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        ids = tokenizer([text])[0]
        # strip bos and padding/eos to get per-word token counts
        # (CLIP BPE can split one word into several tokens)
        try:
            words_encoded = [tokenizer([w])[0] for w in split_text]
            lens = [int(np.sum((w != ids[-1]) & (w != ids[0]))) or 1 for w in words_encoded]
        except Exception:
            lens = [1] * len(split_text)
        ptr = 1  # position 0 is BOS
        for i, n in enumerate(lens):
            if i in word_place:
                out.extend(range(ptr, ptr + n))
            ptr += n
    return np.array(out, dtype=np.int64)


def token_weights(seq_len: int, inds: Sequence[int], value: float) -> np.ndarray:
    """[S] weight vector: 1 everywhere, ``value`` at ``inds`` — feed to
    ``reweight_cross_attention``."""
    w = np.ones((seq_len,), np.float32)
    w[np.asarray(inds, np.int64)] = value
    return w


def time_words_attention_alpha(
    prompts: List[str],
    num_steps: int,
    cross_replace_steps: Union[float, Dict[str, float]],
    tokenizer,
    max_num_words: int = 77,
) -> np.ndarray:
    """[num_steps, len(prompts)-1, max_num_words] alpha schedule — reference
    ptp_utils.py get_time_words_attention_alpha: 1 while a token's edit is
    active (step < fraction·num_steps), 0 after; per-word overrides via the
    dict form {"default_": f, "word": f}."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)

    def bounds(v):
        return (0.0, v) if not isinstance(v, tuple) else v

    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words), np.float32)

    def set_range(bound, prompt_ind, word_inds=None):
        start, end = int(bound[0] * num_steps), int(bound[1] * num_steps)
        if word_inds is None:
            word_inds = np.arange(max_num_words)
        alpha[:start, prompt_ind, word_inds] = 0.0
        alpha[start:end, prompt_ind, word_inds] = 1.0
        alpha[end:, prompt_ind, word_inds] = 0.0

    default = bounds(cross_replace_steps["default_"])
    for i in range(len(prompts) - 1):
        set_range(default, i)
    for key, item in cross_replace_steps.items():
        if key == "default_":
            continue
        for i, prompt in enumerate(prompts[1:]):
            inds = get_word_inds(prompt, key, tokenizer)
            if len(inds) > 0:
                set_range(bounds(item), i, inds)
    return alpha
