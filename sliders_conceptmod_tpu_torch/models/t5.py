"""T5 v1.1 text encoder — counterpart of ``sliders_conceptmod_tpu/models/t5.py``
(HF ``T5EncoderModel``, google/t5-v1_1-xxl): Flux's prompt encoder (512
tokens) and the notrigger trainer's ``t5attn`` tower.

Architecture (v1.1): pre-RMS-norm blocks; self-attention without the
1/√d score scale; one relative-position bias table (bucketed,
bidirectional, 32 buckets, max distance 128) in block 0, its bias passed on
to every later block; the gated-GELU feed-forward (``wo(gelu(wi_0 x) ·
wi_1 x)``, tanh GELU in fp32); no biases anywhere.

Numerics follow JAX's: the norms take their statistics in fp32
(``models/norms.py::RMSNorm``), the scores are cast to fp32 before the bias
is added, the softmax runs in fp32 and its probabilities are cast back to
the activations' dtype. The attention is plain math (``torch.matmul``), as
JAX computes it (an einsum): it is no kernel of the port.

Module names are transformers' (``shared``, ``encoder.block.N.layer.0.
SelfAttention.q``, ``…layer.0.layer_norm``, ``…layer.1.DenseReluDense.wi_0``,
``encoder.final_layer_norm``), so an HF ``text_encoder_2/`` loads by name
(:func:`convert_t5_state_dict`). The JAX tree has no ``encoder`` level
(``block_0/layer_0/SelfAttention/q``): :meth:`T5EncoderModel.jax_path`
drops it, and a slider's names put it back with ``name_path_prefix=
("encoder",)`` (``lora_te2_encoder_block_0_layer_0_SelfAttention_q``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sliders_conceptmod_tpu_torch.adapters.lora import module_path
from sliders_conceptmod_tpu_torch.models.norms import RMSNorm


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)

    @classmethod
    def from_json(cls, cfg: dict) -> "T5Config":
        """An HF ``config.json`` (the keys the JAX loader reads)."""
        base = cls()
        return cls(**{k: cfg.get(k, getattr(base, k))
                      for k in ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads")})


@functools.lru_cache(maxsize=16)
def relative_position_bucket(seq_len: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """HF T5's bidirectional buckets of ``memory − query`` over a
    ``[seq_len, seq_len]`` grid (int64), in fp32 as JAX computes them."""
    pos = np.arange(seq_len)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * half
    n = np.abs(rel)
    max_exact = half // 2
    with np.errstate(divide="ignore"):
        large = (np.log(n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-9))
                 / np.float32(np.log(max_distance / max_exact)) * np.float32(half - max_exact))
    large = np.minimum(max_exact + large.astype(np.int64), half - 1)
    return ret + np.where(n < max_exact, n, large)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = (nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
                                        if has_relative_bias else None)

    def position_bias(self, seq_len: int, device) -> torch.Tensor:
        """``[1, H, S, S]`` fp32 from the bucket table."""
        cfg = self.cfg
        buckets = torch.from_numpy(relative_position_bucket(
            seq_len, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)).to(device)
        return self.relative_attention_bias(buckets).float().permute(2, 0, 1)[None]

    def forward(self, x, position_bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, S, _ = x.shape

        def heads(t):  # [B, S, H·D] -> [B, H, S, D]
            return t.view(B, S, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        if self.relative_attention_bias is not None:
            position_bias = self.position_bias(S, x.device)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)).float()  # no 1/sqrt(d)
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :].bool(), torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.d_kv)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_relative_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias=None, mask=None):
        out, position_bias = self.SelfAttention(self.layer_norm(x), position_bias, mask)
        return x + out, position_bias


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        g = self.wi_0(x)
        g = F.gelu(g.float(), approximate="tanh").to(g.dtype)
        return self.wo(g * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias), T5LayerFF(cfg)])

    def forward(self, x, position_bias=None, mask=None):
        x, position_bias = self.layer[0](x, position_bias, mask)
        return self.layer[1](x), position_bias


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, has_relative_bias=(i == 0)) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """``forward(input_ids [B, S] int, mask=None) -> [B, S, d_model]`` in the
    weights' dtype (the final norm's output)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    @staticmethod
    def jax_path(name: str) -> Tuple[str, ...]:
        """The JAX tree's path of a module: no ``encoder`` level."""
        path = module_path(name)
        return path[1:] if path[:1] == ("encoder",) else path

    def forward(self, input_ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids)
        position_bias = None
        for block in self.encoder.block:
            x, position_bias = block(x, position_bias, mask)
        return self.encoder.final_layer_norm(x)


def convert_t5_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``T5EncoderModel`` state dict under the port's names (they are
    transformers'): the tied ``encoder.embed_tokens.weight`` is dropped, or
    becomes ``shared.weight`` where the file stores only it. Any key the
    port has no parameter for raises in ``io/torch_convert.py::load_state``."""
    out = {k: v for k, v in sd.items() if k != "encoder.embed_tokens.weight"}
    if "shared.weight" not in out and "encoder.embed_tokens.weight" in sd:
        out["shared.weight"] = sd["encoder.embed_tokens.weight"]
    return out
