"""CLIP text encoder — counterpart of ``sliders_conceptmod_tpu/models/clip.py``.

Causal transformer over 77 tokens with an fp32 softmax, pooled output at the
EOS position, optional projection head (SDXL te2), the penultimate hidden
state that SDXL conditions on and the ``clip_skip`` state that SD1/SD2
condition on. Module names follow the JAX tree
(``layers.<i>.self_attn.q_proj``, ``mlp_fc1``, ...), so the weight bridge and
text-encoder LoRA names line up. Attention over 77 tokens stays plain
PyTorch, as it stays plain XLA in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sliders_conceptmod_tpu_torch.models.norms import LayerNorm32


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "gelu" for OpenCLIP bigG (SDXL te2)
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for CLIPTextModelWithProjection

    @classmethod
    def sd15_te(cls):
        """openai/clip-vit-large-patch14 text tower (SD1.x)."""
        return cls()

    @classmethod
    def sd2_te(cls):
        """OpenCLIP ViT-H text tower (SD2.x): 1024 wide, 23 used layers of 24, gelu."""
        return cls(
            hidden_size=1024,
            intermediate_size=4096,
            num_hidden_layers=23,
            num_attention_heads=16,
            hidden_act="gelu",
        )

    @classmethod
    def sdxl_te1(cls):
        """SDXL text_encoder (CLIP ViT-L)."""
        return cls()

    @classmethod
    def sdxl_te2(cls):
        """SDXL text_encoder_2 (OpenCLIP ViT-bigG with 1280-dim projection)."""
        return cls(
            hidden_size=1280,
            intermediate_size=5120,
            num_hidden_layers=32,
            num_attention_heads=20,
            hidden_act="gelu",
            projection_dim=1280,
        )

    @classmethod
    def tiny(cls, projection_dim=None, hidden_size=32):
        """Tiny config for CPU tests."""
        return cls(
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_hidden_layers=2,
            num_attention_heads=4,
            projection_dim=projection_dim,
        )


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"Unknown activation: {name}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, S, d = x.shape
        hd = d // self.heads
        q = self.q_proj(x).view(B, S, self.heads, hd)
        k = self.k_proj(x).view(B, S, self.heads, hd)
        v = self.v_proj(x).view(B, S, self.heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * (hd**-0.5), k).float()
        attn = attn.masked_fill(~causal_mask, torch.finfo(torch.float32).min)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, d)
        return self.out_proj(out)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp_fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.hidden_act)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp_fc2(self.act(self.mlp_fc1(self.layer_norm2(x))))


@dataclass
class CLIPTextOutput:
    """hidden_states[i] is the input to layer i; [-1] is the final pre-LN
    hidden state; ``last_hidden_state`` has the final LayerNorm applied."""

    last_hidden_state: torch.Tensor
    pooled_output: torch.Tensor
    hidden_states: Tuple[torch.Tensor, ...]
    projected: Optional[torch.Tensor] = None


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.text_projection = (
            nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False) if cfg.projection_dim is not None else None
        )

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        cfg = self.config
        B, S = input_ids.shape
        pos = torch.arange(S, device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        causal = torch.ones((S, S), dtype=torch.bool, device=input_ids.device).tril()[None, None]
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, causal)
            hidden_states.append(x)
        last = self.final_layer_norm(x)
        # pooled = final-LN state at the first EOS position
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=1)
        pooled = last[torch.arange(B, device=input_ids.device), eos_pos]
        projected = self.text_projection(pooled) if self.text_projection is not None else None
        return CLIPTextOutput(
            last_hidden_state=last, pooled_output=pooled, hidden_states=tuple(hidden_states), projected=projected
        )


def penultimate_hidden_state(out: CLIPTextOutput) -> torch.Tensor:
    """SDXL conditioning uses hidden_states[-2]."""
    return out.hidden_states[-2]


def clip_skip_hidden_state(out: CLIPTextOutput, clip_skip: Optional[int]) -> torch.Tensor:
    """SD1/2 conditioning (reference model_util.py:91-109): ``clip_skip`` n > 1
    takes hidden_states[-n] (pre-LN); None or 1 the final LayerNorm output."""
    if clip_skip is None or clip_skip <= 1:
        return out.last_hidden_state
    return out.hidden_states[-clip_skip]
