"""CLIP vision tower and image–text scorer — counterpart of
``sliders_conceptmod_tpu/models/clip_vision.py``.

Backs ``eval/clip_score.py``: the reference scores generated images with HF
``CLIPModel`` ViT-B/32's ``logits_per_image``. The ViT (as HF's
``CLIPVisionModel``): a non-overlapping patch convolution, a class token,
learned positions, ``pre_layrnorm``, the pre-LN encoder layers of the text
tower without its causal mask, ``post_layernorm`` on the class token. The
scorer adds the port's CLIP text tower (``models/clip.py``) with its
projection, the visual projection and ``logit_scale``. Attention over 50
tokens stays a plain product (fp32 softmax), as it is a plain einsum in the
JAX package, not a Pallas kernel.

Module names follow the transformers checkpoint (``vision_model.embeddings.
patch_embedding``, ``vision_model.encoder.layers.<i>.self_attn.q_proj``, …);
the encoder layers' MLP is ``mlp_fc1``/``mlp_fc2``, as in the text tower.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.io.resample import resize_like_pil
from sliders_conceptmod_tpu_torch.io.safetensors import load_file
from sliders_conceptmod_tpu_torch.io.torch_convert import clip_state_dict, load_state
from sliders_conceptmod_tpu_torch.models.clip import CLIPEncoderLayer, CLIPTextConfig, CLIPTextEncoder
from sliders_conceptmod_tpu_torch.models.norms import LayerNorm32
from sliders_conceptmod_tpu_torch.models.tokenizer import load_tokenizer

# HF CLIPProcessor normalization constants
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512

    @classmethod
    def vit_b32(cls) -> "CLIPVisionConfig":
        """openai/clip-vit-base-patch32's vision_config."""
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32,
                   patch_size=16, projection_dim=16)

    def layer_config(self) -> CLIPTextConfig:
        """The encoder layer's widths, as the text tower's layer takes them (quick_gelu)."""
        return CLIPTextConfig(hidden_size=self.hidden_size, intermediate_size=self.intermediate_size,
                              num_attention_heads=self.num_attention_heads, layer_norm_eps=self.layer_norm_eps)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)  # [B, gh·gw, D], row-major
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        h = torch.cat([cls, patches], dim=1)
        return h + self.position_embedding.weight[: h.shape[1]][None]


class CLIPVisionEncoderLayers(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg.layer_config()) for _ in range(cfg.num_hidden_layers))


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)  # (HF's spelling)
        self.encoder = CLIPVisionEncoderLayers(cfg)
        self.post_layernorm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values ``[B, 3, H, W]`` normalized → pooled ``[B, D]``."""
        h = self.pre_layrnorm(self.embeddings(pixel_values))
        unmasked = torch.ones((1, 1, h.shape[1], h.shape[1]), dtype=torch.bool, device=h.device)
        for layer in self.encoder.layers:
            h = layer(h, unmasked)
        return self.post_layernorm(h[:, 0])


class CLIPScorer(nn.Module):
    """Full CLIP: image and text towers, projections and ``logit_scale``."""

    def __init__(self, vision_config: CLIPVisionConfig, text_config: CLIPTextConfig):
        super().__init__()
        self.vision_config, self.text_config = vision_config, text_config
        self.vision_model = CLIPVisionEncoder(vision_config)
        self.text_model = CLIPTextEncoder(text_config)  # its text_projection is the scorer's
        self.visual_projection = nn.Linear(vision_config.hidden_size, vision_config.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """``logits_per_image`` ``[B_img, B_text]`` — HF CLIPModel semantics."""
        img = self.visual_projection(self.vision_model(pixel_values))
        txt = self.text_model(input_ids).projected
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * img @ txt.T


def preprocess_images(images: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 HWC images → normalized ``[B, 3, S, S]`` float32 (CLIPProcessor
    semantics, as the JAX function takes them from PIL: the shortest side
    resized to ``image_size`` with Pillow's bicubic, ``io/resample.py``, then
    a centre crop, rescale and normalize)."""
    out = []
    for arr in images:
        h, w = arr.shape[:2]
        short = min(w, h)
        size = (int(round(w * image_size / short)), int(round(h * image_size / short)))
        im = resize_like_pil(arr, size)
        h, w = im.shape[:2]
        left, top = (w - image_size) // 2, (h - image_size) // 2
        a = im[top : top + image_size, left : left + image_size].astype(np.float32) / 255.0
        a = (a - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
        out.append(a.transpose(2, 0, 1))
    return np.stack(out)


def port_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers ``CLIPModel`` state dict under the scorer's names."""
    text = clip_state_dict({k: v for k, v in sd.items() if k.startswith("text_model.")})
    out = {f"text_model.{k}": v for k, v in text.items()}
    for key, value in sd.items():
        if key.startswith("text_model.") or key.endswith("position_ids"):
            continue
        if key == "text_projection.weight":
            key = "text_model.text_projection.weight"
        out[key.replace("mlp.fc1.", "mlp_fc1.").replace("mlp.fc2.", "mlp_fc2.")] = value
    return out


def hf_state_dict(scorer: CLIPScorer) -> Dict[str, torch.Tensor]:
    """The scorer's state under transformers ``CLIPModel`` names (the way
    back from :func:`port_state_dict`)."""
    out = {}
    for key, value in scorer.state_dict().items():
        key = key.replace("mlp_fc1.", "mlp.fc1.").replace("mlp_fc2.", "mlp.fc2.")
        if key == "text_model.text_projection.weight":
            key = "text_projection.weight"
        elif key.startswith(("text_model.token_embedding", "text_model.position_embedding")):
            key = "text_model.embeddings." + key[len("text_model."):]
        elif key.startswith("text_model.layers."):
            key = "text_model.encoder." + key[len("text_model."):]
        out[key] = value
    return out


def configs_from_json(cfg: dict) -> Tuple[CLIPVisionConfig, CLIPTextConfig]:
    """``config.json`` of a CLIPModel directory → both towers' configs, the
    fields JAX's ``load_clip_scorer`` reads."""
    v, t = cfg["vision_config"], cfg["text_config"]
    vision_cfg = CLIPVisionConfig(
        hidden_size=v.get("hidden_size", 768),
        intermediate_size=v.get("intermediate_size", 3072),
        num_hidden_layers=v.get("num_hidden_layers", 12),
        num_attention_heads=v.get("num_attention_heads", 12),
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        projection_dim=cfg.get("projection_dim", 512),
    )
    text_cfg = CLIPTextConfig(
        vocab_size=t.get("vocab_size", 49408),
        hidden_size=t.get("hidden_size", 512),
        intermediate_size=t.get("intermediate_size", 2048),
        num_hidden_layers=t.get("num_hidden_layers", 12),
        num_attention_heads=t.get("num_attention_heads", 8),
        projection_dim=cfg.get("projection_dim", 512),
    )
    return vision_cfg, text_cfg


def load_clip_scorer(model_dir: str, device="cuda"):
    """Scorer (fp32, eval mode) and tokenizer from a local transformers
    ``CLIPModel`` directory: ``config.json``, ``model.safetensors`` and the
    tokenizer's ``vocab.json``/``merges.txt`` (``HashTokenizer`` without them)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        vision_cfg, text_cfg = configs_from_json(json.load(f))
    model = CLIPScorer(vision_cfg, text_cfg)
    load_state(model, port_state_dict(load_file(os.path.join(model_dir, "model.safetensors"))), model_dir)
    tokenizer = load_tokenizer(model_dir, component="", max_length=77)
    return model.to(device).eval(), tokenizer
