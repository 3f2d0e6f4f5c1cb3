"""Shared set-up of the port's Flux tests: the tiny Flux transformer with
random weights in both packages, a tiny Flux diffusers directory both
packages load, prompt embeddings made from a seed with numpy, and a
darts-clone charsmap writer for the SentencePiece normalizer. Each cached
helper is built once per process; callers only read what it returns."""

import dataclasses
import functools
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np

from sliders_conceptmod_tpu.models import flux as jflux
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import flux as tflux

STEP_TOL = 2e-4  # fp32 Flux forwards and ESD steps, port vs JAX
LATENT_TOL = 1e-3  # sampler tokens (the bound of tests/test_torch_serve.py)
SEQ = 8  # the tiny family's T5 context
FLUX_VAE = dict(scaling_factor=0.3611, shift_factor=0.1159)  # FLUX.1's vae/config.json
PROMPT_WORDS = ["a photo of a person, smiling", "a person, frowning", "a red car", "a cat", "very old person"]


def jax_init(cfg, gh: int = 4, gw: int = 4):
    model = jflux.FluxTransformer2DModel(cfg)
    kw = {"guidance": 3.5} if cfg.guidance_embeds else {}
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, gh * gw, cfg.in_channels)), jnp.zeros((1,)),
        jnp.zeros((1, 2, cfg.joint_attention_dim)), jnp.zeros((1, cfg.pooled_projection_dim)), jnp.zeros((2, 3)),
        jnp.zeros((gh * gw, 3)), **kw))["params"]
    return model, params


@functools.lru_cache(maxsize=None)
def random_flux(seed: int = 3, scale: float = 0.1, dev: bool = False, **depth):
    """(JAX model, JAX params with N(0, scale²) leaves, the port's tiny Flux
    transformer holding them — the whole tree, nothing left over). ``depth``:
    ``num_layers`` / ``num_single_layers`` other than the tiny family's."""
    cfg = dataclasses.replace(jflux.FluxConfig.tiny(), guidance_embeds=dev, **depth)
    model, shapes = jax_init(cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    port = tflux.FluxTransformer2DModel(tflux.FluxConfig(**dataclasses.asdict(cfg)))
    assert load_jax_params(port, to_numpy_tree(params)) == []
    return model, params, port.eval().requires_grad_(False)


def emb(prompt: str, seq: int = SEQ, dim: int = 32, pooled_dim: int = 32):
    """A prompt's (text [seq, dim], pooled [pooled_dim]) from its CRC32."""
    r = np.random.default_rng(zlib.crc32(prompt.encode()))
    return (0.5 * r.standard_normal((seq, dim))).astype(np.float32), r.standard_normal(pooled_dim).astype(np.float32)


def build_charsmap(mapping) -> bytes:
    """``{source: normalized}`` → a SentencePiece precompiled charsmap: a
    little-endian uint32 byte size, a darts-clone double array of 256-unit
    blocks (each node's children at ``base ^ label``, its leaf at ``base``,
    bases unique), then the NUL-terminated normalized strings."""
    pool = b""
    trie: dict = {}
    for src, dst in sorted(mapping.items()):
        node = trie
        for c in src.encode():
            node = node.setdefault(c, {})
        node[None] = len(pool)
        pool += dst.encode() + b"\0"
    units, used, taken = [0], set(), {0}
    queue = [(trie, 0)]
    while queue:
        node, pos = queue.pop(0)
        labels = sorted(c for c in node if c is not None)
        slots = labels + ([0] if None in node else [])
        base = 1
        while base in used or any((base ^ c) in taken for c in slots):
            base += 1
        used.add(base)
        taken.update(base ^ c for c in slots)
        units += [0] * (max(base ^ c for c in slots) + 1 - len(units))
        units[pos] |= (pos ^ base) << 10
        if None in node:
            units[pos] |= 1 << 8
            units[base] = node[None] | (1 << 31)
        for c in labels:
            units[base ^ c] = c
            queue.append((node[c], base ^ c))
    units += [0] * (-len(units) % 256)
    blob = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(blob)) + blob + pool


def _write_component(sub, sd, config: dict):
    from sliders_conceptmod_tpu_torch.io.safetensors import save_file

    os.makedirs(sub)
    save_file({k: v.detach().contiguous() for k, v in sd.items()}, os.path.join(sub, "model.safetensors"))
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump(config, f)


def write_tiny_flux_dir(root, name: str = "tiny-flux-diffusers"):
    """A tiny Flux diffusers directory (its name says "tiny", which the JAX
    loader reads): ``transformer/`` (:func:`random_flux`'s), ``text_encoder_2/``
    (a seeded tiny T5 under transformers' names, the tied
    ``encoder.embed_tokens`` too), ``text_encoder/`` (a seeded tiny CLIP),
    ``tokenizer_2/spiece.model`` (synthetic) and ``vae/`` (a tiny VAE of the
    tiny transformer's 4 latent channels — 16 / 4 packed — with FLUX.1's
    scaling and shift and no quant convs). Returns its path."""
    import torch

    from sliders_conceptmod_tpu_torch.io.ldm_export import export_clip_text
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from sliders_conceptmod_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from sliders_conceptmod_tpu_torch.models.tokenizer import write_synthetic_spm
    from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    path = root / name
    _, _, port = random_flux()
    _write_component(path / "transformer", port.state_dict(), dataclasses.asdict(port.config))
    t5 = factory.build_module(lambda: T5EncoderModel(T5Config.tiny()), "cpu", torch.float32, 13)
    t5_sd = dict(t5.state_dict(), **{"encoder.embed_tokens.weight": t5.shared.weight})
    _write_component(path / "text_encoder_2", t5_sd, dataclasses.asdict(T5Config.tiny()))
    clip_cfg = CLIPTextConfig.tiny(hidden_size=32)
    clip = factory.build_module(lambda: CLIPTextEncoder(clip_cfg), "cpu", torch.float32, 10)
    _write_component(path / "text_encoder", export_clip_text(clip.state_dict(), prefix=""),
                     dataclasses.asdict(clip_cfg))
    os.makedirs(path / "tokenizer_2")
    write_synthetic_spm(str(path / "tokenizer_2" / "spiece.model"), PROMPT_WORDS)
    vae_cfg = dataclasses.replace(VAEConfig.sd3(), latent_channels=4, block_out_channels=(16, 32),
                                  layers_per_block=1, norm_num_groups=4, **FLUX_VAE)
    vae = factory.build_module(lambda: AutoencoderKL(vae_cfg), "cpu", torch.float32, 12)
    _write_component(path / "vae", vae.state_dict(), dataclasses.asdict(vae_cfg))
    return path


def write_flux_slider(path, params, seed=11, scale=0.3, rank=2):
    """A random ``-``-delimited slider over the JAX Flux tree, JAX-written."""
    from sliders_conceptmod_tpu.adapters import lora as jlora

    sites = jlora.create_sites(params, rank=rank, alpha=1.0, target_replace=["Attention"], train_method="full",
                               delimiter="-")
    rng = np.random.default_rng(seed)
    lp = jax.tree.map(lambda a: jnp.asarray(scale * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(seed), sites))
    jlora.save_weights(str(path), sites, lp)
    return str(path)
