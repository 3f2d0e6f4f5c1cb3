"""Shared set-up of the port's SD3 tests: the tiny MMDiT with random weights
in both packages, the tiny SD3 towers, and prompt embeddings made from a
seed with numpy. Each helper is cached per process; callers only read what
it returns."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np

from sliders_conceptmod_tpu.models import mmdit as jmmdit
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import mmdit as tmmdit

STEP_TOL = 2e-4  # fp32 MMDiT forwards and ESD steps, port vs JAX
LATENT_TOL = 1e-3  # sampler latents (the bound of tests/test_torch_serve.py)
SEQ = 77 + 4  # the tiny family's joint context: 77 CLIP tokens + a 4-token zero T5 segment


def jax_init(cfg, key=0):
    model = jmmdit.SD3Transformer2DModel(cfg)
    params = model.init(jax.random.PRNGKey(key), jnp.zeros((1, cfg.in_channels, 8, 8)), jnp.zeros((1,)),
                        jnp.zeros((1, 2, cfg.joint_attention_dim)), jnp.zeros((1, cfg.pooled_projection_dim)))
    return model, params["params"]


@functools.lru_cache(maxsize=None)
def random_mmdit(seed: int = 3, scale: float = 0.1):
    """(JAX model, JAX params with N(0, scale²) leaves, the port's tiny MMDiT
    holding them — the whole tree, nothing left over)."""
    model, params = jax_init(jmmdit.MMDiTConfig.tiny())
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
    port = tmmdit.SD3Transformer2DModel(tmmdit.MMDiTConfig.tiny())
    assert load_jax_params(port, to_numpy_tree(params)) == []
    return model, params, port.eval().requires_grad_(False)


def emb(prompt: str, seq: int = SEQ, dim: int = 32, pooled_dim: int = 32):
    """A prompt's (text [seq, dim], pooled [pooled_dim]) from its CRC32."""
    r = np.random.default_rng(zlib.crc32(prompt.encode()))
    return (0.5 * r.standard_normal((seq, dim))).astype(np.float32), r.standard_normal(pooled_dim).astype(np.float32)


SD3_VAE_TINY = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4)


def _write_component(sub, sd, config):
    import dataclasses
    import json
    import os

    from sliders_conceptmod_tpu_torch.io.safetensors import save_file

    os.makedirs(sub)
    save_file({k: v.detach().contiguous() for k, v in sd.items()}, os.path.join(sub, "model.safetensors"))
    with open(os.path.join(sub, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f)


def write_tiny_sd3_dir(root):
    """A tiny SD3 diffusers directory (its name says "tiny", which the JAX
    loader reads): ``transformer/`` (the tiny MMDiT of :func:`random_mmdit`),
    ``text_encoder/`` and ``text_encoder_2/`` (seeded tiny towers with a
    projection, transformers names), ``vae/`` (a tiny 16-channel VAE without
    quant convs, SD3's scaling and shift factors). Returns its path."""
    import dataclasses

    import torch

    from sliders_conceptmod_tpu_torch.io.ldm_export import export_clip_text
    from sliders_conceptmod_tpu_torch.models import factory
    from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    path = root / "tiny-sd3-diffusers"
    _, _, port = random_mmdit()
    _write_component(path / "transformer", port.state_dict(), port.config)
    te_cfg = CLIPTextConfig.tiny(hidden_size=16, projection_dim=16)
    for seed, comp in enumerate(("text_encoder", "text_encoder_2")):
        te = factory.build_module(lambda: CLIPTextEncoder(te_cfg), "cpu", torch.float32, 10 + seed)
        _write_component(path / comp, export_clip_text(te.state_dict(), prefix=""), te_cfg)
    vae_cfg = dataclasses.replace(VAEConfig.sd3(), **SD3_VAE_TINY)
    vae = factory.build_module(lambda: AutoencoderKL(vae_cfg), "cpu", torch.float32, 12)
    _write_component(path / "vae", vae.state_dict(), vae_cfg)
    return path


def write_sd3_slider(path, params, seed=11, scale=0.3, rank=2):
    """A random ``-``-delimited slider over the JAX MMDiT tree, JAX-written."""
    from sliders_conceptmod_tpu.adapters import lora as jlora

    sites = jlora.create_sites(params, rank=rank, alpha=1.0, target_replace=["Attention"], train_method="full",
                               delimiter="-")
    rng = np.random.default_rng(seed)
    lp = jax.tree.map(lambda a: jnp.asarray(scale * rng.standard_normal(a.shape), jnp.float32),
                      jlora.init_lora_params(jax.random.PRNGKey(seed), sites))
    jlora.save_weights(str(path), sites, lp)
    return str(path)
