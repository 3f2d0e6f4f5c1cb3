"""Model loading + prompt encoding — counterpart of
``sliders_conceptmod_tpu/models/factory.py`` for the SD1/SD2, SDXL, SD3,
Flux and Stable Cascade families (SD3: :func:`load_models_sd3` and
:func:`encode_prompts_sd3`; Flux: :func:`load_models_flux` and
:class:`FluxEncoder`; Stable Cascade: :func:`load_models_cascade` and
:func:`encode_prompts_cascade`; their docstrings give their sources).

``load_models`` (SD1/SD2) and ``load_models_xl`` build the weightless
families, chosen from the name as the JAX factory's ``_family_from_path``
chooses: ``tiny`` (a name containing "tiny"), ``sd21`` (``v2``, or a name
containing "stable-diffusion-2" or "sd2"), ``sd15`` (any other name, e.g.
``runwayml/stable-diffusion-v1-5``); ``tiny-xl`` (a name containing "tiny"
and "xl") and ``sdxl`` (any other name containing "xl", e.g.
``stabilityai/stable-diffusion-xl-base-1.0``) — the true architecture with
random weights made on the target device from a seeded ``torch.Generator``.
The initialisers mirror flax's defaults, which the JAX weightless family
uses, so random-weight models stay finite the same way:

* Linear / Conv kernels: lecun-normal — a normal truncated at ±2σ, rescaled
  to std ``1/sqrt(fan_in)`` (``fan_in`` = in · kh · kw);
* ConvTranspose kernels: the same over in · kh · kw;
* biases zero, norm scales one, GlobalResponseNorm's gamma and beta zero;
* embeddings: normal with std ``1/sqrt(features)``.

Real weights load as the JAX factory loads them:

* a diffusers directory (one holding ``unet/``): ``io/torch_convert.py``, each
  module's architecture from its ``config.json``, the tokenizer from
  ``tokenizer/`` (``tokenizer_2/``) when it has a ``vocab.json``;
* a single ``.safetensors`` / ``.ckpt`` file in the LDM/SGM layout:
  ``io/ldm_convert.py``, with the family's architecture (``v2`` picks SD2.1's)
  — except a file whose name contains "tiny", which is the tiny family with
  ``layers_per_block`` and the VAE's width read off the checkpoint (the JAX
  factory's escape that keeps the single-file surface testable on the CPU).

Weights are copied onto the device in ``weight_dtype``. ``with_vae`` on a
single file without a VAE raises.

``quantize_base`` (the JAX loaders' knob) stores the UNet's large Linears as
int8 ``QuantLinear``s (``adapters/quant.py``), quantized from the source
precision before any cast to ``weight_dtype``: the fp32 draw of the
weightless family, the checkpoint's own tensors of a directory or single
file — as JAX's ``quantize_init`` and ``quantize_host_tree`` do. A single
file that is an int8 artifact (``io/quant_cache.py``, written by
``cli/quantize_checkpoint.py`` in either package) is sniffed as the JAX
loaders sniff it: the UNet comes from it, and the text towers and the VAE
are the weightless family's.

``load_for_training`` is the trainers' one entry: it picks the family from
the config and returns the UNet, scheduler, optional VAE and a one-prompt
encoder. ``denoiser_on_meta`` builds the denoiser a loader would, on the
meta device and without reading a tensor (LoRA sites without a second load
of the base).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.adapters.lora import model_lock
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.diffusion.schedulers import create_noise_scheduler
from sliders_conceptmod_tpu_torch.io import quant_cache
from sliders_conceptmod_tpu_torch.io import torch_convert as tc
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params
from sliders_conceptmod_tpu_torch.models.cascade import CascadeConfig, GlobalResponseNorm, StableCascadeUNet
from sliders_conceptmod_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    clip_skip_hidden_state,
    penultimate_hidden_state,
)
from sliders_conceptmod_tpu_torch.models.norms import RMSNorm
from sliders_conceptmod_tpu_torch.models.tokenizer import load_tokenizer
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@dataclass
class TextEncoderBundle:
    model: CLIPTextEncoder
    tokenizer: object

    def encode(self, prompts: List[str]):
        """The tower's output; holds the tower's lock, so an encode never
        overlaps a text-encoder slider's weight swap on another thread
        (``adapters/slider_file.py``)."""
        device = self.model.token_embedding.weight.device
        ids = torch.from_numpy(self.tokenizer(prompts).astype(np.int64)).to(device)
        with model_lock(self.model):
            return self.model(ids)


def _lecun_normal(shape, device, generator: torch.Generator) -> torch.Tensor:
    fan_in = int(np.prod(shape[1:]))
    std = fan_in**-0.5 / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_flax_default(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter as flax's default initialisers would (see module
    docstring), in ``named_parameters`` order from one generator. Values are
    drawn in fp32 and cast to the parameter's dtype; a ``QuantLinear``
    quantizes its fp32 draw, at the place of the Linear's weight in the
    order."""
    for name, mod in module.named_modules():
        if isinstance(mod, quant.QuantLinear):
            mod.set_weight(_lecun_normal((mod.out_features, mod.in_features), mod.weight_q.device, generator))
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, RMSNorm)):
                p.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                w.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
                p.copy_(w)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                p.copy_(_lecun_normal(p.shape, p.device, generator))
            elif isinstance(mod, nn.ConvTranspose2d):  # [in, out, kh, kw]: fan-in over in·kh·kw
                p.copy_(_lecun_normal(p.transpose(0, 1).shape, p.device, generator).transpose(0, 1))
            elif isinstance(mod, GlobalResponseNorm):
                p.zero_()
            else:
                raise TypeError(f"no initialiser for {name}.{pname} ({type(mod).__name__})")


def _empty(factory, device, dtype, quantize: bool) -> nn.Module:
    """Construct on the meta device at ``dtype`` (with ``quantize``, its large
    Linears as int8 QuantLinears) and allocate, uninitialised, on ``device``."""
    with torch.device("meta"):
        model = factory().to(dtype)
        if quantize:
            quant.quantize_module(model)
    return model.to_empty(device=device)


def build_module(factory, device, dtype, seed: int, quantize: bool = False) -> nn.Module:
    """Construct on the meta device, materialise on ``device`` at ``dtype``,
    then fill with the seeded flax-default initialisers (``quantize``: the
    large Linears int8, quantized from their fp32 draws)."""
    model = _empty(factory, device, dtype, quantize)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_flax_default(model, gen)
    return model.eval().requires_grad_(False)


def _family(name_or_path: str, v2: bool = False) -> str:
    """The JAX factory's ``_family_from_path`` rule."""
    p = str(name_or_path).lower()
    if "tiny" in p:
        return "tiny-xl" if "xl" in p else "tiny"
    if "xl" in p:
        return "sdxl"
    if v2 or "stable-diffusion-2" in p or "sd2" in p:
        return "sd21"
    return "sd15"


_XL_FAMILIES = ("sdxl", "tiny-xl")
_UNET_CONFIGS = {"tiny": UNetConfig.tiny, "sd15": UNetConfig.sd15, "sd21": UNetConfig.sd21,
                 "tiny-xl": UNetConfig.tiny_xl, "sdxl": UNetConfig.sdxl}


def unet_config_for(name_or_path: str, v2: bool = False) -> UNetConfig:
    """The UNet architecture the loaders build for this model name."""
    return _UNET_CONFIGS[_family(name_or_path, v2)]()


def is_single_file(name_or_path: str) -> bool:
    return os.path.isfile(str(name_or_path)) and str(name_or_path).endswith((".ckpt", ".safetensors"))


def is_diffusers_dir(name_or_path: str) -> bool:
    return os.path.isdir(os.path.join(str(name_or_path), "unet"))


def is_sd3_dir(name_or_path: str) -> bool:
    return os.path.isdir(os.path.join(str(name_or_path), "transformer"))


def _check_target(name_or_path: str, device: str, marker: str = "unet") -> torch.device:
    p = str(name_or_path)
    if os.path.exists(p) and not (is_single_file(p) or os.path.isdir(os.path.join(p, marker))):
        raise ValueError(f"{p}: neither a diffusers directory (no {marker}/) nor a .ckpt/.safetensors checkpoint")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return device


def module_from_state(factory, sd, device, dtype, what: str, quantize: bool = False) -> nn.Module:
    """Construct on the meta device, materialise on ``device`` at ``dtype``,
    then copy ``sd`` in (``io/torch_convert.py::load_state``; ``quantize``:
    the large Linears int8, quantized from the checkpoint's tensors)."""
    model = _empty(factory, device, dtype, quantize)
    tc.load_state(model, sd, what)
    return model.eval().requires_grad_(False)


def _tokenizer(name_or_path: str, component: str, pad_token_id=None):
    p = str(name_or_path)
    return load_tokenizer(p if os.path.isdir(p) else "", component=component, pad_token_id=pad_token_id)


def _text_encoder(name_or_path: str, component: str, cfg: CLIPTextConfig, device, dtype, seed: int,
                  tok) -> TextEncoderBundle:
    """A directory's tower when it has ``component/``, else the weightless
    one from ``seed``."""
    if os.path.isdir(os.path.join(str(name_or_path), component)):
        sd, cfg = tc.load_text_encoder_state(str(name_or_path), component, cfg)
        return TextEncoderBundle(module_from_state(lambda: CLIPTextEncoder(cfg), sd, device, dtype, component), tok)
    return TextEncoderBundle(build_module(lambda: CLIPTextEncoder(cfg), device, dtype, seed), tok)


def _single_file_vae(path: str, trees: dict, full: VAEConfig, device, dtype) -> nn.Module:
    if not trees.get("vae"):
        raise ValueError(f"{path} carries no VAE (first_stage_model.*) but with_vae=True was requested")
    # the tiny escape may carry the tiny VAE or the full one: width off the checkpoint
    conv_in = trees["vae"]["decoder.conv_in.weight"]
    cfg = VAEConfig.tiny() if conv_in.shape[0] <= 32 else full
    cfg = dataclasses.replace(cfg, latent_channels=conv_in.shape[1],
                              use_quant_conv="quant_conv.weight" in trees["vae"],
                              use_post_quant_conv="post_quant_conv.weight" in trees["vae"])
    return module_from_state(lambda: AutoencoderKL(cfg), trees["vae"], device, dtype, f"{path} vae")


def quantized_unet_from_artifact(path: str, cfg: UNetConfig, device, dtype) -> nn.Module:
    """A UNet from an int8 artifact (``io/quant_cache.py``): the file's int8
    set is quantized, every other leaf is cast to ``dtype``."""
    return quantized_from_artifact(path, lambda: UNet2DConditionModel(cfg), device, dtype)


def quantized_from_artifact(path: str, factory, device, dtype) -> nn.Module:
    """The model ``factory()`` builds, from an int8 artifact: the file's int8
    set is quantized, every other leaf is cast to ``dtype``."""
    tree, scales = quant_cache.load_quantized(path, dtype)
    with torch.device("meta"):
        model = factory().to(dtype)
        quant.quantize_module(model, paths=scales)
    model = model.to_empty(device=device)
    unused = load_jax_params(model, tree)
    if unused:
        raise KeyError(f"{path}: {len(unused)} tensors have no parameter (e.g. {unused[:3]})")
    return model.eval().requires_grad_(False)


def _tiny_lpb(unet_sd) -> int:
    """The stride-3 LDM slots round-trip layers_per_block 1 and 2."""
    return 2 if any(k.startswith("down_blocks.0.resnets.1.") for k in unet_sd) else 1


def load_models(
    name_or_path: str,
    scheduler_name: str = "ddim",
    v2: bool = False,
    v_pred: bool = False,
    weight_dtype: torch.dtype = torch.float32,
    with_vae: bool = False,
    device: str = "cuda",
    quantize_base: bool = False,
):
    """SD1/SD2: (tokenizer, te, unet, scheduler[, vae]) from a diffusers
    directory, a single file, an int8 artifact or a weightless family name
    (see the module docstring; module i of a weightless (te, unet, vae) is
    initialised from seed i). The scheduler predicts ``v_prediction`` when
    ``v_pred``; a weightless family encodes with the full SD VAE, as the JAX
    factory's does. ``quantize_base``: the UNet's large Linears int8."""
    device = _check_target(name_or_path, device)
    scheduler = create_noise_scheduler(scheduler_name, prediction_type="v_prediction" if v_pred else "epsilon")
    if is_single_file(name_or_path) and quant_cache.is_quantized_artifact(name_or_path):
        tiny = "tiny" in os.path.basename(str(name_or_path)).lower()
        unet_cfg = denoiser_config(name_or_path, "sd1", v2)
        clip_cfg = CLIPTextConfig.tiny() if tiny else (CLIPTextConfig.sd2_te() if v2 else CLIPTextConfig.sd15_te())
        tok = load_tokenizer("", component="tokenizer")
        te = _text_encoder("", "text_encoder", clip_cfg, device, weight_dtype, 0, tok)
        unet = quantized_unet_from_artifact(str(name_or_path), unet_cfg, device, weight_dtype)
        out = (tok, te, unet, scheduler)
        return out + (_vae("", VAEConfig.sd(), device, weight_dtype, 2),) if with_vae else out
    if is_single_file(name_or_path):
        from sliders_conceptmod_tpu_torch.io.ldm_convert import load_ldm_checkpoint

        path = str(name_or_path)
        trees = load_ldm_checkpoint(path)
        if "tiny" in os.path.basename(path).lower():
            clip_cfg = CLIPTextConfig.tiny()
        else:
            clip_cfg = CLIPTextConfig.sd2_te() if v2 else CLIPTextConfig.sd15_te()
        unet_cfg = denoiser_config(path, "sd1", v2, trees["unet"])
        tok = load_tokenizer("", component="tokenizer")
        te = TextEncoderBundle(module_from_state(lambda: CLIPTextEncoder(clip_cfg), trees.get("text_encoder", {}),
                                                 device, weight_dtype, f"{path} text_encoder"), tok)
        unet = module_from_state(lambda: UNet2DConditionModel(unet_cfg), trees["unet"], device, weight_dtype,
                                 f"{path} unet", quantize_base)
        out = (tok, te, unet, scheduler)
        if with_vae:
            return out + (_single_file_vae(path, trees, VAEConfig.sd(), device, weight_dtype),)
        return out

    family = _family(name_or_path, v2)
    if family in _XL_FAMILIES:
        raise ValueError(f"load_models: {name_or_path!r} is an SDXL family name; use load_models_xl")
    clip_cfg = {"tiny": CLIPTextConfig.tiny, "sd21": CLIPTextConfig.sd2_te, "sd15": CLIPTextConfig.sd15_te}[family]()
    tok = _tokenizer(name_or_path, "tokenizer")
    te = _text_encoder(name_or_path, "text_encoder", clip_cfg, device, weight_dtype, 0, tok)
    unet = _unet(name_or_path, family, device, weight_dtype, 1, quantize_base)
    out = (tok, te, unet, scheduler)
    if with_vae:
        return out + (_vae(name_or_path, VAEConfig.sd(), device, weight_dtype, 2),)
    return out


def _unet(name_or_path: str, family: str, device, dtype, seed: int, quantize: bool = False) -> nn.Module:
    if is_diffusers_dir(name_or_path):
        sd, cfg = tc.load_unet_state(str(name_or_path))
        return module_from_state(lambda: UNet2DConditionModel(cfg), sd, device, dtype, f"{name_or_path}/unet",
                                 quantize)
    cfg = _UNET_CONFIGS[family]()
    return build_module(lambda: UNet2DConditionModel(cfg), device, dtype, seed, quantize)


def _vae(name_or_path: str, cfg: VAEConfig, device, dtype, seed: int) -> nn.Module:
    if os.path.isdir(os.path.join(str(name_or_path), "vae")):
        sd, cfg = tc.load_vae_state(str(name_or_path))
        return module_from_state(lambda: AutoencoderKL(cfg), sd, device, dtype, f"{name_or_path}/vae")
    return build_module(lambda: AutoencoderKL(cfg), device, dtype, seed)


def load_models_xl(
    name_or_path: str,
    scheduler_name: str = "euler_a",
    weight_dtype: torch.dtype = torch.float32,
    with_vae: bool = False,
    device: str = "cuda",
    with_unet: bool = True,
    quantize_base: bool = False,
):
    """SDXL: ([tok1, tok2], [te1, te2], unet, scheduler[, vae]) from a
    diffusers directory, an SGM single file, an int8 artifact or a weightless
    family name; te2 pads with id 0. Module i of a weightless (te1, te2,
    unet, vae) is initialised from seed i. ``with_unet=False`` leaves the
    UNet unloaded (None): the text-encoder trainer needs only the towers.
    ``quantize_base``: the UNet's large Linears int8."""
    device = _check_target(name_or_path, device)
    scheduler = create_noise_scheduler(scheduler_name)
    tiny_cfgs = (CLIPTextConfig.tiny(hidden_size=16), CLIPTextConfig.tiny(hidden_size=16, projection_dim=32))
    if is_single_file(name_or_path) and quant_cache.is_quantized_artifact(name_or_path):
        tiny = "tiny" in os.path.basename(str(name_or_path)).lower()
        te_cfgs = tiny_cfgs if tiny else (CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2())
        toks = [load_tokenizer("", component="tokenizer"), load_tokenizer("", component="tokenizer_2", pad_token_id=0)]
        tes = [_text_encoder("", comp, c, device, weight_dtype, seed, tok)
               for seed, (c, comp, tok) in enumerate(zip(te_cfgs, ("text_encoder", "text_encoder_2"), toks))]
        unet = (quantized_unet_from_artifact(str(name_or_path), denoiser_config(name_or_path, "xl"), device,
                                             weight_dtype) if with_unet else None)
        out = (toks, tes, unet, scheduler)
        return out + (_vae("", VAEConfig.sdxl(), device, weight_dtype, 3),) if with_vae else out
    if is_single_file(name_or_path):
        from sliders_conceptmod_tpu_torch.io.ldm_convert import load_ldm_checkpoint

        path = str(name_or_path)
        trees = load_ldm_checkpoint(path)
        te_cfgs = (tiny_cfgs if "tiny" in os.path.basename(path).lower()
                   else (CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2()))
        unet_cfg = denoiser_config(path, "xl", names=trees["unet"])
        toks = [load_tokenizer("", component="tokenizer"), load_tokenizer("", component="tokenizer_2", pad_token_id=0)]
        tes = [TextEncoderBundle(module_from_state(lambda c=c: CLIPTextEncoder(c), trees.get(comp, {}), device,
                                                   weight_dtype, f"{path} {comp}"), tok)
               for c, comp, tok in zip(te_cfgs, ("text_encoder", "text_encoder_2"), toks)]
        unet = module_from_state(lambda: UNet2DConditionModel(unet_cfg), trees["unet"], device, weight_dtype,
                                 f"{path} unet", quantize_base) if with_unet else None
        out = (toks, tes, unet, scheduler)
        if with_vae:
            return out + (_single_file_vae(path, trees, VAEConfig.sdxl(), device, weight_dtype),)
        return out

    family = _family(name_or_path)
    if family == "tiny":
        raise ValueError("load_models_xl: use a 'tiny-xl' name for the weightless XL smoke family")
    if family not in _XL_FAMILIES and not is_diffusers_dir(name_or_path):
        raise ValueError(f"load_models_xl: {name_or_path!r} is not an SDXL family name")
    te1_cfg, te2_cfg = tiny_cfgs if family == "tiny-xl" else (CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2())
    tok1 = _tokenizer(name_or_path, "tokenizer")
    tok2 = _tokenizer(name_or_path, "tokenizer_2", pad_token_id=0)
    te1 = _text_encoder(name_or_path, "text_encoder", te1_cfg, device, weight_dtype, 0, tok1)
    te2 = _text_encoder(name_or_path, "text_encoder_2", te2_cfg, device, weight_dtype, 1, tok2)
    unet = (_unet(name_or_path, "tiny-xl" if family == "tiny-xl" else "sdxl", device, weight_dtype, 2, quantize_base)
            if with_unet else None)
    out = ([tok1, tok2], [te1, te2], unet, scheduler)
    if with_vae:
        # both weightless families decode with the full SDXL VAE, as the JAX factory's do
        return out + (_vae(name_or_path, VAEConfig.sdxl(), device, weight_dtype, 3),)
    return out


def load_models_sd3(
    name_or_path: str,
    weight_dtype: torch.dtype = torch.float32,
    device: str = "cuda",
    quantize_base: bool = False,
    with_vae: bool = False,
    with_transformer: bool = True,
):
    """SD3 (the JAX ``load_models_sd3``; T5 dropped, as the reference loads
    the pipeline): ``([tok1, tok2], [te1, te2], transformer, scheduler[,
    vae])`` with the flow-match scheduler (shift 3). te1 is CLIP-L with a
    768-dim projection, te2 bigG with its 1280-dim projection, padding with
    id 0. Sources:

    * a diffusers directory (one holding ``transformer/``): each module from
      its ``config.json`` and weights (``io/torch_convert.py``), a tower or
      VAE the directory lacks weightless;
    * an int8 artifact (``io/quant_cache.py``, ``cli/quantize_checkpoint.py
      --family sd3``): the transformer from it, at the depth its blocks
      hold, the towers and VAE weightless;
    * an SGM single file (``sd3_medium_incl_clips*.safetensors``): the MMDiT
      (at the depth its ``joint_blocks`` hold) and both CLIP towers
      (``io/ldm_convert.py``); a file without the towers raises, as the JAX
      loader does;
    * any other name: the weightless family, SD3-Medium's widths (a name
      containing "tiny": the tiny family), module i of (te1, te2,
      transformer, vae) initialised from seed i.

    A single file's or artifact's name containing "tiny" selects the tiny
    widths. ``quantize_base``: the transformer's large Linears int8.
    ``with_transformer=False`` loads the towers only (the notrigger
    trainer)."""
    from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from sliders_conceptmod_tpu_torch.models.mmdit import SD3Transformer2DModel

    p = str(name_or_path)
    device = _check_target(p, device, marker="transformer")
    scheduler = FlowMatchScheduler(shift=3.0)
    tiny = "tiny" in (os.path.basename(p) if is_single_file(p) else p).lower()
    te_cfgs = ((CLIPTextConfig.tiny(hidden_size=16, projection_dim=16),) * 2 if tiny
               else (CLIPTextConfig(projection_dim=768), CLIPTextConfig.sdxl_te2()))
    comps = ("text_encoder", "text_encoder_2")
    if is_single_file(p) and quant_cache.is_quantized_artifact(p):
        toks = [load_tokenizer("", component="tokenizer"), load_tokenizer("", component="tokenizer_2", pad_token_id=0)]
        tes = [_text_encoder("", comp, c, device, weight_dtype, seed, tok)
               for seed, (c, comp, tok) in enumerate(zip(te_cfgs, comps, toks))]
        transformer = None
        if with_transformer:
            mm_cfg = denoiser_config(p, "sd3")
            transformer = quantized_from_artifact(p, lambda: SD3Transformer2DModel(mm_cfg), device, weight_dtype)
        vae = sd3_vae("", device, weight_dtype) if with_vae else None
    elif is_single_file(p):
        from sliders_conceptmod_tpu_torch.io.ldm_convert import load_ldm_checkpoint

        trees = load_ldm_checkpoint(p)
        if "transformer" not in trees:
            raise ValueError(f"{p} is not an SD3 single file (no joint_blocks under model.diffusion_model)")
        if not trees.get("text_encoder") or not trees.get("text_encoder_2"):
            raise ValueError(
                f"{p} carries no bundled text encoders "
                "(text_encoders.clip_l/clip_g towers). Use an *_incl_clips "
                "single file or a diffusers checkpoint directory."
            )
        toks = [load_tokenizer("", component="tokenizer"), load_tokenizer("", component="tokenizer_2", pad_token_id=0)]
        tes = [TextEncoderBundle(module_from_state(lambda c=c: CLIPTextEncoder(c), trees[comp], device, weight_dtype,
                                                   f"{p} {comp}"), tok)
               for c, comp, tok in zip(te_cfgs, comps, toks)]
        mm_cfg = denoiser_config(p, "sd3", names=trees["transformer"])
        transformer = (module_from_state(lambda: SD3Transformer2DModel(mm_cfg), trees["transformer"], device,
                                         weight_dtype, f"{p} transformer", quantize_base) if with_transformer else None)
        vae = _single_file_vae(p, trees, VAEConfig.sd3(), device, weight_dtype) if with_vae else None
    else:
        toks = [_tokenizer(p, "tokenizer"), _tokenizer(p, "tokenizer_2", pad_token_id=0)]
        tes = [_text_encoder(p, comp, c, device, weight_dtype, seed, tok)
               for seed, (c, comp, tok) in enumerate(zip(te_cfgs, comps, toks))]
        transformer = None
        if with_transformer and is_sd3_dir(p):
            sd, cfg = tc.load_transformer_state(p)
            transformer = module_from_state(lambda: SD3Transformer2DModel(cfg), sd, device, weight_dtype,
                                            f"{p}/transformer", quantize_base)
        elif with_transformer:
            cfg = denoiser_config(p, "sd3")
            transformer = build_module(lambda: SD3Transformer2DModel(cfg), device, weight_dtype, 2, quantize_base)
        vae = sd3_vae(p, device, weight_dtype) if with_vae else None
    out = (toks, tes, transformer, scheduler)
    return out + (vae,) if with_vae else out


def sd3_vae(name_or_path: str, device, dtype) -> nn.Module:
    """The 16-channel VAE: a directory's ``vae/``, else the weightless one
    (seed 3)."""
    return _vae(name_or_path, VAEConfig.sd3(), device, dtype, 3)


@torch.inference_mode()
def encode_prompts_sd3(text_encoders: List[TextEncoderBundle], prompts: List[str], joint_attention_dim: int = 4096,
                       t5_seq_len: int = 256):
    """SD3's prompt encoding with T5 dropped (diffusers zero-fills its
    slot): both towers' penultimate states side by side, zero-padded to
    ``joint_attention_dim``, then a zero T5 segment of ``t5_seq_len`` tokens
    along the sequence; pooled = both towers' projected pools side by side.
    ``(text [B, 77 + t5_seq_len, joint_dim], pooled [B, P1 + P2])``."""
    embeds, pooled = [], []
    for te in text_encoders:
        out = te.encode(prompts)
        embeds.append(penultimate_hidden_state(out))
        pooled.append(out.projected if out.projected is not None else out.pooled_output)
    clip = torch.cat(embeds, dim=-1)
    B, _, D = clip.shape
    if D < joint_attention_dim:
        clip = torch.nn.functional.pad(clip, (0, joint_attention_dim - D))
    t5_zeros = clip.new_zeros((B, t5_seq_len, joint_attention_dim))
    return torch.cat([clip, t5_zeros], dim=1), torch.cat(pooled, dim=-1)


def sd3_t5_seq_len(name_or_path: str) -> int:
    """The zero T5 segment's length: 4 for the tiny family, else 256."""
    return 4 if "tiny" in str(name_or_path).lower() else 256


@torch.inference_mode()
def encode_prompts(te: TextEncoderBundle, prompts: List[str], clip_skip: Optional[int] = None) -> torch.Tensor:
    """SD1/SD2: the final LayerNorm output, or the ``clip_skip`` hidden state
    (``[B, 77, D]``)."""
    return clip_skip_hidden_state(te.encode(prompts), clip_skip)


@torch.inference_mode()
def encode_prompts_xl(text_encoders: List[TextEncoderBundle], prompts: List[str]):
    """Concatenated penultimate hidden states of both towers, and te2's
    projected pool: ``(text [B, 77, D1+D2], pooled [B, P])``."""
    o1 = text_encoders[0].encode(prompts)
    o2 = text_encoders[1].encode(prompts)
    text = torch.cat([penultimate_hidden_state(o1), penultimate_hidden_state(o2)], dim=-1)
    pooled = o2.projected if o2.projected is not None else o2.pooled_output
    return text, pooled


@dataclass
class TrainingModels:
    """What a trainer needs of one model family. ``encode(prompt)`` returns
    ``(text [77, D], pooled [P] or None)`` and holds the text towers: set it
    to None to free them."""

    is_xl: bool
    unet: nn.Module
    scheduler: object
    vae: Optional[nn.Module]
    encode: Optional[Callable[[str], Tuple[torch.Tensor, Optional[torch.Tensor]]]]

    def add_time_ids(self, resolution: int, device) -> Optional[torch.Tensor]:
        """SDXL's micro-conditioning ids at a square resolution; None for SD1/SD2."""
        if not self.is_xl:
            return None
        return torch.from_numpy(get_add_time_ids(resolution, resolution)).to(device)


def load_for_training(model_cfg, scheduler_name: str, weight_dtype: torch.dtype, with_vae: bool = False,
                      device: str = "cuda", quantize_base: bool = False) -> TrainingModels:
    """The trainers' one loader: the family from ``model_cfg`` (its
    ``name_or_path`` and ``v2``), then ``load_models_xl`` (both towers'
    penultimate states and te2's pool) or ``load_models`` (``v_pred``; the
    ``clip_skip`` state, no pool); ``quantize_base``: an int8 UNet."""
    name = model_cfg.name_or_path
    if _family(name, model_cfg.v2) in _XL_FAMILIES:
        _, tes, unet, scheduler, *vae = load_models_xl(name, scheduler_name, weight_dtype, with_vae, device,
                                                       quantize_base=quantize_base)

        def encode(prompt: str):
            text, pooled = encode_prompts_xl(tes, [prompt])
            return text[0], pooled[0]

        is_xl = True
    else:
        _, te, unet, scheduler, *vae = load_models(name, scheduler_name, model_cfg.v2, model_cfg.v_pred,
                                                   weight_dtype, with_vae, device, quantize_base)

        def encode(prompt: str):
            return encode_prompts(te, [prompt], model_cfg.clip_skip)[0], None

        is_xl = False
    return TrainingModels(is_xl, unet, scheduler, vae[0] if vae else None, encode)


# ---------------------------------------------------------------------------
# Flux
# ---------------------------------------------------------------------------


def is_flux_dir(name_or_path: str) -> bool:
    return os.path.isdir(os.path.join(str(name_or_path), "transformer"))


class FluxEncoder:
    """Flux's one-prompt encoder (the JAX loader's ``encode_fn``):
    ``encoder(prompt) -> (text [seq_len, joint_dim], pooled [pooled_dim])``
    in the weights' dtype on the device.

    With text towers (a diffusers directory): T5's final hidden state of the
    prompt's ``seq_len`` tokens and CLIP-L's pooled output; ``text_encoders``
    is ``[CLIP-L, T5]`` (te1, te2: a slider's text-encoder parts bind to
    them, ``adapters/slider_file.py`` with ``te2_is_t5``), and an encode runs
    under both towers' locks. Without (a weightless name, a BFL single file,
    an int8 artifact): JAX's stand-in, pseudo-embeddings N(0, 0.1²) drawn
    from the prompt's T5 ids — a generator seeded with ``sum(ids) % 2**31``
    (JAX's integer seed, torch's numbers: the two packages' stand-ins
    differ), the text first, then the pooled vector, in fp32 on the CPU,
    then cast and moved."""

    def __init__(self, tokenizer, seq_len: int, joint_dim: int, pooled_dim: int, dtype: torch.dtype, device,
                 t5: Optional[nn.Module] = None, clip: Optional[TextEncoderBundle] = None):
        self.tokenizer, self.seq_len = tokenizer, seq_len
        self.joint_dim, self.pooled_dim = joint_dim, pooled_dim
        self.dtype, self.device = dtype, torch.device(device)
        self.t5, self.clip = t5, clip

    @property
    def text_encoders(self) -> Optional[List[nn.Module]]:
        return None if self.t5 is None else [self.clip.model, self.t5]

    @torch.inference_mode()
    def __call__(self, prompt: str):
        ids = self.tokenizer([prompt])
        if self.t5 is None:
            gen = torch.Generator().manual_seed(int(np.asarray(ids[0], np.int64).sum()) % (2**31))
            text = torch.randn((self.seq_len, self.joint_dim), generator=gen) * 0.1
            pooled = torch.randn((self.pooled_dim,), generator=gen) * 0.1
            return text.to(self.dtype).to(self.device), pooled.to(self.dtype).to(self.device)
        t5_ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        with model_lock(self.t5):
            text = self.t5(t5_ids)[0]
        return text, self.clip.encode([prompt]).pooled_output[0]


def _block_count(sd, prefix: str) -> int:
    """1 + the largest ``{prefix}{i}.`` index among ``sd``'s names (0 when none)."""
    idx = [int(k[len(prefix):].split(".", 1)[0]) for k in sd if k.startswith(prefix)]
    return max(idx) + 1 if idx else 0


def load_models_flux(
    name_or_path: str,
    weight_dtype: torch.dtype = torch.float32,
    device: str = "cuda",
    quantize_base: bool = False,
    with_transformer: bool = True,
):
    """Flux (the JAX ``load_models_flux``): ``([t5 tokenizer], encoder,
    transformer, scheduler)`` with the flow-match scheduler under dynamic
    shifting (μ from the image's token count). Sources:

    * a diffusers directory (one holding ``transformer/``): the transformer
      from its ``config.json`` (dev when it declares ``guidance_embeds``) and
      weights; ``text_encoder_2/`` T5 (its ``config.json`` sets the depth and
      widths), ``text_encoder/`` CLIP-L (weightless from seed 0 when
      absent), T5's tokenizer from ``tokenizer_2/spiece.model`` (else the
      hash stand-in), CLIP's from ``tokenizer/``;
    * an int8 artifact (``io/quant_cache.py``, ``cli/quantize_checkpoint.py
      --family flux``): the transformer from it, at the depth its blocks
      hold (the family's widths), the stand-in encoder;
    * a BFL single file (``flux1-schnell.safetensors``): the transformer
      (``io/ldm_convert.py``) at the depth the file's ``double_blocks`` /
      ``single_blocks`` hold (19 + 38 in BFL's files, the family's widths),
      the stand-in encoder;
    * any other name: the weightless family (``FluxConfig.schnell()``, a name
      containing "tiny": the tiny family), the transformer from seed 0, the
      stand-in encoder.

    A file or tree carrying ``guidance_embedder`` weights is dev; a name
    containing "tiny" (the whole path, as JAX reads it) selects the tiny
    widths and an 8-token T5 context (else 512). ``quantize_base``: the
    transformer's large Linears int8 (an artifact always is).
    ``with_transformer=False`` loads the encoder alone (the notrigger
    trainer)."""
    from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler
    from sliders_conceptmod_tpu_torch.models.flux import FluxConfig, FluxTransformer2DModel
    from sliders_conceptmod_tpu_torch.models.t5 import T5EncoderModel
    from sliders_conceptmod_tpu_torch.models.tokenizer import load_t5_tokenizer

    p = str(name_or_path)
    device = _check_target(p, device, marker="transformer")
    tiny = "tiny" in p.lower()
    base_cfg = FluxConfig.tiny() if tiny else FluxConfig.schnell()
    seq_len = 8 if tiny else 512  # the reference's max_sequence_length
    scheduler = FlowMatchScheduler(use_dynamic_shifting=True)
    local = is_flux_dir(p)
    tok = load_t5_tokenizer(p if local else "", max_length=seq_len)

    transformer = None
    if is_single_file(p) and quant_cache.is_quantized_artifact(p):
        if with_transformer:
            cfg = denoiser_config(p, "flux")
            transformer = quantized_from_artifact(p, lambda: FluxTransformer2DModel(cfg), device, weight_dtype)
    elif is_single_file(p):
        from sliders_conceptmod_tpu_torch.io.ldm_convert import load_ldm_checkpoint

        if with_transformer:
            sd = load_ldm_checkpoint(p)
            if "transformer" not in sd or "x_embedder.weight" not in sd["transformer"]:
                raise ValueError(f"{p} is not a BFL Flux single file (no double_blocks / single_blocks)")
            cfg = denoiser_config(p, "flux", names=sd["transformer"])
            transformer = module_from_state(lambda: FluxTransformer2DModel(cfg), sd["transformer"], device,
                                            weight_dtype, f"{p} transformer", quantize_base)
    elif local:
        if with_transformer:
            sd, cfg = tc.load_flux_transformer_state(p)
            transformer = module_from_state(lambda: FluxTransformer2DModel(cfg), sd, device, weight_dtype,
                                            f"{p}/transformer", quantize_base)
    elif with_transformer:
        transformer = build_module(lambda: FluxTransformer2DModel(denoiser_config(p, "flux")), device, weight_dtype, 0,
                                   quantize_base)
    cfg = transformer.config if transformer is not None else base_cfg
    t5 = clip = None
    if local:
        t5_sd, t5_cfg = tc.load_t5_state(p)
        t5 = module_from_state(lambda: T5EncoderModel(t5_cfg), t5_sd, device, weight_dtype, f"{p}/text_encoder_2")
        clip = _text_encoder(p, "text_encoder", CLIPTextConfig.sd15_te(), device, weight_dtype, 0,
                             _tokenizer(p, "tokenizer"))
    encoder = FluxEncoder(tok, seq_len, cfg.joint_attention_dim, cfg.pooled_projection_dim, weight_dtype, device,
                          t5=t5, clip=clip)
    return [tok], encoder, transformer, scheduler


def flux_vae_scale(name_or_path: str) -> int:
    """Pixels per latent: 8, or 2 for the tiny family (the JAX Flux
    entry points' ``vae_scale``)."""
    return 2 if "tiny" in str(name_or_path).lower() else 8


def _denoiser_names(path: str, artifact: bool) -> list:
    """A single file's denoiser tensor names in the port's names (its
    tensors on the meta device through ``load_ldm_checkpoint``'s
    conversion), or an int8 artifact's ("/" read as "."); from the header
    alone."""
    if artifact:
        from sliders_conceptmod_tpu_torch.io.safetensors import read_keys

        return [k.replace("/", ".") for k in read_keys(path)]
    from sliders_conceptmod_tpu_torch.io.ldm_convert import load_ldm_checkpoint

    trees = load_ldm_checkpoint(path, meta=True)
    return list(trees.get("transformer", trees.get("unet", {})))


def denoiser_config(name_or_path: str, family: str, v2: bool = False, names=None):
    """The architecture of the denoiser that ``family``'s loader builds for
    ``name_or_path``: a UNetConfig for ``sd1`` (SD2.1's with ``v2``) and
    ``xl``, an MMDiTConfig for ``sd3``, a FluxConfig for ``flux``. A
    directory's ``config.json``; a single file's or int8 artifact's family
    widths (a basename holding "tiny": the tiny family's; Flux reads the
    whole path, as JAX does) at what its tensor ``names`` hold (a tiny UNet
    file's layers_per_block, the MMDiT's blocks, Flux's double and single
    blocks and guidance embedder); else the family's name. ``names``: the
    port's names of a loaded file's denoiser tree, or an artifact's; read
    from the header when None. The loaders and ``denoiser_on_meta`` share
    this rule."""
    from sliders_conceptmod_tpu_torch.models.flux import FluxConfig
    from sliders_conceptmod_tpu_torch.models.mmdit import MMDiTConfig

    p = str(name_or_path)
    single = is_single_file(p)
    artifact = single and quant_cache.is_quantized_artifact(p)
    if single and names is None:
        names = _denoiser_names(p, artifact)
    tiny = "tiny" in (os.path.basename(p) if single else p).lower()
    blocks = "transformer_blocks" + ("_" if artifact else ".")
    if family == "flux":
        if is_flux_dir(p):
            return tc.flux_config_from_json(tc.read_json(os.path.join(p, "transformer", "config.json")))
        cfg = FluxConfig.tiny() if "tiny" in p.lower() else FluxConfig.schnell()
        if not single:
            return cfg
        return dataclasses.replace(cfg, num_layers=_block_count(names, blocks),
                                   num_single_layers=_block_count(names, "single_" + blocks),
                                   guidance_embeds=any(".guidance_embedder." in k for k in names))
    if family == "sd3":
        if is_sd3_dir(p):
            return tc.mmdit_config_from_json(tc.read_json(os.path.join(p, "transformer", "config.json")))
        cfg = MMDiTConfig.tiny() if tiny else MMDiTConfig.sd3_medium()
        return dataclasses.replace(cfg, num_layers=_block_count(names, blocks)) if single else cfg
    if is_diffusers_dir(p):
        return tc.unet_config_from_json(tc.read_json(os.path.join(p, "unet", "config.json")))
    if not single:
        return unet_config_for(p, v2)
    if family == "xl":
        cfg = UNetConfig.tiny_xl() if tiny else UNetConfig.sdxl()
    else:
        cfg = UNetConfig.tiny() if tiny else (UNetConfig.sd21() if v2 else UNetConfig.sd15())
    return dataclasses.replace(cfg, layers_per_block=_tiny_lpb(names)) if tiny and not artifact else cfg


def denoiser_on_meta(name_or_path: str, family: str) -> nn.Module:
    """The denoiser the ``family``'s loader builds for ``name_or_path`` (the
    UNet of ``xl`` and ``sd1``, the transformer of ``sd3`` and ``flux``) on
    the meta device: its module tree at ``denoiser_config``'s architecture,
    no weights; no tensor is read."""
    from sliders_conceptmod_tpu_torch.models.flux import FluxTransformer2DModel
    from sliders_conceptmod_tpu_torch.models.mmdit import SD3Transformer2DModel

    cls = {"flux": FluxTransformer2DModel, "sd3": SD3Transformer2DModel}.get(family, UNet2DConditionModel)
    cfg = denoiser_config(name_or_path, family)
    with torch.device("meta"):
        return cls(cfg)


def is_cascade_dir(name_or_path: str) -> bool:
    return os.path.isdir(os.path.join(str(name_or_path), "prior"))


def load_models_cascade(
    name_or_path: str,
    scheduler_name: str = "euler_a",
    weight_dtype: torch.dtype = torch.float32,
    device: str = "cuda",
):
    """Stable Cascade (the JAX ``load_models_cascade``): ``(tokenizer,
    text encoder, prior, scheduler)`` — CLIP-G (bigG, its 1280-dim
    projection) and the Stage-C prior. Sources:

    * a diffusers directory (one holding ``prior/``): the prior from it
      (``io/torch_convert.py::load_cascade_prior_state``, always
      ``CascadeConfig.prior()``), ``text_encoder/`` and ``tokenizer/`` when
      it has them;
    * a ``.safetensors`` / ``.ckpt`` file raises ``NotImplementedError``
      (JAX has no single-file loader for Stable Cascade; it builds the
      weightless prior for one);
    * any other name: the weightless family at the prior's widths (a name
      containing "tiny": ``CascadeConfig.tiny()`` with the tiny CLIP tower,
      hidden and projection 16), the tower from seed 0 and the prior from
      seed 1.

    ``scheduler_name="wuerstchen"`` gives the ratio-space
    :class:`~sliders_conceptmod_tpu_torch.diffusion.wuerstchen.WuerstchenScheduler`;
    any other name goes through ``create_noise_scheduler``."""
    from sliders_conceptmod_tpu_torch.diffusion.wuerstchen import WuerstchenScheduler

    p = str(name_or_path)
    if is_single_file(p):
        from sliders_conceptmod_tpu_torch.io.ldm_convert import CASCADE_SINGLE_FILE_REFUSAL

        raise NotImplementedError(CASCADE_SINGLE_FILE_REFUSAL)
    device = _check_target(p, device, marker="prior")
    tiny = "tiny" in p.lower()
    te_cfg = CLIPTextConfig.tiny(hidden_size=16, projection_dim=16) if tiny else CLIPTextConfig.sdxl_te2()
    tok = _tokenizer(p, "tokenizer")
    te = _text_encoder(p, "text_encoder", te_cfg, device, weight_dtype, 0, tok)
    if is_cascade_dir(p):
        sd, cfg = tc.load_cascade_prior_state(p)
        prior = module_from_state(lambda: StableCascadeUNet(cfg), sd, device, weight_dtype, f"{p}/prior")
    else:
        cfg = CascadeConfig.tiny() if tiny else CascadeConfig.prior()
        prior = build_module(lambda: StableCascadeUNet(cfg), device, weight_dtype, 1)
    scheduler = WuerstchenScheduler() if scheduler_name == "wuerstchen" else create_noise_scheduler(scheduler_name)
    return tok, te, prior, scheduler


@torch.inference_mode()
def encode_prompts_cascade(te: TextEncoderBundle, prompts: List[str]):
    """Stable Cascade's prompt encoding (the reference's
    ``encode_prompt_cascade``): ``(hidden_states[-1] [B, 77, D]`` — the last
    layer's output before the final LayerNorm —, the projected pooled
    embedding ``[B, 1, P])``."""
    out = te.encode(prompts)
    pooled = out.projected if out.projected is not None else out.pooled_output
    return out.hidden_states[-1], pooled[:, None, :]
