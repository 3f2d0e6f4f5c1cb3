"""The port's state dicts → a single-file LDM/SGM checkpoint: the exact
inverse of ``io/ldm_convert.py``.

Counterpart of the SD1/SD2/SDXL half of ``sliders_conceptmod_tpu/io/ldm_export.py``.
It writes what the single-file ecosystem (A1111 and the like) loads, and makes
the LDM key mapping testable as a loss-free round trip. Each exporter takes a
module's ``state_dict()`` under the port's (diffusers') names and returns
``{LDM key: tensor}``:

* UNet → ``model.diffusion_model.``: the (block, layer) of ``down_blocks`` /
  ``up_blocks`` flatten to the ``input_blocks`` / ``output_blocks`` slots
  (``layers_per_block == 2``, the layout SD1/SD2/SDXL share); the
  upsampler sits after the attention in an output slot that has one;
* VAE → ``first_stage_model.``: the decoder's ``up_blocks`` indices reversed
  back to LDM's ``up.{i}``, the mid-block attention's Linears re-expanded to
  1×1 convs (``q/k/v/proj_out``);
* SD1's CLIP tower → ``cond_stage_model.transformer.`` and SDXL's te1 →
  ``conditioner.embedders.0.transformer.`` (transformers layout);
* OpenCLIP towers — SD2's (``cond_stage_model.model.``) and SDXL's bigG
  (``conditioner.embedders.1.model.``, with ``text_projection`` as
  ``x @ W``) — re-fuse q/k/v into ``attn.in_proj_*``.

* SD3's MMDiT → ``model.diffusion_model.`` in the SGM MM-DiT layout
  (:func:`export_sd3_mmdit`): q/k/v re-fused into ``attn.qkv``, the 2·dim
  AdaLN heads swapped back to (shift, scale); its towers →
  ``text_encoders.clip_l/clip_g.transformer.`` (:func:`export_sd3_checkpoint`).

* Flux's transformer → the BFL single-file layout (:func:`export_flux_bfl`,
  the JAX ``export_flux_bfl``): q/k/v re-fused into ``img_attn.qkv`` /
  ``txt_attn.qkv``, a single block's q/k/v and ``proj_mlp`` into
  ``linear1``, the final AdaLN swapped back to (shift, scale). The text
  towers are not part of a BFL file.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from sliders_conceptmod_tpu_torch.io.ldm_convert import swap_scale_shift

StateDict = Dict[str, torch.Tensor]

_RESNET_INV = {
    "norm1": "in_layers.0",
    "conv1": "in_layers.2",
    "time_emb_proj": "emb_layers.1",
    "norm2": "out_layers.0",
    "conv2": "out_layers.3",
    "conv_shortcut": "skip_connection",
}
_VAE_RESNET_INV = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
                   "conv_shortcut": "nin_shortcut"}
_VAE_ATTN_INV = {"to_q": "q", "to_k": "k", "to_v": "v", "group_norm": "norm"}


def _unet_key_to_ldm(key: str, attn_up_blocks) -> str:
    """diffusers UNet key → LDM ``diffusion_model`` key (inverse of
    ``ldm_convert.rename_unet_key``)."""
    parts = key.split(".")
    head = parts[0]
    if head in ("time_embedding", "add_embedding"):
        idx = {"linear_1": "0", "linear_2": "2"}[parts[1]]
        lead = ["time_embed"] if head == "time_embedding" else ["label_emb", "0"]
        return ".".join(lead + [idx] + parts[2:])
    if head == "conv_norm_out":
        return ".".join(["out", "0"] + parts[1:])
    if head == "conv_out":
        return ".".join(["out", "2"] + parts[1:])
    if head == "conv_in":
        return ".".join(["input_blocks", "0", "0"] + parts[1:])

    def resnet_inv(rest):
        return _RESNET_INV[rest[0]].split(".") + rest[1:]

    if head == "down_blocks":
        block, kind, layer = int(parts[1]), parts[2], int(parts[3])
        if kind == "resnets":
            return ".".join(["input_blocks", str(1 + 3 * block + layer), "0"] + resnet_inv(parts[4:]))
        if kind == "attentions":
            return ".".join(["input_blocks", str(1 + 3 * block + layer), "1"] + parts[4:])
        if kind == "downsamplers":
            return ".".join(["input_blocks", str(3 * block + 3), "0", "op"] + parts[5:])
    if head == "mid_block":
        kind, layer = parts[1], parts[2]
        if kind == "attentions":
            return ".".join(["middle_block", "1"] + parts[3:])
        return ".".join(["middle_block", "0" if layer == "0" else "2"] + resnet_inv(parts[3:]))
    if head == "up_blocks":
        block, kind, layer = int(parts[1]), parts[2], int(parts[3])
        if kind == "resnets":
            return ".".join(["output_blocks", str(3 * block + layer), "0"] + resnet_inv(parts[4:]))
        if kind == "attentions":
            return ".".join(["output_blocks", str(3 * block + layer), "1"] + parts[4:])
        if kind == "upsamplers":
            sub = "2" if block in attn_up_blocks else "1"
            return ".".join(["output_blocks", str(3 * block + 2), sub, "conv"] + parts[5:])
    raise ValueError(f"Cannot export UNet key: {key}")


def export_unet(unet_sd: Mapping[str, torch.Tensor]) -> StateDict:
    attn_up_blocks = {int(k.split(".")[1]) for k in unet_sd if k.startswith("up_blocks.") and ".attentions." in k}
    return {"model.diffusion_model." + _unet_key_to_ldm(k, attn_up_blocks): v for k, v in unet_sd.items()}


def export_clip_text(te_sd: Mapping[str, torch.Tensor], prefix: str = "cond_stage_model.transformer.") -> StateDict:
    """A CLIP tower → the transformers layout under ``prefix`` (inverse of
    ``io/torch_convert.py::clip_state_dict``)."""
    out: StateDict = {}
    for key, value in te_sd.items():
        key = key.replace("mlp_fc1", "mlp.fc1").replace("mlp_fc2", "mlp.fc2")
        if key.startswith("layers."):
            out[prefix + "text_model.encoder." + key] = value
        elif key.startswith("final_layer_norm."):
            out[prefix + "text_model." + key] = value
        elif key == "text_projection.weight":
            out[prefix + key] = value
        elif key in ("token_embedding.weight", "position_embedding.weight"):
            out[prefix + "text_model.embeddings." + key] = value
        else:
            raise ValueError(f"Cannot export CLIP key: {key}")
    return out


def export_openclip_text(te_sd: Mapping[str, torch.Tensor], prefix: str = "cond_stage_model.model.") -> StateDict:
    """A CLIP tower → the OpenCLIP layout under ``prefix`` (inverse of
    ``ldm_convert.openclip_to_transformers``): q/k/v re-fused into
    ``attn.in_proj_*``, ``text_projection`` stored as ``x @ W``."""
    p = prefix
    out: StateDict = {
        p + "token_embedding.weight": te_sd["token_embedding.weight"],
        p + "positional_embedding": te_sd["position_embedding.weight"],
        p + "ln_final.weight": te_sd["final_layer_norm.weight"],
        p + "ln_final.bias": te_sd["final_layer_norm.bias"],
    }
    if "text_projection.weight" in te_sd:
        out[p + "text_projection"] = te_sd["text_projection.weight"].t().contiguous()
    layers = sorted({int(k.split(".")[1]) for k in te_sd if k.startswith("layers.")})
    for i in layers:
        src, d = f"layers.{i}.", p + f"transformer.resblocks.{i}."
        for leaf in ("weight", "bias"):
            out[d + f"attn.in_proj_{leaf}"] = torch.cat(
                [te_sd[f"{src}self_attn.{n}.{leaf}"] for n in ("q_proj", "k_proj", "v_proj")], dim=0)
            for name, oc_name in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                                  ("layer_norm2", "ln_2"), ("mlp_fc1", "mlp.c_fc"), ("mlp_fc2", "mlp.c_proj")):
                out[d + f"{oc_name}.{leaf}"] = te_sd[f"{src}{name}.{leaf}"]
    return out


def export_vae(vae_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The KL VAE → ``first_stage_model.`` (inverse of
    ``ldm_convert.rename_vae_key``)."""
    n_up = 1 + max((int(k.split(".")[2]) for k in vae_sd if k.startswith("decoder.up_blocks.")), default=0)
    out: StateDict = {}
    for key, value in vae_sd.items():
        parts = key.split(".")
        if parts[0] in ("quant_conv", "post_quant_conv"):
            out["first_stage_model." + key] = value
            continue
        side, body = parts[0], parts[1:]
        if body[0] in ("conv_in", "conv_out"):
            mapped = body
        elif body[0] == "conv_norm_out":
            mapped = ["norm_out"] + body[1:]
        elif body[0] == "mid_block" and body[1] == "resnets":
            mapped = ["mid", "block_1" if body[2] == "0" else "block_2", _VAE_RESNET_INV[body[3]]] + body[4:]
        elif body[0] == "mid_block":  # attentions.0
            if body[3] == "to_out":
                name, rest = "proj_out", body[5:]
            else:
                name, rest = _VAE_ATTN_INV[body[3]], body[4:]
            if value.dim() == 2:  # a Linear back to a 1×1 conv
                value = value[:, :, None, None]
            mapped = ["mid", "attn_1", name] + rest
        elif body[0] == "down_blocks":
            if body[2] == "resnets":
                mapped = ["down", body[1], "block", body[3], _VAE_RESNET_INV[body[4]]] + body[5:]
            else:  # downsamplers.0.conv
                mapped = ["down", body[1], "downsample", "conv"] + body[5:]
        elif body[0] == "up_blocks":
            i = str(n_up - 1 - int(body[1]))  # ldm_convert reverses the decoder's up indices
            if body[2] == "resnets":
                mapped = ["up", i, "block", body[3], _VAE_RESNET_INV[body[4]]] + body[5:]
            else:  # upsamplers.0.conv
                mapped = ["up", i, "upsample", "conv"] + body[5:]
        else:
            raise ValueError(f"Cannot export VAE key: {key}")
        out["first_stage_model." + side + "." + ".".join(mapped)] = value
    return out


def export_ldm_checkpoint(unet_sd: Mapping[str, torch.Tensor], text_encoder_sd: Optional[Mapping] = None,
                          vae_sd: Optional[Mapping] = None, v2: bool = True) -> StateDict:
    """SD1 (``v2=False``: the transformers CLIP tower) or SD2 (the OpenCLIP
    tower) single-file layout; the JAX exporter's default is ``v2=True``."""
    sd = export_unet(unet_sd)
    if text_encoder_sd is not None:
        sd.update(export_openclip_text(text_encoder_sd) if v2 else export_clip_text(text_encoder_sd))
    if vae_sd is not None:
        sd.update(export_vae(vae_sd))
    return sd


def export_sdxl_checkpoint(unet_sd: Mapping[str, torch.Tensor], te1_sd: Optional[Mapping] = None,
                           te2_sd: Optional[Mapping] = None, vae_sd: Optional[Mapping] = None) -> StateDict:
    """SDXL's SGM layout: te1 in the transformers layout, te2 (bigG) in
    OpenCLIP's, both under ``conditioner.embedders``."""
    sd = export_unet(unet_sd)
    if te1_sd is not None:
        sd.update(export_clip_text(te1_sd, prefix="conditioner.embedders.0.transformer."))
    if te2_sd is not None:
        sd.update(export_openclip_text(te2_sd, prefix="conditioner.embedders.1.model."))
    if vae_sd is not None:
        sd.update(export_vae(vae_sd))
    return sd


def export_sd3_mmdit(mmdit_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The MMDiT → SD3's SGM layout (inverse of
    ``ldm_convert.convert_sd3_mmdit_state_dict``; the JAX
    ``export_sd3_mmdit``)."""
    p = "model.diffusion_model."
    out: StateDict = {}
    qkv: Dict[str, Dict[int, torch.Tensor]] = {}
    for key, value in mmdit_sd.items():
        parts = key.split(".")
        head = parts[0]
        if head == "pos_embed":  # the patchifying conv
            out[p + "x_embedder." + ".".join(parts[1:])] = value
        elif head == "time_text_embed":
            emb = "t_embedder" if parts[1] == "timestep_embedder" else "y_embedder"
            out[p + f"{emb}.mlp." + {"linear_1": "0", "linear_2": "2"}[parts[2]] + "." + parts[3]] = value
        elif head == "context_embedder":
            out[p + key] = value
        elif head == "norm_out":
            out[p + "final_layer.adaLN_modulation.1." + parts[2]] = swap_scale_shift(value)
        elif head == "proj_out":
            out[p + "final_layer.linear." + parts[1]] = value
        elif head == "transformer_blocks":
            rest = parts[2:]
            xb, cb = f"joint_blocks.{parts[1]}.x_block.", f"joint_blocks.{parts[1]}.context_block."
            leaf = rest[-1]
            if rest[0] == "attn" and rest[1] in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
                blk = cb if rest[1].startswith("add_") else xb
                slot = "qkv".index(rest[1].replace("add_", "to_")[3])
                qkv.setdefault(p + blk + "attn.qkv." + leaf, {})[slot] = value
            elif rest[0] == "attn" and rest[1] == "to_out":
                out[p + xb + "attn.proj." + leaf] = value
            elif rest[0] == "attn" and rest[1] == "to_add_out":
                out[p + cb + "attn.proj." + leaf] = value
            elif rest[0] in ("norm1", "norm1_context"):
                ctx = rest[0] == "norm1_context"
                if ctx:  # the last block's 2·dim continuous head swaps, its bias with it
                    w = mmdit_sd[".".join(parts[:-1] + ["weight"])]
                    if w.shape[0] == 2 * w.shape[1]:
                        value = swap_scale_shift(value)
                out[p + (cb if ctx else xb) + "adaLN_modulation.1." + leaf] = value
            elif rest[0] in ("ff", "ff_context"):
                fc = "fc1" if rest[2] == "0" else "fc2"
                out[p + (cb if rest[0] == "ff_context" else xb) + "mlp." + fc + "." + leaf] = value
            else:
                raise ValueError(f"Cannot export SD3 MMDiT key: {key}")
        else:
            raise ValueError(f"Cannot export SD3 MMDiT key: {key}")
    for key, chunks in qkv.items():
        out[key] = torch.cat([chunks[0], chunks[1], chunks[2]], dim=0)
    return out


def export_sd3_checkpoint(mmdit_sd: Mapping[str, torch.Tensor], te1_sd: Optional[Mapping] = None,
                          te2_sd: Optional[Mapping] = None, vae_sd: Optional[Mapping] = None) -> StateDict:
    """SD3's single file: the MMDiT, and the towers in the transformers layout
    under ``text_encoders.clip_l/clip_g.transformer.`` (an ``*_incl_clips``
    file)."""
    sd = export_sd3_mmdit(mmdit_sd)
    if te1_sd is not None:
        sd.update(export_clip_text(te1_sd, prefix="text_encoders.clip_l.transformer."))
    if te2_sd is not None:
        sd.update(export_clip_text(te2_sd, prefix="text_encoders.clip_g.transformer."))
    if vae_sd is not None:
        sd.update(export_vae(vae_sd))
    return sd


def export_flux_bfl(transformer_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The Flux transformer → BFL's single-file layout (inverse of
    ``ldm_convert.convert_flux_bfl_state_dict``)."""
    out: StateDict = {}
    fused: Dict[str, Dict[str, torch.Tensor]] = {}
    embedders = {"timestep_embedder": "time_in", "text_embedder": "vector_in", "guidance_embedder": "guidance_in"}
    for key, value in transformer_sd.items():
        parts = key.split(".")
        head, leaf = parts[0], parts[-1]
        if head == "x_embedder":
            out["img_in." + leaf] = value
        elif head == "context_embedder":
            out["txt_in." + leaf] = value
        elif head == "time_text_embed":
            out[f"{embedders[parts[1]]}.{ {'linear_1': 'in_layer', 'linear_2': 'out_layer'}[parts[2]] }.{leaf}"] = value
        elif head == "norm_out":
            out["final_layer.adaLN_modulation.1." + leaf] = swap_scale_shift(value)
        elif head == "proj_out":
            out["final_layer.linear." + leaf] = value
        elif head == "transformer_blocks":
            base, rest = f"double_blocks.{parts[1]}.", parts[2:]
            if rest[0] in ("norm1", "norm1_context"):
                out[base + ("txt_mod" if rest[0] == "norm1_context" else "img_mod") + ".lin." + leaf] = value
            elif rest[0] in ("ff", "ff_context"):
                stream = "txt_mlp" if rest[0] == "ff_context" else "img_mlp"
                out[base + f"{stream}.{rest[2]}." + leaf] = value
            elif rest[0] == "attn" and rest[1] in ("to_q", "to_k", "to_v"):
                fused.setdefault(base + "img_attn.qkv." + leaf, {})[rest[1][3]] = value
            elif rest[0] == "attn" and rest[1] in ("add_q_proj", "add_k_proj", "add_v_proj"):
                fused.setdefault(base + "txt_attn.qkv." + leaf, {})[rest[1][4]] = value
            elif rest[0] == "attn" and rest[1] in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                stream = "txt_attn" if "added" in rest[1] else "img_attn"
                out[base + f"{stream}.norm." + ("query_norm" if rest[1][-1] == "q" else "key_norm") + ".scale"] = value
            elif rest[0] == "attn" and rest[1] in ("to_out", "to_add_out"):
                out[base + ("txt_attn" if rest[1] == "to_add_out" else "img_attn") + ".proj." + leaf] = value
            else:
                raise ValueError(f"Cannot export Flux key: {key}")
        elif head == "single_transformer_blocks":
            base, rest = f"single_blocks.{parts[1]}.", parts[2:]
            if rest[0] == "norm":
                out[base + "modulation.lin." + leaf] = value
            elif rest[0] == "proj_mlp" or (rest[0] == "attn" and rest[1] in ("to_q", "to_k", "to_v")):
                slot = "m" if rest[0] == "proj_mlp" else rest[1][3]
                fused.setdefault(base + "linear1." + leaf, {})[slot] = value
            elif rest[0] == "attn" and rest[1] in ("norm_q", "norm_k"):
                out[base + "norm." + ("query_norm" if rest[1] == "norm_q" else "key_norm") + ".scale"] = value
            elif rest[0] == "proj_out":
                out[base + "linear2." + leaf] = value
            else:
                raise ValueError(f"Cannot export Flux key: {key}")
        else:
            raise ValueError(f"Cannot export Flux key: {key}")
    for key, chunks in fused.items():
        out[key] = torch.cat([chunks[s] for s in ("q", "k", "v", "m") if s in chunks], dim=0)
    return out


def save_ldm_checkpoint(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    """``.safetensors`` through the port's writer (each tensor copied to the
    host as it is written)."""
    from sliders_conceptmod_tpu_torch.io.safetensors import save_file

    save_file(dict(sd), str(path))
