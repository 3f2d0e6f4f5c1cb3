"""A single-file SD checkpoint (LDM / SGM layout) → the port's state dicts.

Counterpart of ``sliders_conceptmod_tpu/io/ldm_convert.py`` for SD1.x, SD2.x
and SDXL, ``.safetensors`` (the port's reader) or ``.ckpt``
(``torch.load(weights_only=True)``, the weights under ``state_dict`` when
nested). The result is ``{"unet", "vae", "text_encoder"[, "text_encoder_2"]}``
in torch layout under the port's module names (diffusers' names, see
``io/torch_convert.py``):

* UNet (``model.diffusion_model.``): ``input_blocks``/``output_blocks`` flatten
  to (block, layer) by //3 and %3; the downsamplers sit at input slot 2 of a
  block, the upsamplers in the last module of an output slot;
* VAE (``first_stage_model.``): the decoder's ``up.{i}`` indices are reversed
  against diffusers' ``up_blocks``, and the mid-block attention's
  ``q/k/v/proj_out`` 1×1 convs become the port's Linear ``to_q/to_k/to_v/
  to_out.0``;
* SD1's text tower (``cond_stage_model.transformer.``) and SDXL's te1
  (``conditioner.embedders.0.transformer.``) are in the transformers layout;
* the OpenCLIP towers — SD2's (``cond_stage_model.model.``, trimmed to the 23
  layers SD2 uses) and SDXL's bigG (``conditioner.embedders.1.model.``, every
  layer and its ``text_projection``) — split the fused ``in_proj`` into
  q/k/v and rename ``ln_1/ln_2/c_fc/c_proj``.

An SD3 file (``model.diffusion_model.joint_blocks.…``, the SGM MM-DiT
layout of ``sd3_medium*.safetensors``) gives ``{"transformer"[, "vae",
"text_encoder", "text_encoder_2"]}`` (:func:`convert_sd3_mmdit_state_dict`;
the towers under ``text_encoders.clip_l/clip_g.transformer.`` in the
transformers layout; a T5 tower, which SD3 here does without, is skipped).
A BFL Flux file (``double_blocks.…`` / ``single_blocks.…`` at the top level)
gives ``{"transformer"}`` (:func:`convert_flux_bfl_state_dict`). A Stable
Cascade single file raises ``NotImplementedError``: the JAX package has no
single-file loader for it either, and the prior loads from a diffusers
directory's ``prior/`` (``models/factory.py::load_models_cascade``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sliders_conceptmod_tpu_torch.io.torch_convert import StateDict, clip_state_dict

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "cond_stage_model.transformer."
OPENCLIP_PREFIX = "cond_stage_model.model."
XL_TE1_PREFIX = "conditioner.embedders.0.transformer."
XL_TE2_PREFIX = "conditioner.embedders.1.model."
SD2_TEXT_LAYERS = 23
SD3_TE1_PREFIX = "text_encoders.clip_l.transformer."
SD3_TE2_PREFIX = "text_encoders.clip_g.transformer."

_RESNET_RENAMES = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}
_VAE_MID_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0", "norm": "group_norm"}


def _resnet_tail(rest, renames=_RESNET_RENAMES) -> str:
    joined = ".".join(rest[:-1])
    return renames.get(joined, joined) + "." + rest[-1]


def rename_unet_key(key: str) -> str:
    """LDM ``diffusion_model`` key (without prefix) → diffusers UNet key."""
    parts = key.split(".")
    head = parts[0]
    if head == "time_embed":
        return ".".join(["time_embedding", {"0": "linear_1", "2": "linear_2"}[parts[1]]] + parts[2:])
    if head == "label_emb":  # SDXL's text_time embedding
        return ".".join(["add_embedding", {"0": "linear_1", "2": "linear_2"}[parts[2]]] + parts[3:])
    if head == "out":
        return ".".join([{"0": "conv_norm_out", "2": "conv_out"}[parts[1]]] + parts[2:])
    if head == "input_blocks":
        i = int(parts[1])
        if i == 0:
            return ".".join(["conv_in"] + parts[3:])
        block, layer = (i - 1) // 3, (i - 1) % 3
        if layer == 2:
            return ".".join([f"down_blocks.{block}", "downsamplers.0.conv"] + parts[4:])
        if parts[2] == "0":
            return f"down_blocks.{block}.resnets.{layer}." + _resnet_tail(parts[3:])
        return ".".join([f"down_blocks.{block}.attentions.{layer}"] + parts[3:])
    if head == "middle_block":
        sub, rest = parts[1], parts[2:]
        if sub == "1":
            return ".".join(["mid_block.attentions.0"] + rest)
        return f"mid_block.resnets.{0 if sub == '0' else 1}." + _resnet_tail(rest)
    if head == "output_blocks":
        i = int(parts[1])
        block, layer, sub, rest = i // 3, i % 3, parts[2], parts[3:]
        if sub == "0":
            return f"up_blocks.{block}.resnets.{layer}." + _resnet_tail(rest)
        if rest and rest[0] == "conv":
            return ".".join([f"up_blocks.{block}.upsamplers.0.conv"] + rest[1:])
        return ".".join([f"up_blocks.{block}.attentions.{layer}"] + rest)
    raise ValueError(f"unmapped LDM UNet key: {key}")


def rename_vae_key(key: str, num_up_blocks: int) -> Tuple[str, bool]:
    """LDM ``first_stage_model`` key (without prefix) → (diffusers VAE key,
    whether a 1×1 conv becomes a Linear)."""
    parts = key.split(".")
    shortcut = {"nin_shortcut": "conv_shortcut"}
    if parts[0] in ("quant_conv", "post_quant_conv"):
        return key, False
    if parts[0] in ("encoder", "decoder"):
        side, body = parts[0], parts[1:]
        if body[0] in ("conv_in", "conv_out"):
            return key, False
        if body[0] == "norm_out":
            return ".".join([side, "conv_norm_out"] + body[1:]), False
        if body[0] == "mid":
            if body[1] in ("block_1", "block_2"):
                return f"{side}.mid_block.resnets.{int(body[1][-1]) - 1}." + _resnet_tail(body[2:], shortcut), False
            if body[1] == "attn_1":
                return ".".join([side, "mid_block.attentions.0", _VAE_MID_ATTN[body[2]]] + body[3:]), body[2] != "norm"
        if body[0] in ("down", "up"):
            i = int(body[1])
            blocks = "down_blocks" if body[0] == "down" else "up_blocks"
            if body[0] == "up":
                i = num_up_blocks - 1 - i  # LDM's decoder up indices run the other way
            if body[2] == "block":
                return f"{side}.{blocks}.{i}.resnets.{body[3]}." + _resnet_tail(body[4:], shortcut), False
            if body[2] in ("downsample", "upsample"):
                return ".".join([side, f"{blocks}.{i}.{body[2]}rs.0"] + body[3:]), False
    raise ValueError(f"unmapped LDM VAE key: {key}")


def openclip_to_transformers(sd: StateDict, max_layers: int = None) -> StateDict:
    """An OpenCLIP text tower → the transformers layout (then
    :func:`~sliders_conceptmod_tpu_torch.io.torch_convert.clip_state_dict`)."""
    out: StateDict = {}
    for key, value in sd.items():
        if key == "text_projection":  # x @ W with W [width, proj]: a Linear stores [proj, width]
            out["text_projection.weight"] = value.t().contiguous()
        elif key == "text_projection.weight":  # already stored as a Linear
            out[key] = value
        elif key == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = value
        elif key == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = value
        elif key.startswith("ln_final."):
            out["text_model.final_layer_norm." + key[len("ln_final."):]] = value
        elif key.startswith("transformer.resblocks."):
            layer, _, tail = key[len("transformer.resblocks."):].partition(".")
            if (max_layers is not None and int(layer) >= max_layers) or tail == "attn_mask":
                continue
            base = f"text_model.encoder.layers.{layer}."
            if tail in ("attn.in_proj_weight", "attn.in_proj_bias"):
                leaf = tail.rsplit("_", 1)[1]
                for name, chunk in zip(("q_proj", "k_proj", "v_proj"), value.chunk(3, dim=0)):
                    out[f"{base}self_attn.{name}.{leaf}"] = chunk.contiguous()
                continue
            tail = (tail.replace("attn.out_proj", "self_attn.out_proj").replace("ln_1", "layer_norm1")
                    .replace("ln_2", "layer_norm2").replace("mlp.c_fc", "mlp.fc1").replace("mlp.c_proj", "mlp.fc2"))
            out[base + tail] = value
    return out


def swap_scale_shift(value: torch.Tensor) -> torch.Tensor:
    """SGM's AdaLN heads emit (shift, scale); diffusers' (and
    ``models/mmdit.py``'s continuous AdaLN) chunk (scale, shift): swap the
    two halves of the output axis. Its own inverse."""
    half = value.shape[0] // 2
    return torch.cat([value[half:], value[:half]], dim=0)


def convert_sd3_mmdit_state_dict(sd: StateDict) -> StateDict:
    """SD3's SGM MMDiT (keys without ``model.diffusion_model.``) → the port's
    ``SD3Transformer2DModel`` names, the renames of diffusers' single-file
    conversion (the JAX ``convert_sd3_mmdit_state_dict``): each fused
    ``attn.qkv`` splits into ``to_q/to_k/to_v`` (``add_q/k/v_proj`` in the
    context stream), ``adaLN_modulation.1`` → ``norm1(_context).linear`` /
    ``norm_out.linear``, and every 2·dim AdaLN head (``norm_out`` and the
    last block's context norm) swaps its (shift, scale) halves. Without the
    swap the weights load and the images come out wrong. The stored
    ``pos_embed`` table is dropped: the model computes it."""
    out: StateDict = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "pos_embed":
            continue
        if parts[0] == "x_embedder":
            out[".".join(["pos_embed"] + parts[1:])] = value
        elif parts[0] in ("t_embedder", "y_embedder"):
            sub = "timestep_embedder" if parts[0] == "t_embedder" else "text_embedder"
            out[".".join(["time_text_embed", sub, {"0": "linear_1", "2": "linear_2"}[parts[2]]] + parts[3:])] = value
        elif parts[0] == "context_embedder":
            out[key] = value
        elif parts[0] == "final_layer":
            if parts[1] == "adaLN_modulation":
                out["norm_out.linear." + parts[-1]] = swap_scale_shift(value)
            else:
                out[".".join(["proj_out"] + parts[2:])] = value
        elif parts[0] == "joint_blocks":
            base = f"transformer_blocks.{parts[1]}."
            ctx = parts[2] == "context_block"
            rest = parts[3:]
            if rest[:2] == ["attn", "qkv"]:
                names = ("add_q_proj", "add_k_proj", "add_v_proj") if ctx else ("to_q", "to_k", "to_v")
                for name, chunk in zip(names, value.chunk(3, dim=0)):
                    out[f"{base}attn.{name}.{rest[2]}"] = chunk.contiguous()
            elif rest[:2] == ["attn", "proj"]:
                out[base + ("attn.to_add_out." if ctx else "attn.to_out.0.") + rest[2]] = value
            elif rest[0] == "adaLN_modulation":
                # the last block's context head is 2·dim (the continuous AdaLN):
                # read off the sibling weight, so its bias swaps with it
                w = sd[".".join(parts[:-1] + ["weight"])]
                if ctx and w.shape[0] == 2 * w.shape[1]:
                    value = swap_scale_shift(value)
                out[base + ("norm1_context.linear." if ctx else "norm1.linear.") + rest[2]] = value
            elif rest[0] == "mlp":
                fc = {"fc1": "net.0.proj", "fc2": "net.2"}[rest[1]]
                out[base + ("ff_context." if ctx else "ff.") + fc + "." + rest[2]] = value
            else:
                raise ValueError(f"Unmapped SD3 MMDiT key: {key}")
        else:
            raise ValueError(f"Unmapped SD3 MMDiT key: {key}")
    return out


def _convert_sd3(sd: StateDict) -> Dict[str, StateDict]:
    out = {"transformer": convert_sd3_mmdit_state_dict(
        {k[len(UNET_PREFIX):]: v for k, v in sd.items() if k.startswith(UNET_PREFIX)})}
    vae_sd = {k: v for k, v in sd.items() if k.startswith(VAE_PREFIX)}
    if vae_sd:
        out["vae"] = convert_ldm_checkpoint(vae_sd)["vae"]
    for prefix, name in ((SD3_TE1_PREFIX, "text_encoder"), (SD3_TE2_PREFIX, "text_encoder_2")):
        te = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if te:
            out[name] = clip_state_dict(te)
    return out


def convert_flux_bfl_state_dict(sd: StateDict) -> StateDict:
    """A BFL single-file Flux transformer (``flux1-dev/schnell.safetensors``:
    ``double_blocks`` / ``single_blocks`` at the top level, fused qkv and
    qkv+mlp Linears) → the port's (diffusers') names (the JAX
    ``convert_flux_bfl_state_dict``): a double block's ``img_attn.qkv`` /
    ``txt_attn.qkv`` split into ``to_q/k/v`` / ``add_q/k/v_proj``, a single
    block's ``linear1`` into q, k, v (d rows each) and ``proj_mlp`` (4d), the
    final AdaLN's (shift, scale) swapped to diffusers' (scale, shift). The
    text towers and the VAE ship separately in BFL's distribution."""
    out: StateDict = {}
    for key, value in sd.items():
        parts = key.split(".")
        head = parts[0]
        if head == "img_in":
            out["x_embedder." + parts[1]] = value
        elif head == "txt_in":
            out["context_embedder." + parts[1]] = value
        elif head in ("time_in", "vector_in", "guidance_in"):
            sub = {"time_in": "timestep_embedder", "vector_in": "text_embedder", "guidance_in": "guidance_embedder"}
            lin = {"in_layer": "linear_1", "out_layer": "linear_2"}[parts[1]]
            out[f"time_text_embed.{sub[head]}.{lin}.{parts[2]}"] = value
        elif head == "final_layer":
            if parts[1] == "adaLN_modulation":
                out["norm_out.linear." + parts[3]] = swap_scale_shift(value)
            else:
                out["proj_out." + parts[2]] = value
        elif head == "double_blocks":
            base = f"transformer_blocks.{parts[1]}."
            mod, rest = parts[2], parts[3:]
            txt = mod.startswith("txt_")
            kind = mod.split("_", 1)[1]  # mod | attn | mlp
            if kind == "mod":
                out[base + ("norm1_context.linear." if txt else "norm1.linear.") + rest[1]] = value
            elif kind == "mlp":
                ff = "ff_context" if txt else "ff"
                out[base + ff + {"0": ".net.0.proj.", "2": ".net.2."}[rest[0]] + rest[1]] = value
            elif kind == "attn" and rest[0] == "qkv":
                names = ("add_q_proj", "add_k_proj", "add_v_proj") if txt else ("to_q", "to_k", "to_v")
                for name, chunk in zip(names, value.chunk(3, dim=0)):
                    out[f"{base}attn.{name}.{rest[1]}"] = chunk.contiguous()
            elif kind == "attn" and rest[0] == "norm":
                which = "q" if rest[1] == "query_norm" else "k"
                out[base + f"attn.norm_{'added_' if txt else ''}{which}.weight"] = value
            elif kind == "attn" and rest[0] == "proj":
                out[base + ("attn.to_add_out." if txt else "attn.to_out.0.") + rest[1]] = value
            else:
                raise ValueError(f"Unmapped BFL Flux key: {key}")
        elif head == "single_blocks":
            base = f"single_transformer_blocks.{parts[1]}."
            mod, rest = parts[2], parts[3:]
            if mod == "linear1":
                d = value.shape[0] // 7  # rows: 3d qkv + 4d mlp
                for name, chunk in zip(("attn.to_q.", "attn.to_k.", "attn.to_v.", "proj_mlp."),
                                       value.split([d, d, d, 4 * d], dim=0)):
                    out[base + name + rest[0]] = chunk.contiguous()
            elif mod == "linear2":
                out[base + "proj_out." + rest[0]] = value
            elif mod == "norm":
                out[base + f"attn.norm_{'q' if rest[0] == 'query_norm' else 'k'}.weight"] = value
            elif mod == "modulation":
                out[base + "norm.linear." + rest[1]] = value
            else:
                raise ValueError(f"Unmapped BFL Flux key: {key}")
        else:
            raise ValueError(f"Unmapped BFL Flux key: {key}")
    return out


CASCADE_SINGLE_FILE_REFUSAL = (
    "Stable Cascade single files are not loaded: the JAX package has no single-file loader for Stable Cascade "
    "either; load the prior from a diffusers directory's prior/ (load_models_cascade)")


def _refuse_other_families(sd: StateDict) -> None:
    if any(k.startswith(("clip_txt_mapper.", "effnet_mapper.", "clip_txt_pooled_mapper.")) for k in sd):
        raise NotImplementedError(CASCADE_SINGLE_FILE_REFUSAL)


def convert_ldm_checkpoint(sd: StateDict) -> Dict[str, StateDict]:
    """Split and rename a whole LDM/SGM state dict (see the module
    docstring)."""
    _refuse_other_families(sd)
    if any(k.startswith(("double_blocks.", "single_blocks.")) for k in sd):  # BFL Flux: the transformer at top level
        return {"transformer": convert_flux_bfl_state_dict(sd)}
    if any(k.startswith(UNET_PREFIX + "joint_blocks.") for k in sd):
        return _convert_sd3(sd)
    up = [int(k[len(VAE_PREFIX):].split(".")[2]) for k in sd if k.startswith(VAE_PREFIX + "decoder.up.")]
    num_up_blocks = max(up) + 1 if up else 4
    unet: StateDict = {}
    vae: StateDict = {}
    towers: Dict[str, StateDict] = {p: {} for p in (CLIP_PREFIX, OPENCLIP_PREFIX, XL_TE1_PREFIX, XL_TE2_PREFIX)}
    for key, value in sd.items():
        if key.startswith(UNET_PREFIX):
            unet[rename_unet_key(key[len(UNET_PREFIX):])] = value
        elif key.startswith(VAE_PREFIX):
            name, squeeze = rename_vae_key(key[len(VAE_PREFIX):], num_up_blocks)
            vae[name] = value[:, :, 0, 0] if squeeze and value.dim() == 4 else value
        else:
            for prefix, tower in towers.items():
                if key.startswith(prefix):
                    tower[key[len(prefix):]] = value
                    break
    out = {"unet": unet, "vae": vae}
    if towers[XL_TE1_PREFIX]:
        out["text_encoder"] = clip_state_dict(towers[XL_TE1_PREFIX])
    if towers[XL_TE2_PREFIX]:  # bigG keeps every layer: SDXL takes the penultimate state itself
        out["text_encoder_2"] = clip_state_dict(openclip_to_transformers(towers[XL_TE2_PREFIX]))
    if towers[CLIP_PREFIX]:
        out["text_encoder"] = clip_state_dict(towers[CLIP_PREFIX])
    elif towers[OPENCLIP_PREFIX]:
        oc = towers[OPENCLIP_PREFIX]
        n_layers = 1 + max(int(k.split(".")[2]) for k in oc if k.startswith("transformer.resblocks."))
        out["text_encoder"] = clip_state_dict(openclip_to_transformers(oc, min(n_layers, SD2_TEXT_LAYERS)))
    return out


def read_checkpoint(path: str, meta: bool = False) -> StateDict:
    """Every tensor of a ``.safetensors`` or ``.ckpt`` file, on the CPU
    (``meta``: on the meta device, no tensor data read)."""
    if str(path).endswith(".safetensors"):
        from sliders_conceptmod_tpu_torch.io.safetensors import load_file, load_meta

        return (load_meta if meta else load_file)(str(path))
    data = torch.load(str(path), map_location="meta" if meta else "cpu", weights_only=True)
    data = data.get("state_dict", data)
    return {k: v for k, v in data.items() if isinstance(v, torch.Tensor)}


def load_ldm_checkpoint(path: str, meta: bool = False) -> Dict[str, StateDict]:
    return convert_ldm_checkpoint(read_checkpoint(path, meta))
