"""Original-SD (LDM) single-file <-> diffusers checkpoint layouts.

The port of `aqualora_tpu/tools/ldm_convert.py` (the reference's vendored
kohya `scripts/lib/model_util.py`: the LDM <-> diffusers key tables,
`convert_ldm_unet_checkpoint:244`, `convert_ldm_vae_checkpoint:393`, CLIP
v1 `:560` and open-CLIP v2 `:578-640,1083-1151`, the v2 projection
reshapes `:235-241,655-664`, and the two
`scripts/convert_*_stable_diffusion*.py` CLIs).  The maps are generated
from the SD topology; SD-2.x single files take the same maps plus the v2
deltas (the open-CLIP text tower, linear transformer projections), found
on load by `detect_v2`.

Every function works on flat state dicts of torch tensors in torch layout
on the host.  It is key remapping: a tensor keeps its storage, the
reshapes are views, and only the open-CLIP q/k/v fuse (and the dummy
weights) make new tensors, so a 5 GB SD-2.1 state is never copied.

    python -m aqualora_torch.tools.ldm_convert --model_path DIFFUSERS_DIR \
        --checkpoint_path OUT.safetensors [--v2] [--half]
        (diffusers -> single file; `main_to_diffusers` is the other way)
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import torch

from aqualora_torch.core.io import load_safetensors, save_safetensors

State = Dict[str, torch.Tensor]


# -- UNet ---------------------------------------------------------------------

_RESNET_MAP = {
    "norm1": "in_layers.0", "conv1": "in_layers.2",
    "time_emb_proj": "emb_layers.1", "norm2": "out_layers.0",
    "conv2": "out_layers.3", "conv_shortcut": "skip_connection",
}

_N_DOWN = 4
_LAYERS = 2
_ATTN_DOWN = (True, True, True, False)


def unet_prefix_map() -> Dict[str, str]:
    """diffusers module prefix -> LDM (model.diffusion_model) prefix."""
    m = {
        "time_embedding.linear_1": "time_embed.0",
        "time_embedding.linear_2": "time_embed.2",
        "conv_in": "input_blocks.0.0",
        "conv_norm_out": "out.0",
        "conv_out": "out.2",
        "mid_block.attentions.0": "middle_block.1",
    }
    for j, name in ((0, "middle_block.0"), (1, "middle_block.2")):
        for dk, lk in _RESNET_MAP.items():
            m[f"mid_block.resnets.{j}.{dk}"] = f"{name}.{lk}"
    for i in range(_N_DOWN):
        for j in range(_LAYERS):
            idx = 1 + i * (_LAYERS + 1) + j
            for dk, lk in _RESNET_MAP.items():
                m[f"down_blocks.{i}.resnets.{j}.{dk}"] = \
                    f"input_blocks.{idx}.0.{lk}"
            if _ATTN_DOWN[i]:
                m[f"down_blocks.{i}.attentions.{j}"] = f"input_blocks.{idx}.1"
        if i < _N_DOWN - 1:
            m[f"down_blocks.{i}.downsamplers.0.conv"] = \
                f"input_blocks.{(i + 1) * (_LAYERS + 1)}.0.op"
    attn_up = tuple(reversed(_ATTN_DOWN))
    for i in range(_N_DOWN):
        for j in range(_LAYERS + 1):
            idx = i * (_LAYERS + 1) + j
            for dk, lk in _RESNET_MAP.items():
                m[f"up_blocks.{i}.resnets.{j}.{dk}"] = \
                    f"output_blocks.{idx}.0.{lk}"
            if attn_up[i]:
                m[f"up_blocks.{i}.attentions.{j}"] = f"output_blocks.{idx}.1"
        if i < _N_DOWN - 1:
            sub = 2 if attn_up[i] else 1
            m[f"up_blocks.{i}.upsamplers.0.conv"] = \
                f"output_blocks.{i * (_LAYERS + 1) + _LAYERS}.{sub}.conv"
    return m


def _apply_prefix_map(state: State, pmap: Dict[str, str],
                      reverse: bool = False) -> State:
    """Longest-prefix rewrite of every key."""
    table = sorted(((v, k) if reverse else (k, v) for k, v in pmap.items()),
                   key=lambda kv: -len(kv[0]))
    out = {}
    for key, val in state.items():
        new = None
        for src, dst in table:
            if key == src or key.startswith(src + "."):
                new = dst + key[len(src):]
                break
        if new is None:
            raise KeyError(f"unmapped key {key}")
        out[new] = val
    return out


def unet_diffusers_to_ldm(state: State) -> State:
    return {f"model.diffusion_model.{k}": v for k, v in
            _apply_prefix_map(state, unet_prefix_map()).items()}


def unet_ldm_to_diffusers(state: State) -> State:
    pref = "model.diffusion_model."
    inner = {k[len(pref):]: v for k, v in state.items() if k.startswith(pref)}
    return _apply_prefix_map(inner, unet_prefix_map(), reverse=True)


# -- VAE ----------------------------------------------------------------------

_VAE_RESNET_MAP = {
    "norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
    "conv_shortcut": "nin_shortcut",
}
_VAE_ATTN_MAP = {
    "group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
    "to_out.0": "proj_out",
}
_VAE_BLOCKS = 4
_VAE_LAYERS = 2


def vae_prefix_map() -> Dict[str, str]:
    m = {"quant_conv": "quant_conv", "post_quant_conv": "post_quant_conv"}
    for side in ("encoder", "decoder"):
        m[f"{side}.conv_in"] = f"{side}.conv_in"
        m[f"{side}.conv_norm_out"] = f"{side}.norm_out"
        m[f"{side}.conv_out"] = f"{side}.conv_out"
        for j, name in ((0, "block_1"), (1, "block_2")):
            for dk, lk in _VAE_RESNET_MAP.items():
                m[f"{side}.mid_block.resnets.{j}.{dk}"] = \
                    f"{side}.mid.{name}.{lk}"
        for dk, lk in _VAE_ATTN_MAP.items():
            m[f"{side}.mid_block.attentions.0.{dk}"] = \
                f"{side}.mid.attn_1.{lk}"
    for i in range(_VAE_BLOCKS):
        for j in range(_VAE_LAYERS):
            for dk, lk in _VAE_RESNET_MAP.items():
                m[f"encoder.down_blocks.{i}.resnets.{j}.{dk}"] = \
                    f"encoder.down.{i}.block.{j}.{lk}"
        if i < _VAE_BLOCKS - 1:
            m[f"encoder.down_blocks.{i}.downsamplers.0.conv"] = \
                f"encoder.down.{i}.downsample.conv"
    for i in range(_VAE_BLOCKS):   # decoder up blocks are REVERSED in LDM
        ldm_i = _VAE_BLOCKS - 1 - i
        for j in range(_VAE_LAYERS + 1):
            for dk, lk in _VAE_RESNET_MAP.items():
                m[f"decoder.up_blocks.{i}.resnets.{j}.{dk}"] = \
                    f"decoder.up.{ldm_i}.block.{j}.{lk}"
        if i < _VAE_BLOCKS - 1:
            m[f"decoder.up_blocks.{i}.upsamplers.0.conv"] = \
                f"decoder.up.{ldm_i}.upsample.conv"
    return m


def _vae_attn_reshape_to_ldm(key: str, v: torch.Tensor) -> torch.Tensor:
    """diffusers uses Linear for the mid-attention's q/k/v/proj_out; LDM
    uses 1x1 convs (a view)."""
    if key.endswith(".weight") and v.dim() == 2 and any(
            f".attn_1.{n}.weight" in key for n in ("q", "k", "v", "proj_out")):
        return v[:, :, None, None]
    return v


def _vae_attn_reshape_to_diffusers(key: str, v: torch.Tensor
                                   ) -> torch.Tensor:
    if key.endswith(".weight") and v.dim() == 4 and v.shape[2:] == (1, 1) and \
            any(f"attentions.0.{n}.weight" in key
                for n in ("to_q", "to_k", "to_v", "to_out.0")):
        return v[:, :, 0, 0]
    return v


def vae_diffusers_to_ldm(state: State) -> State:
    out = _apply_prefix_map(state, vae_prefix_map())
    return {f"first_stage_model.{k}": _vae_attn_reshape_to_ldm(k, v)
            for k, v in out.items()}


def vae_ldm_to_diffusers(state: State) -> State:
    pref = "first_stage_model."
    inner = {k[len(pref):]: v for k, v in state.items() if k.startswith(pref)}
    out = _apply_prefix_map(inner, vae_prefix_map(), reverse=True)
    return {k: _vae_attn_reshape_to_diffusers(k, v) for k, v in out.items()}


# -- SD-2.x U-Net projection layout -------------------------------------------
#
# In v2 single-file checkpoints the transformer proj_in/proj_out are nn.Linear
# (2-D weights); SD-1.x LDM, and the port's U-Net for both versions, keep
# them 1x1 convs.  The reference reshapes at the boundary
# (`scripts/lib/model_util.py` linear_transformer_to_conv:235-241 /
# conv_transformer_to_linear:655-664); same here, on the diffusers-layout
# unet state (proj_in/proj_out only occur inside the unet's transformers).

def _unet_proj_weights(state):
    for k, v in state.items():
        if k.endswith(("proj_in.weight", "proj_out.weight")):
            yield k, v


def unet_proj_linear_to_conv(state: State) -> None:
    """v2-LDM [O,I] proj weights -> [O,I,1,1] convs (in place)."""
    for k, v in _unet_proj_weights(state):
        if v.dim() == 2:
            state[k] = v[:, :, None, None]


def unet_proj_conv_to_linear(state: State) -> None:
    """[O,I,1,1] conv proj weights -> v2-LDM [O,I] linears (in place)."""
    for k, v in _unet_proj_weights(state):
        if v.dim() == 4:
            state[k] = v[:, :, 0, 0]


# -- CLIP text encoder (SD-1.x layout: pure prefix) ---------------------------

_CLIP_PREF = "cond_stage_model.transformer."


def clip_diffusers_to_ldm(state: State) -> State:
    return {_CLIP_PREF + k: v for k, v in state.items()}


def clip_ldm_to_diffusers(state: State) -> State:
    out = {}
    for k, v in state.items():
        if k.startswith(_CLIP_PREF):
            k2 = k[len(_CLIP_PREF):]
            if "position_ids" in k2:
                continue
            out[k2] = v
    return out


# -- open-CLIP text encoder (SD-2.x layout) -----------------------------------
#
# v2 single-file checkpoints carry an open-CLIP ViT-H text tower under
# `cond_stage_model.model.` with fused qkv (`attn.in_proj_*`), GPT-style
# block names (resblocks/ln_1/ln_2/c_fc/c_proj), and 24 resblocks of which
# the diffusers CLIPTextModel keeps only 0..22 (SD2 conditions on the
# penultimate layer).  Equivalent of `scripts/lib/model_util.py`
# convert_ldm_clip_checkpoint_v2 (`:560-574` selection, `:565+` body) and
# convert_text_encoder_state_dict_to_sd_v2 (`:1083-1151`).

_CLIP2_PREF = "cond_stage_model.model."
_CLIP2_SUB = {  # open-CLIP block member -> HF CLIPEncoderLayer member
    "ln_1": "layer_norm1", "ln_2": "layer_norm2",
    "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2",
    "attn.out_proj": "self_attn.out_proj",
}
_DROPPED_LAYER = 23   # open-CLIP resblock past the penultimate cut


def clip_v2_ldm_to_diffusers(state: State) -> State:
    """open-CLIP tower -> HF `text_model.*` layout (fused qkv split in
    thirds; resblock 23 / text_projection / logit_scale dropped — they sit
    past the penultimate-layer conditioning point and diffusers' 23-layer
    CLIPTextModel never evaluates them).  position_ids are not fabricated
    (the port's CLIP computes positions from arange)."""
    out = {}
    for k, v in state.items():
        if not k.startswith(_CLIP2_PREF):
            continue
        k2 = k[len(_CLIP2_PREF):]
        if k2.startswith("transformer.resblocks."):
            layer, sub = k2[len("transformer.resblocks."):].split(".", 1)
            if int(layer) == _DROPPED_LAYER:
                continue
            base = f"text_model.encoder.layers.{layer}."
            name, leaf = sub.rsplit(".", 1)
            if name in _CLIP2_SUB:
                out[base + f"{_CLIP2_SUB[name]}.{leaf}"] = v
            elif sub.startswith("attn.in_proj_"):
                kind = sub[len("attn.in_proj_"):]          # weight | bias
                for proj, t in zip(("q_proj", "k_proj", "v_proj"),
                                   torch.chunk(v, 3, dim=0)):
                    out[base + f"self_attn.{proj}.{kind}"] = t
            else:
                raise KeyError(f"unexpected open-CLIP resblock key {k}")
        elif k2 == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = v
        elif k2 == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = v
        elif k2.startswith("ln_final."):
            out["text_model.final_layer_norm." + k2[len("ln_final."):]] = v
        elif k2.split(".")[0] in ("text_projection", "logit_scale"):
            continue                 # unused past the conditioning point
        elif "position_ids" in k2:
            # some v2 checkpoints (e.g. waifu-diffusion v1.4) carry an
            # explicit position_ids buffer; the reference special-cases
            # and drops/regenerates it (model_util.py:638-647) — our
            # CLIP computes positions from arange, so just skip
            continue
        else:
            raise KeyError(f"unexpected open-CLIP key {k}")
    return out


def clip_v2_diffusers_to_ldm(state: State,
                             make_dummy_weights: bool = False) -> State:
    """HF `text_model.*` -> open-CLIP tower (q/k/v re-fused).  With
    `make_dummy_weights`, fabricates the tensors diffusers never carries —
    resblock 23 as a copy of 22, ones text_projection, unit logit_scale —
    so strict open-CLIP consumers load the file
    (`model_util.py:1140-1150`)."""
    out, qkv = {}, {}
    hidden = None
    inv = {v: k for k, v in _CLIP2_SUB.items()}
    for k, v in state.items():
        if not k.startswith("text_model."):
            continue
        k2 = k[len("text_model."):]
        if "position_ids" in k2:
            continue
        # accept both the full HF layout (encoder.layers / embeddings.*)
        # and the port's flat layout (layers / *_embedding directly)
        for wrapper in ("encoder.", "embeddings."):
            if k2.startswith(wrapper):
                k2 = k2[len(wrapper):]
        if k2.startswith("layers."):
            layer, sub = k2[len("layers."):].split(".", 1)
            base = f"{_CLIP2_PREF}transformer.resblocks.{layer}."
            name, leaf = sub.rsplit(".", 1)
            if name in inv:
                out[base + f"{inv[name]}.{leaf}"] = v
            elif name.startswith("self_attn."):
                qkv.setdefault((layer, leaf), {})[name.split(".")[1]] = v
            else:
                raise KeyError(f"unexpected text encoder key {k}")
        elif k2 == "position_embedding.weight":
            out[_CLIP2_PREF + "positional_embedding"] = v
        elif k2 == "token_embedding.weight":
            out[_CLIP2_PREF + "token_embedding.weight"] = v
            hidden = v.shape[1]
        elif k2.startswith("final_layer_norm."):
            out[_CLIP2_PREF + "ln_final."
                + k2[len("final_layer_norm."):]] = v
        else:
            raise KeyError(f"unexpected text encoder key {k}")
    for (layer, leaf), parts in qkv.items():
        out[f"{_CLIP2_PREF}transformer.resblocks.{layer}.attn.in_proj_"
            f"{leaf}"] = torch.cat(
                [parts["q_proj"], parts["k_proj"], parts["v_proj"]], dim=0)
    if make_dummy_weights:
        pref22 = f"{_CLIP2_PREF}transformer.resblocks.{_DROPPED_LAYER - 1}."
        for k in list(out):
            if k.startswith(pref22):
                out[k.replace(f".{_DROPPED_LAYER - 1}.",
                              f".{_DROPPED_LAYER}.", 1)] = out[k].clone()
        out[_CLIP2_PREF + "text_projection"] = torch.ones(hidden, hidden)
        out[_CLIP2_PREF + "logit_scale"] = torch.tensor(1.0)
    return out


# -- whole checkpoints --------------------------------------------------------

def detect_v2(state: State) -> bool:
    """v2 single-file checkpoints carry the open-CLIP tower prefix."""
    return any(k.startswith(_CLIP2_PREF) for k in state)


def ldm_to_diffusers(state: State, v2: bool | None = None
                     ) -> Tuple[Dict, Dict, Dict]:
    """full LDM state -> (unet, vae, text_encoder) diffusers-layout states.

    `v2=None` auto-detects from the text tower layout; v2 additionally
    reshapes the transformer proj linears to the conv layout the port's
    U-Net (and pre-0.17 diffusers) uses for both versions."""
    if v2 is None:
        v2 = detect_v2(state)
    unet = unet_ldm_to_diffusers(state)
    if v2:
        unet_proj_linear_to_conv(unet)
        te = clip_v2_ldm_to_diffusers(state)
    else:
        te = clip_ldm_to_diffusers(state)
    return unet, vae_ldm_to_diffusers(state), te


def diffusers_to_ldm(unet: Dict, vae: Dict, text_encoder: Dict,
                     v2: bool = False, make_dummy_weights: bool = False
                     ) -> State:
    out = {}
    out.update(unet_diffusers_to_ldm(unet))
    if v2:
        # squeeze BEFORE the vae keys join: the VAE's mid.attn_1.proj_out
        # also ends in proj_out.weight but stays a 1x1 conv in v2-LDM
        unet_proj_conv_to_linear(out)
        out.update(clip_v2_diffusers_to_ldm(
            text_encoder, make_dummy_weights=make_dummy_weights))
    else:
        out.update(clip_diffusers_to_ldm(text_encoder))
    out.update(vae_diffusers_to_ldm(vae))
    return out


def _cast_fp16_tensor(v: torch.Tensor) -> torch.Tensor:
    return (v.to(torch.float16) if v.dtype in (torch.float32, torch.float64)
            else v)


def _cast_fp16(state: State) -> State:
    """--half: fp32/fp64 tensors -> fp16 on save (reference converters'
    --half flag; integer/bool buffers untouched)."""
    return {k: _cast_fp16_tensor(v) for k, v in state.items()}


def main_to_original(argv=None):
    """diffusers dir -> single original-SD safetensors
    (convert_diffusers_to_original_stable_diffusion.py equivalent)."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True,
                   help="diffusers checkpoint directory")
    p.add_argument("--checkpoint_path", required=True,
                   help="output .safetensors")
    p.add_argument("--v2", action="store_true",
                   help="SD-2.x: open-CLIP text tower + linear transformer "
                        "projections (model_util.py v2 branches)")
    p.add_argument("--make_dummy_weights", action="store_true",
                   help="v2 only: fabricate resblock 23 / text_projection "
                        "/ logit_scale for strict open-CLIP loaders")
    p.add_argument("--half", action="store_true",
                   help="save weights as float16 (reference "
                        "convert_diffusers_to_original_stable_diffusion "
                        "--half)")
    args = p.parse_args(argv)
    unet = load_safetensors(os.path.join(
        args.model_path, "unet/diffusion_pytorch_model.safetensors"))
    vae = load_safetensors(os.path.join(
        args.model_path, "vae/diffusion_pytorch_model.safetensors"))
    te = load_safetensors(os.path.join(
        args.model_path, "text_encoder/model.safetensors"))
    state = diffusers_to_ldm(unet, vae, te, v2=args.v2,
                             make_dummy_weights=args.make_dummy_weights)
    if args.half:
        state = _cast_fp16(state)
    save_safetensors(state, args.checkpoint_path)
    print(f"saved {args.checkpoint_path}")


def main_to_diffusers(argv=None):
    """original-SD single file -> diffusers-layout directory
    (convert_original_stable_diffusion_to_diffusers.py equivalent)."""
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--dump_path", required=True)
    p.add_argument("--v2", action="store_true", default=None,
                   help="force SD-2.x branches (default: auto-detect from "
                        "the text tower layout)")
    p.add_argument("--half", action="store_true",
                   help="save weights as float16 (reference converter "
                        "--half)")
    p.add_argument("--device", type=str, default=None,
                   help="inert (reference CLI compatibility; conversion "
                        "is a host-side key remap here)")
    args = p.parse_args(argv)
    state = load_safetensors(args.checkpoint_path)
    unet, vae, te = ldm_to_diffusers(state, v2=args.v2)
    if args.half:
        unet, vae, te = _cast_fp16(unet), _cast_fp16(vae), _cast_fp16(te)
    for sub, st in (("unet", unet), ("vae", vae)):
        os.makedirs(os.path.join(args.dump_path, sub), exist_ok=True)
        save_safetensors(st, os.path.join(
            args.dump_path, sub, "diffusion_pytorch_model.safetensors"))
    os.makedirs(os.path.join(args.dump_path, "text_encoder"), exist_ok=True)
    save_safetensors(te, os.path.join(args.dump_path, "text_encoder",
                                      "model.safetensors"))
    print(f"saved diffusers layout under {args.dump_path}")


if __name__ == "__main__":
    main_to_original()
