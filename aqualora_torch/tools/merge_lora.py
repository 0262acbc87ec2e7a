"""Bake webui-layout LoRAs into a whole Stable Diffusion checkpoint.

The port of `aqualora_tpu/tools/merge_lora.py`, the reference's
kohya-derived `scripts/merge_lora.py`: for every LoRA module
`W += ratio * (alpha / dim) * up @ down`, for linear, 1x1-conv and
3x3-conv LoRAs (`merge_lora.py:80-127`), reading a single-file LDM
checkpoint or a diffusers directory and writing a single-file LDM
checkpoint (`:147-179`) with SAI modelspec metadata (`sai_model_spec`).

The webui name of each module is resolved from the known SD-1.5 LoRA
sites and text-encoder modules, not from kohya's scan of a live model
(`merge_lora.py:56-78`).  The delta is computed on the host with numpy
and added in float32, as the JAX package does; its sum over the rank runs
in float64 and is rounded to float32 once, as the port's fold does on the
card, so that a merged single file holds the folded weights bit for bit
(JAX's float32 sum differs from it in the last bit of some elements).

    python -m aqualora_torch.tools.merge_lora --sd_model BASE \\
        --save_to OUT.safetensors --models watermark.safetensors \\
        [--ratios 1.0] [--precision fp16] [--v2] [--no_metadata]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from aqualora_torch.core.config import UNetConfig
from aqualora_torch.core.io import (load_safetensors, lora_torch_key,
                                    save_safetensors, unet_module_keys)
from aqualora_torch.tools import ldm_convert, sai_model_spec
from aqualora_torch.tools.lora_layouts import diffusers_to_webui

State = Dict[str, torch.Tensor]


def webui_name_to_module() -> Dict[str, Tuple[str, str]]:
    """webui module name -> ('unet' | 'te', diffusers module path)."""
    table: Dict[str, Tuple[str, str]] = {}
    for mk in unet_module_keys(UNetConfig.sd15()):
        webui = next(iter(diffusers_to_webui({lora_torch_key(mk, "down"):
                                              None})))
        table[webui.replace(".lora_down.weight", "")] = ("unet", mk)
    # the text encoder: q/k/v/out and the MLP's fc1/fc2 for up to 23 layers
    # (SD-1.x has 12, SD-2.x's open-CLIP port 23; a layer the loaded model
    # lacks is skipped at merge time)
    for layer in range(23):
        base = f"text_model.encoder.layers.{layer}"
        for mod in ("self_attn.q_proj", "self_attn.k_proj",
                    "self_attn.v_proj", "self_attn.out_proj",
                    "mlp.fc1", "mlp.fc2"):
            webui = "lora_te_" + f"{base}.{mod}".replace(".", "_")
            table[webui] = ("te", f"{base}.{mod}")
    return table


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy()


def merge_lora_into_states(unet_state: State, te_state: State,
                           lora_state: State, ratio: float = 1.0) -> None:
    """W += ratio * (alpha / dim) * up @ down, in place on the state dicts
    (merge_lora.py:80-127); each weight keeps its type."""
    table = webui_name_to_module()
    modules = sorted({k.rsplit(".", 2)[0] for k in lora_state
                      if ".lora_down." in k})
    for name in modules:
        down = _f32(lora_state[f"{name}.lora_down.weight"])
        up = _f32(lora_state[f"{name}.lora_up.weight"])
        dim = down.shape[0]
        alpha_key = f"{name}.alpha"
        alpha = (float(lora_state[alpha_key]) if alpha_key in lora_state
                 else float(dim))
        scale = alpha / dim
        if name not in table:
            # as the reference (merge_lora.py:93-95): a kohya LoRA may carry
            # modules outside the watermark's sites (resnet 3x3 convs,
            # conv_in, ...); skip them with its message instead of aborting
            # a half-applied merge
            print(f"no module found for LoRA weight: {name}")
            continue
        which, module = table[name]
        state = unet_state if which == "unet" else te_state
        wkey = f"{module}.weight"
        if wkey not in state:
            # e.g. an SD-2 text-encoder LoRA layer >= 12 merged into an
            # SD-1.x base: the site is in the table, not in the model
            print(f"no module found for LoRA weight: {name}")
            continue
        w = _f32(state[wkey])
        # the sum over the rank in float64, rounded to float32 once: the
        # pipeline's fold (`models/lora.fold_lora_tree`) computes the same
        # float32 delta on the card, so the merged file gives its weights
        # bit for bit
        up64, down64 = up.astype(np.float64), down.astype(np.float64)
        if down.ndim == 2:                       # linear
            delta = up64 @ down64
        elif down.shape[2:] == (1, 1):           # 1x1 conv
            delta = (up64[:, :, 0, 0] @ down64[:, :, 0, 0])[:, :, None, None]
        else:                                    # 3x3 conv (1x1 up)
            delta = np.einsum("or,rikl->oikl", up64[:, :, 0, 0], down64)
        delta = delta.astype(np.float32)
        # a layout mismatch between the LoRA and the base (merge_lora.py:
        # 108-111): a 1x1-conv LoRA merges into a linear projection by
        # squeezing, a linear LoRA into a 1x1-conv weight by expanding, and
        # never by broadcasting, which would build an [O, I, O, I] tensor
        if w.ndim == 2 and delta.ndim == 4:
            if delta.shape[2:] != (1, 1):
                raise ValueError(
                    f"{name}: 3x3-conv LoRA cannot merge into the linear "
                    f"weight {wkey} {tuple(w.shape)}")
            delta = delta[:, :, 0, 0]
        elif w.ndim == 4 and delta.ndim == 2:
            delta = delta[:, :, None, None]
        state[wkey] = torch.from_numpy(w + ratio * scale * delta).to(
            state[wkey].dtype)


def build_sai_metadata(args, tensors: State | None = None) -> Dict[str, str]:
    """The whole SAI modelspec metadata of the reference merge CLI's call
    (scripts/merge_lora.py:153-169): merged_from the base's and the LoRAs'
    titles, the title the output's file stem, is_stable_diffusion_ckpt;
    plus the content hash (which the reference leaves TODO)."""
    merged_from = sai_model_spec.build_merged_from(
        [args.sd_model] + list(args.models))
    title = os.path.splitext(os.path.basename(args.save_to))[0]
    meta = sai_model_spec.build_metadata(
        None, args.v2, args.v2, False, False, False, time.time(),
        title=title, merged_from=merged_from, is_stable_diffusion_ckpt=True)
    if tensors is not None:
        meta["modelspec.hash_sha256"] = (
            sai_model_spec.precalculate_safetensors_hashes(tensors))
    return meta


def load_sd_states(path: str) -> Tuple[State, State, State]:
    """A single-file LDM safetensors or a diffusers directory -> (unet,
    vae, text encoder) in diffusers' layout, the CLIP under
    `text_model.`."""
    if os.path.isdir(path):
        unet = load_safetensors(os.path.join(
            path, "unet/diffusion_pytorch_model.safetensors"))
        vae = load_safetensors(os.path.join(
            path, "vae/diffusion_pytorch_model.safetensors"))
        te = load_safetensors(os.path.join(
            path, "text_encoder/model.safetensors"))
        te = {k[len("text_model."):] if k.startswith("text_model.") else k: v
              for k, v in te.items()}
        te = {f"text_model.{k}": v for k, v in te.items()}
        return unet, vae, te
    return ldm_convert.ldm_to_diffusers(load_safetensors(path))


def merge(args) -> None:
    unet, vae, te = load_sd_states(args.sd_model)
    ratios = args.ratios or [1.0] * len(args.models)
    if len(ratios) != len(args.models):
        # the reference asserts the same (merge_lora.py:131): a short
        # --ratios would drop the trailing LoRAs without a word
        raise SystemExit(f"--ratios has {len(ratios)} entries for "
                         f"{len(args.models)} --models; counts must match")
    for lora_path, ratio in zip(args.models, ratios):
        merge_lora_into_states(unet, te, load_safetensors(lora_path), ratio)
        print(f"merged {lora_path} at ratio {ratio}")
    # --v2 goes on to the saver, so the single file takes the SD-2 layout
    # (the open-CLIP qkv fused under cond_stage_model.model., linear
    # proj_in/out), as the reference saves with v2 (merge_lora.py:178)
    out = ldm_convert.diffusers_to_ldm(unet, vae, te, v2=args.v2)
    if args.precision == "fp16":
        out = {k: v.to(torch.float16) for k, v in out.items()}
    if args.v2 and not args.no_metadata:
        # merge_lora.py:171-175: a merged state cannot tell its prediction
        # type, so v2 metadata says 768-v, with the reference's warning
        print("Cannot determine if the model is for v-prediction; "
              "saving modelspec metadata as v-prediction (768-v)")
    meta = None if args.no_metadata else build_sai_metadata(args, out)
    save_safetensors(out, args.save_to, metadata=meta)
    print(f"saved {args.save_to}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # the reference's flags (merge_lora.py:222-226)
    p.add_argument("--sd_model", type=str, required=True,
                   help="base SD checkpoint (single file or diffusers dir)")
    p.add_argument("--save_to", type=str, required=True)
    p.add_argument("--models", type=str, nargs="+", required=True,
                   help="webui-layout LoRA safetensors to merge")
    p.add_argument("--ratios", type=float, nargs="+", default=None)
    p.add_argument("--precision", type=str, default="fp32",
                   choices=["fp32", "fp16"])
    p.add_argument("--v2", action="store_true",
                   help="SD-2 base model: save in the v2 single-file layout "
                        "(open-CLIP text tower, linear proj_in/out) and "
                        "stamp the v2 modelspec fields")
    p.add_argument("--no_metadata", action="store_true")
    return p


def main(argv=None):
    merge(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
