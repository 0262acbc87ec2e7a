"""LoRA key layouts: diffusers (the trainer's export) <-> A1111 webui.

The port of `aqualora_tpu/tools/lora_layouts.py`, the reference's
`scripts/diffusers_lora_to_webui.py:5-24` and
`scripts/webui_lora_to_diffusers.py:5-27`.  The regex pipelines are the
format, so they are copied rule for rule, the webui -> diffusers
converter's deliberate drop of the text-encoder, ff, alpha and proj keys
(`webui_lora_to_diffusers.py:9-11`) included.  Only keys change: the
tensors are passed through as they are.

    python -m aqualora_torch.tools.lora_layouts --src_lora IN --tgt_lora OUT
        (diffusers -> webui; `main_w2d` is the other direction)
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, TypeVar

from aqualora_torch.core.io import load_safetensors, save_safetensors

T = TypeVar("T")


def diffusers_to_webui(state: Dict[str, T]) -> Dict[str, T]:
    """The diffusers trainer layout -> A1111's `lora_unet_*` convention."""
    out = {}
    for key, v in state.items():
        k = re.sub(r"\.processor\.", "_", key)
        k = re.sub(r"mid_block\.", "mid_block_", k)
        k = re.sub(r"_lora\.up\.", ".lora_up.", k)
        k = re.sub(r"\.lora\.up\.", ".lora_up.", k)
        k = re.sub(r"_lora\.down\.", ".lora_down.", k)
        k = re.sub(r"\.lora\.down\.", ".lora_down.", k)
        k = re.sub(r"\.(\d+)\.", r"_\1_", k)
        k = re.sub(r"_lora_up\.", ".lora_up.", k)
        k = re.sub(r"_lora_down\.", ".lora_down.", k)
        k = re.sub(r"to_out", "to_out_0", k)
        k = re.sub(r"unet\.", "lora_unet_", k)
        k = re.sub(r"_ff\.net_", "_ff_net_", k)
        out[k] = v
    return out


def webui_to_diffusers(state: Dict[str, T]) -> Dict[str, T]:
    """A1111's layout -> diffusers' attention-processor layout.  Drops the
    text-encoder, ff, alpha and proj keys, as the reference does."""
    out = {}
    omitted = ("_te_text_", "_ff_net_", "alpha", "_proj_")
    for key, v in state.items():
        if any(x in key for x in omitted):
            continue
        k = re.sub(r"^lora_unet_down_blocks_", "down_blocks.", key)
        k = re.sub(r"^lora_unet_up_blocks_", "up_blocks.", k)
        k = re.sub(r"^lora_unet_mid_block_", "mid_block.", k)
        k = re.sub(r"_attentions_", ".attentions.", k)
        k = re.sub(r"_transformer_blocks_", ".transformer_blocks.", k)
        k = re.sub(r"_attn(\d+)_", r".attn\1.processor.", k)
        k = re.sub(r"_to_", ".to_", k)
        k = re.sub(r"\.lora_up\.", "_lora.up.", k)
        k = re.sub(r"\.lora_down\.", "_lora.down.", k)
        k = re.sub(r"_0", "", k)
        k = re.sub(r"_alpha", ".alpha", k)
        k = re.sub(r"mid_block\.attentions\.", "mid_block.attentions.0.", k)
        out[k] = v
    return out


def _convert(description: str, fn, argv=None) -> None:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--src_lora", type=str, required=True)
    p.add_argument("--tgt_lora", type=str, required=True)
    args = p.parse_args(argv)
    save_safetensors(fn(load_safetensors(args.src_lora)), args.tgt_lora)
    print(f"saved {args.tgt_lora}")


def main_d2w(argv=None):
    _convert("diffusers LoRA -> webui layout", diffusers_to_webui, argv)


def main_w2d(argv=None):
    _convert("webui LoRA -> diffusers layout", webui_to_diffusers, argv)


if __name__ == "__main__":
    main_d2w()
