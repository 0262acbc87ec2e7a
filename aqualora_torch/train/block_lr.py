"""Block-wise learning rate and rank dropout, the kohya LoRA network's
training extras, in PyTorch.

The port of `aqualora_tpu/train/block_lr.py`:

- block-wise LR (`--down_lr_weight`, `--mid_lr_weight`, `--up_lr_weight`,
  `--block_lr_zero_threshold`): a weight per U-Net depth, from a preset
  (`cosine`, `sine`, `linear`, `reverse_linear`, `zeros`, with an optional
  `+base`) or 12 comma-separated floats per side, mid one value; the block
  of a parameter is kohya's `get_block_index` (down 1 + 3i + j, mid 12, up
  13 + 3i + j).  JAX scales each LoRA update by its block's weight after
  AdamW (`:104-135`); for AdamW that is the same as a parameter group per
  block with the learning rate times the weight, decay included, which is
  what the trainer builds (`lr_weights`).  A weight at or below the
  threshold is 0: no update and no decay;
- rank dropout (`--rank_dropout`): each (sample, rank) channel of the
  diagonal message scale is dropped with probability p and the rest are
  rescaled by 1 / (1 - p) (`rank_dropout_scale`); the mask is one of the
  step's draws.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

NUM_OF_BLOCKS = 12          # per side (kohya's LoRANetwork.NUM_OF_BLOCKS)
PRESETS = ("cosine", "sine", "linear", "reverse_linear", "zeros")


def parse_lr_weight_list(spec: Optional[str]) -> Optional[List[float]]:
    """A preset name with an optional `+base`, or comma-separated floats
    (a short list is padded with 1.0) -> 12 weights; None for no spec.  A
    spec that is neither prints a warning and gives None, as kohya's."""
    if spec is None:
        return None
    n = NUM_OF_BLOCKS

    def warn():
        print(f"block LR weight spec {spec!r} is not a preset "
              "(cosine/sine/linear/reverse_linear/zeros[+base]) or a "
              "comma float list: block-wise LR disabled for this side")

    name, _, base_s = spec.partition("+")
    if name in PRESETS:
        try:
            base = float(base_s) if base_s else 0.0
        except ValueError:
            warn()
            return None
        if name == "cosine":
            return [math.sin(math.pi * (i / (n - 1)) / 2) + base
                    for i in reversed(range(n))]
        if name == "sine":
            return [math.sin(math.pi * (i / (n - 1)) / 2) + base
                    for i in range(n)]
        if name == "linear":
            return [i / (n - 1) + base for i in range(n)]
        if name == "reverse_linear":
            return [i / (n - 1) + base for i in reversed(range(n))]
        return [base] * n
    # split on ',' only, so that '1e+2' survives
    try:
        w = [float(x) for x in spec.split(",")]
    except ValueError:
        warn()
        return None
    return (w + [1.0] * n)[:n]


def block_index(name: str) -> Optional[int]:
    """kohya's `get_block_index` for a U-Net parameter name
    (`down_blocks.0.attentions.1. ...`); None outside the down, mid and up
    blocks."""
    parts = name.split(".")
    if parts[0] == "mid_block":
        return NUM_OF_BLOCKS
    if parts[0] not in ("down_blocks", "up_blocks") or len(parts) < 4:
        return None
    idx = 3 * int(parts[1]) + int(parts[3])
    return 1 + idx if parts[0] == "down_blocks" else NUM_OF_BLOCKS + 1 + idx


def lr_weight_for_path(name: str, down: Optional[List[float]],
                       mid: Optional[float], up: Optional[List[float]],
                       zero_threshold: float = 0.0) -> float:
    """The learning-rate weight of a LoRA parameter (1.0 outside the
    blocks, e.g. a text-encoder LoRA)."""
    idx = block_index(name)
    if idx is None:
        return 1.0
    if idx == NUM_OF_BLOCKS:
        w = 1.0 if mid is None else mid
    elif idx < NUM_OF_BLOCKS:
        w = 1.0 if down is None else down[idx]
    else:
        w = 1.0 if up is None else up[idx - NUM_OF_BLOCKS - 1]
    return w if w > zero_threshold else 0.0


def lr_weights(named: Iterable[Tuple[str, torch.Tensor]],
               down_spec: Optional[str], mid: Optional[float],
               up_spec: Optional[str], zero_threshold: float = 0.0
               ) -> Optional[Dict[int, float]]:
    """{id(parameter): weight} for the named U-Net LoRA parameters, or
    None when no side has a weight list."""
    down, up = parse_lr_weight_list(down_spec), parse_lr_weight_list(up_spec)
    if down is None and mid is None and up is None:
        return None
    print(f"block-wise LR: down={down} mid={mid} up={up}")
    return {id(p): lr_weight_for_path(name, down, mid, up, zero_threshold)
            for name, p in named}


def rank_dropout_scale(diag: torch.Tensor, mask: torch.Tensor,
                       p: float) -> torch.Tensor:
    """kohya's rank dropout folded into the diagonal scale: `mask` is the
    step's Bernoulli(1 - p) draw of diag's shape (`rank_dropout_scale`,
    `block_lr.py:138-145`)."""
    if p <= 0.0:
        return diag
    return diag * mask.to(diag.dtype) / (1.0 - p)
