"""Fold a chosen bit-string into the trained watermark LoRA, producing a
standard (diffusers-compatible) LoRA that carries the message in its
weights.

The port of `aqualora_tpu/tools/create_wm_lora.py` (the semantics of the
reference's `scripts/create_wm_lora.py:9-51`):
  attn/ff sites:      down' = diag(mapper(msg)) @ down * scale
  proj_in/out convs:  down' = down * mapper(msg)[:, None, None, None] * scale
  up weights unchanged; text-encoder keys dropped; scale default 1.03.

It reads and writes the torch-layout safetensors file through the port's
own reader and writer (`core/io.py`).  The mapper math runs in numpy as the
JAX package runs it, so the same message folds to the same numbers; the
folded tensors are written in float32.  The random message is drawn from
`numpy.random.default_rng`, so the same seed folds the same bits in both
packages.

    python -m aqualora_torch.tools.create_wm_lora --train_folder DIR \\
        [--hidinfo 0101...] [--msg_bits 48] [--scale 1.03]

prints the bit-string and writes
`DIR/<bitstring>/pytorch_lora_weights.safetensors`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from aqualora_torch.core.io import LORA_FILE, load_safetensors, save_safetensors


def mapper_diag_from_state(mapper_state: Dict[str, torch.Tensor],
                           msg_bits) -> np.ndarray:
    """MapperNet forward in numpy: (msg @ E)/sqrt(N) + 1
    (utils/models.py:110-115).  msg_bits: one [N_bits] message or a batch
    [B, N_bits]; returns [B, rank] (B=1 for one message), the one home for
    the mapper math of the fold path and the per-image serving path
    (`eval/utils_eval.simple_sample(messages=...)`)."""
    emb = torch.as_tensor(mapper_state["bit_embeddings.weight"]).float(
        ).cpu().numpy()
    msg = np.asarray(msg_bits, np.float32).reshape(-1, emb.shape[0])
    return (msg @ emb) / np.sqrt(emb.shape[0]) + 1.0       # [B, rank]


def load_mapper_state(train_folder: str) -> Dict[str, torch.Tensor]:
    """mapper.safetensors (the trainer's export) or mapper.pt (the
    reference's torch file, read with weights_only)."""
    st = os.path.join(train_folder, "mapper.safetensors")
    if os.path.exists(st):
        return load_safetensors(st)
    return torch.load(os.path.join(train_folder, "mapper.pt"),
                      map_location="cpu", weights_only=True)


def create_watermark_lora(train_folder: str, scale: float = 1.03,
                          msg_bits: int = 48,
                          hidinfo: Optional[str] = None, save: bool = True,
                          rng: Optional[np.random.Generator] = None
                          ) -> Tuple[str, Dict[str, torch.Tensor]]:
    """-> (bitstring, folded float32 state dict); saves to
    <train_folder>/<bitstring>/pytorch_lora_weights.safetensors when save."""
    lora = load_safetensors(os.path.join(train_folder, LORA_FILE))
    if hidinfo is None:
        rng = rng or np.random.default_rng()
        bits = rng.integers(0, 2, msg_bits)
    else:
        # real raises: a wrong length or non-binary characters would fold a
        # secret that can never be decoded back
        if len(hidinfo) != msg_bits:
            raise ValueError(f"hidinfo has {len(hidinfo)} chars, mapper "
                             f"expects {msg_bits} bits")
        if not set(hidinfo) <= {"0", "1"}:
            raise ValueError(f"hidinfo must be a 0/1 bitstring, got "
                             f"{hidinfo!r}")
        bits = np.array([int(c) for c in hidinfo])
    mapper_state = load_mapper_state(train_folder)
    mapper_bits = int(mapper_state["bit_embeddings.weight"].shape[0])
    if mapper_bits != msg_bits:
        # the reshape in mapper_diag_from_state would fold only the first
        # row of a msg_bits that is a multiple of the trained width
        raise ValueError(f"msg_bits {msg_bits} != the trained mapper's "
                         f"{mapper_bits} bits ({train_folder})")
    mapped = mapper_diag_from_state(mapper_state, bits)[0]

    out: Dict[str, torch.Tensor] = {}
    for key, w in lora.items():
        if "text_encoder" in key:
            continue                              # dropped (`:38-39`)
        if "unet" not in key:
            raise ValueError(f"key {key} not recognized")
        w = w.float().numpy()
        # exclusive branches keyed on the tensor role ("attn" also matches
        # "attentions" in proj_in/proj_out keys)
        if "up.weight" in key:
            folded = w
        elif "down.weight" in key:
            if "proj_in" in key or "proj_out" in key:
                folded = w * mapped[:, None, None, None] * scale   # conv
            else:
                folded = mapped[:, None] * w * scale           # [rank, in]
        else:
            continue
        out[key] = torch.from_numpy(np.asarray(folded, np.float32))

    bitstring = "".join(map(str, bits.tolist()))
    if save:
        d = os.path.join(train_folder, bitstring)
        os.makedirs(d, exist_ok=True)
        save_safetensors(out, os.path.join(d, LORA_FILE))
    return bitstring, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--train_folder", type=str, required=True)
    p.add_argument("--msg_bits", type=int, default=48)
    p.add_argument("--scale", type=float, default=1.03)
    p.add_argument("--hidinfo", type=str, default=None,
                   help="secret bitstring; random if omitted")
    args = p.parse_args(argv)
    bitstring, _ = create_watermark_lora(args.train_folder, args.scale,
                                         args.msg_bits, args.hidinfo)
    print(bitstring)
    return bitstring


if __name__ == "__main__":
    main()
