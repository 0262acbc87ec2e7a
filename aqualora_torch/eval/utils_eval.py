"""Bit read-back and the detection math, on tensors.

The subset of `aqualora_tpu/eval/utils_eval.py` that the main path needs:
the binomial FPR threshold (`:40-50`), the decoder's bits and logit margins
(the inner `decode`, `:399-407`) and the bit-accuracy / TPR rule
(`:448-461`).  PIL file loading and the evaluation runners are not ported
yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def calculate_fpr(tau: int, k: int) -> float:
    """P[#matching bits > tau] for a random message: binomial tail / 2^k."""
    total = sum(math.comb(k, i) for i in range(tau + 1, k + 1))
    return total / (2 ** k)


def get_threshold(k: int, fpr: float) -> int:
    tau = 0
    while calculate_fpr(tau, k) > fpr:
        tau += 1
    return tau


@torch.no_grad()
def decode_bits(decoder: torch.nn.Module,
                images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images NHWC in [-1, 1] -> (bits [B, n] int64, margins [B, n] float32).
    The margin is logit_1 - logit_0; the bit is its argmax (1 iff the
    margin is positive)."""
    weight = next(decoder.parameters())
    x = images.permute(0, 3, 1, 2).to(weight.device, weight.dtype)
    logits = decoder(x)
    margins = (logits[..., 1] - logits[..., 0]).float()
    return logits.argmax(dim=-1), margins


def score_bits(bits: torch.Tensor, msg_gt: str,
               fpr: float = 1e-3) -> Tuple[float, float]:
    """(bit accuracy, TPR) of decoded bits [B, n] against the bit string
    `msg_gt`.  An image counts as detected when its accuracy reaches
    tau / n, with tau the binomial threshold at `fpr`."""
    n = bits.shape[1]
    if len(msg_gt) != n:
        raise ValueError(f"msg_gt has {len(msg_gt)} bits, decoder "
                         f"extracts {n}")
    tau = get_threshold(n, fpr) / n
    gt = torch.tensor([int(c) for c in msg_gt], device=bits.device)
    acc = (bits == gt).float().mean(dim=1)
    return float(acc.mean()), float((acc >= tau).float().mean())
