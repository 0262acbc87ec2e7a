"""Stage-1 training losses, NCHW.

The port of `aqualora_tpu/train/losses.py:12-37`:

- `prvl_loss`: the Peak Regional Visual Loss, the largest 32x32 box mean of
  the channel-mean absolute difference.  The box slides with padding 16 on
  every side, so an H x W image gives an (H + 1) x (W + 1) map, and the
  padded zeros count in each mean (the JAX package's convolution with a
  constant kernel; `count_include_pad=True` here).  The max is taken over
  the whole batch.
- `message_bce`: binary cross-entropy between per-bit 2-way logits and the
  one-hot bits, taken in float32 whatever the logits' type.
- `bit_accuracy`: the fraction of bits whose larger logit is the right one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRVL_WINDOW = 32


def prvl_loss(img1: torch.Tensor, img2: torch.Tensor,
              window: int = PRVL_WINDOW) -> torch.Tensor:
    """img1, img2 [B, C, H, W] -> a scalar."""
    diff = (img1 - img2).abs().mean(dim=1, keepdim=True)
    pooled = F.avg_pool2d(diff, window, stride=1, padding=window // 2,
                          count_include_pad=True)
    return pooled.max()


def message_bce(logits: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """logits [B, N, 2], msg [B, N] of 0/1 -> the mean BCE with logits."""
    labels = F.one_hot(msg.long(), 2).float()
    return F.binary_cross_entropy_with_logits(logits.float(), labels)


def bit_accuracy(logits: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """The fraction of correctly decoded bits, float32."""
    return (logits.argmax(dim=-1) == msg.long()).float().mean()
