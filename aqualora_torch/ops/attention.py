"""Attention entry point every model of the port goes through.

`dot_product_attention(q, k, v, mask=None, scale=None)` on [B, H, T, D]:

- every unmasked call goes through the autograd function `flash_attention`
  (`FlashAttention`), which runs the Hopper kernels on a CUDA tensor and
  the plain versions on a CPU tensor.  When no input requires grad (serving,
  the PPFT teacher, the VAE) that is the forward kernel's single launch, as
  before; when one does (the PPFT student), its backward is the dQ and
  dK/dV kernels.  That covers the U-Net's self-attention (T =
  4096/1024/256/64 at 512 px), its cross-attention (Tk = 77) and the VAE
  mid-block (d = 512, forward only);
- masked calls (CLIP's causal mask) stay on `plain_attention`, the
  counterpart of the JAX package's `_xla_attention`, which torch's autograd
  differentiates.  The JAX package also keeps masked attention off its
  Pallas kernels.

This deliberately departs from the JAX dispatcher.  Its `flash_shapes_ok`
gate (d >= 64, T >= 1024, lengths divisible by 128) and its dispatch
cut-offs were measured on a TPU against XLA's fused attention and say
nothing about an H100; the CUDA kernel masks ragged lengths and head dims
itself, so it takes every unmasked shape.  Whether some shapes should go to
another implementation is for a later change to decide from the
`kernel_ms` / `library_ms` lines that `chip_smoke.py` prints per shape.
The TPU experiment implementations (bf16 scores, int8, identity, the
jax-shipped flash kernel) and their environment switch are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from aqualora_torch.ops.flash_attention import flash_attention


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """float32 logits, masked to the float32 minimum where `mask` is False,
    softmax, probabilities cast to v's type, then the product with v."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over [B, H, T, D]; `mask` is boolean and
    broadcasts against [B, H, Tq, Tk] (True = attend)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is not None:
        return plain_attention(q, k, v, mask, scale)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale)
