"""Attention entry point every model of the port goes through.

`dot_product_attention(q, k, v, mask=None, scale=None)` on [B, H, T, D]
takes the implementation named by the innermost `attention_impl(impl)`
context, else by the environment variable `AQUALORA_ATTN_IMPL` (read at
each call), else `auto`, as the JAX dispatcher does
(`aqualora_tpu/ops/attention.py:88-104,134`):

- `auto` and `flash`: every unmasked call goes through the autograd
  function `flash_attention` (`FlashAttention`), which runs the Hopper
  kernels on a CUDA tensor and the plain versions on a CPU tensor.  When no
  input requires grad (serving, the PPFT teacher, the VAE) that is the
  forward kernel's single launch; when one does (the PPFT student), its
  backward is the dQ and dK/dV kernels.  That covers the U-Net's
  self-attention (T = 4096/1024/256/64 at 512 px), its cross-attention (Tk
  = 77) and the VAE mid-block (d = 512);
- `xla`: every call on `plain_attention`;
- `int8`: every unmasked call on `quant.int8_attention` (both products on
  int8 codes; `csrc/int8_attention.cu` on the card), forward-only: its
  backward raises, as JAX's custom VJP does, so an `int8` that leaks into a
  differentiated call fails there;
- `sdpa`: every unmasked call on torch's `scaled_dot_product_attention`,
  the counterpart of JAX's `jax.nn.dot_product_attention` (`:65-75`), a
  library call on both sides (the PPFT teacher's `teacher_attn_impl`);
- `bf16_scores`: JAX's serving experiment (`:32-62`), masked calls too:
  QK^T from bf16 operands stored in bf16, the scale and mask in float32,
  the row max held out of the gradient, exp, P cast to bf16 for a PV
  product accumulated in float32, divided by the float32 row sum;
- `identity`: JAX's ablation bound (`:155-170`), not an attention: the mean
  of V over the keys broadcast to [B, H, Tq, Dv], plus 1e-30 (sum q + sum
  k) so that q and k stay in the graph;
- `flash_jax`: JAX's TPU-only kernel; off a TPU JAX takes its XLA einsum
  (`:133-144,190`), and so does the port: `plain_attention`;
- masked calls stay on `plain_attention` under every implementation but
  `bf16_scores`, the counterpart of the JAX package's `_xla_attention`,
  which torch's autograd differentiates.

The order is `_dispatch_impl`'s (`:130-190`).  Under `auto` the port
departs from the JAX dispatcher on purpose: its `flash_shapes_ok` gate
(d >= 64, T >= 1024, lengths divisible by 128) was measured on a TPU
against XLA's fused attention and says nothing about an H100; the CUDA
kernel masks ragged lengths and head dims itself, so it takes every
unmasked shape.  Whether some shapes should go to another implementation
is for a later change to decide from the `kernel_ms` / `library_ms` lines
that `chip_smoke.py` prints per shape.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.nn.functional as F

from aqualora_torch.ops import quant
from aqualora_torch.ops.flash_attention import flash_attention

IMPLS = ("auto", "flash", "sdpa", "xla", "bf16_scores", "int8",
         "identity", "flash_jax")
# the innermost attention_impl context last
_IMPL_OVERRIDE: list = []


def _checked(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention implementation {impl!r}; "
                         f"the port has {IMPLS}")
    return impl


@contextlib.contextmanager
def attention_impl(impl: str):
    """Attention calls made inside the context take `impl` (one of
    `IMPLS`), before `AQUALORA_ATTN_IMPL`.  The port runs
    eagerly, so the context acts on the calls made inside it (JAX's acts on
    the calls traced inside it)."""
    _IMPL_OVERRIDE.append(_checked(impl))
    try:
        yield
    finally:
        _IMPL_OVERRIDE.pop()


def current_impl() -> str:
    """The innermost context's implementation, else the environment
    variable's, else 'auto'; a ValueError for an unknown value."""
    if _IMPL_OVERRIDE:
        return _IMPL_OVERRIDE[-1]
    return _checked(os.environ.get("AQUALORA_ATTN_IMPL", "auto"))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """float32 logits, masked to the float32 minimum where `mask` is False,
    softmax, probabilities cast to v's type, then the product with v."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def bf16_scores_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """JAX's `_bf16_scores_attention`: QK^T of bf16 operands stored in
    bf16, then float32 for the scale, the mask, the max (no gradient), exp
    and the row sum; P in bf16 times V in bf16 accumulated in float32 (the
    products of two bf16 values are exact in float32), divided by the row
    sum and cast to v's type."""
    logits = torch.matmul(q.to(torch.bfloat16),
                          k.to(torch.bfloat16).transpose(-1, -2))
    s = logits.float() * scale
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(torch.bfloat16).float(),
                       v.to(torch.bfloat16).float())
    return (out / denom).to(v.dtype)


def identity_attention(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """JAX's `identity` ablation bound: the mean of v over the keys,
    broadcast to [B, H, Tq, Dv], plus 1e-30 (sum q + sum k)."""
    keep_alive = 1e-30 * (q.sum() + k.sum())
    return v.mean(dim=2, keepdim=True).expand(
        *q.shape[:3], v.shape[-1]) + keep_alive


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over [B, H, T, D]; `mask` is boolean and
    broadcasts against [B, H, Tq, Tk] (True = attend)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    impl = current_impl()
    if impl == "sdpa" and mask is None:
        return F.scaled_dot_product_attention(q, k, v, scale=scale)
    if impl == "bf16_scores":
        return bf16_scores_attention(q, k, v, mask, scale)
    if impl == "int8" and mask is None:
        return quant.int8_attention(q, k, v, scale)
    if impl == "identity" and mask is None:
        return identity_attention(q, k, v)
    if impl in ("auto", "flash") and mask is None:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), scale)
    return plain_attention(q, k, v, mask, scale)
