"""Image resizes, NCHW, as inside every model of the port.

- `bilinear_resize`: torch's `align_corners=False` bilinear without
  antialias, the counterpart of `aqualora_tpu/ops/resize.py:bilinear_resize`,
  which builds interpolation matrices to reproduce exactly this
  `F.interpolate` behaviour (the reference's SecretDecoder preprocess, and
  FID's resize to 299).  Its antialiased mode is not ported (no caller of
  the JAX package passes it).
- `bicubic_resize`: `jax.image.resize(..., "bicubic")`, DreamSim's
  preprocess (`aqualora_tpu/eval/dreamsim.py:160-164`).  JAX's bicubic is
  Keys' cubic with a = -0.5, and it antialiases when it shrinks: the kernel
  is stretched by the scale and its weights renormalised at the borders.
  That is `F.interpolate(mode="bicubic", antialias=True)`, which takes a =
  -0.5 too; plain `mode="bicubic"` (a = -0.75, no antialias) is 0.71 off at
  512 -> 224.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NCHW `x` to (out_h, out_w); interpolates in float32 and
    returns the input type."""
    if not x.is_floating_point():
        raise TypeError(f"bilinear_resize wants a floating dtype, got "
                        f"{x.dtype}; cast (and round) at the caller")
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    out = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.to(x.dtype)


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NCHW `x` to (out_h, out_w) as `jax.image.resize(..., "bicubic")`
    does (antialiased when shrinking); interpolates in float32 and returns
    the input type."""
    if not x.is_floating_point():
        raise TypeError(f"bicubic_resize wants a floating dtype, got "
                        f"{x.dtype}")
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    out = F.interpolate(x.float(), size=(out_h, out_w), mode="bicubic",
                        align_corners=False, antialias=True)
    return out.to(x.dtype)
