"""Bilinear resize with torch `align_corners=False` semantics, no antialias.

The counterpart of `aqualora_tpu/ops/resize.py:bilinear_resize`, which builds
interpolation matrices to reproduce exactly this `F.interpolate` behaviour
(what the reference's SecretDecoder preprocess does).  NCHW here, as inside
every model of the port; the antialiased mode (train-time distortions) is
not ported yet.
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
