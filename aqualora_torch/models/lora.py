"""LoRA layers with the per-message diagonal scale, and folding.

The port of `aqualora_tpu/models/lora.py`.  `LoRALinear` and `LoRAConv2d`
own their base weight (so the key is the diffusers one, `to_q.weight`) plus
an optional `lora.{down,up}` pair.  `DiagScale` values accepted everywhere:

  None                      -> the LoRA branch is skipped (base forward)
  float or 0-dim tensor     -> standard LoRA: base + s * up(down(h))
  [rank] or [B, rank] tensor -> diagonal modulation between down and up

Every branch is multiplied by the config's `alpha_scale`.  The LoRA
weights and the base weight take the activation's type at every call, as
flax's `dtype=` casts the kernel to the compute type, so float32 trainable
LoRA weights run under a bfloat16 U-Net (the PPFT trainer's mixed
precision), and a float32 base weight that a bfloat16 pipeline keeps for
the fold (`StableDiffusionPipeline.fold_diag`) runs in bfloat16.  The
kohya dropouts are training-only and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.core.config import LoRAConfig

DiagScale = Union[None, float, torch.Tensor]


def _is_diag(scale: DiagScale) -> bool:
    return isinstance(scale, torch.Tensor) and scale.dim() >= 1


def _apply_diag(h: torch.Tensor, scale: torch.Tensor,
                rank_dim: int) -> torch.Tensor:
    """Multiply the rank dim of `h` by a [rank] or per-sample [B, rank].
    The product is taken in the promoted type (a float32 scale on a bf16
    `h` multiplies in float32) and returned in h's, as the JAX side's
    `h * scale` is cast by the up layer."""
    shape = [1] * h.dim()
    shape[rank_dim] = scale.shape[-1]
    if scale.dim() == 2:
        shape[0] = scale.shape[0]
    return (h * scale.reshape(shape)).to(h.dtype)


def _scale_delta(h: torch.Tensor, scale: DiagScale) -> torch.Tensor:
    if isinstance(scale, torch.Tensor):
        scale = scale.to(h.dtype)
    return h * scale


class _LoRACore(nn.Module):
    """down/up linear pair over the last axis."""

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)

    def forward(self, x: torch.Tensor, scale: DiagScale) -> torch.Tensor:
        h = F.linear(x, self.down.weight.to(x.dtype))
        if _is_diag(scale):
            h = _apply_diag(h, scale, -1)
        h = F.linear(h, self.up.weight.to(x.dtype))
        return h if _is_diag(scale) else _scale_delta(h, scale)


class _LoRAConvCore(nn.Module):
    """down conv with the base geometry, 1x1 up conv (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, rank: int,
                 kernel_size: int, stride: int, padding: int):
        super().__init__()
        self.down = nn.Conv2d(in_channels, rank, kernel_size, stride, padding,
                              bias=False)
        self.up = nn.Conv2d(rank, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor, scale: DiagScale) -> torch.Tensor:
        d = self.down
        h = F.conv2d(x, d.weight.to(x.dtype), None, d.stride, d.padding)
        if _is_diag(scale):
            h = _apply_diag(h, scale, 1)
        h = F.conv2d(h, self.up.weight.to(x.dtype))
        return h if _is_diag(scale) else _scale_delta(h, scale)


def _enabled(lora: Optional[LoRAConfig]) -> bool:
    return lora is not None and lora.enabled


class LoRALinear(nn.Module):
    """Linear layer (weight [out, in]) with an optional LoRA branch."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self.lora = (_LoRACore(in_features, out_features, lora.rank)
                     if _enabled(lora) else None)
        self.alpha_scale = lora.alpha_scale if _enabled(lora) else 1.0

    def forward(self, x: torch.Tensor, scale: DiagScale = None) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype), self.bias)
        if self.lora is not None and scale is not None:
            y = y + self.alpha_scale * self.lora(x, scale)
        return y


class LoRAConv2d(nn.Module):
    """Conv layer (NCHW, weight OIHW) with an optional LoRA branch; the
    transformer blocks' proj_in / proj_out 1x1 convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 bias: bool = True, lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self.lora = (_LoRAConvCore(in_channels, out_channels, lora.rank,
                                   kernel_size, stride, padding)
                     if _enabled(lora) else None)
        self.alpha_scale = lora.alpha_scale if _enabled(lora) else 1.0

    def forward(self, x: torch.Tensor, scale: DiagScale = None) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), self.bias, self.stride,
                     self.padding)
        if self.lora is not None and scale is not None:
            y = y + self.alpha_scale * self.lora(x, scale)
        return y


def lora_sites(module: nn.Module):
    """The layers of `module` that carry a LoRA pair."""
    return [m for m in module.modules()
            if isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora is not None]


@torch.no_grad()
def fold_lora_tree(module: nn.Module, diag: torch.Tensor,
                   multiplier: float = 1.0, alpha_scale: float = 1.0) -> None:
    """Fold one message's diagonal into every LoRA layer's base weight, in
    place: W += alpha * down . diag(s) . up, computed in float32 and written
    in W's type, so the denoise loop can run the plain layers (scale=None).
    diag: [rank].  The LoRA weights stay; call
    `strip_lora_params` to free them.  In place rather than a copy: a copy
    of the SD-1.5 U-Net would double its memory for no use."""
    for m in lora_sites(module):
        s = (diag.float() * (multiplier * alpha_scale)).to(m.weight.device)
        down = m.lora.down.weight.float()
        up = m.lora.up.weight.float()
        if isinstance(m, LoRALinear):   # [out, r] . diag . [r, in]
            delta = (up * s) @ down
        else:                           # sum_r up[o, r] s[r] down[r, i, h, w]
            delta = torch.einsum("or,rihw->oihw", up[:, :, 0, 0] * s, down)
        m.weight.copy_((m.weight.float() + delta).to(m.weight.dtype))


def strip_lora_params(module: nn.Module) -> None:
    """Drop every LoRA down/up pair (after folding, scale=None never reads
    them)."""
    for m in module.modules():
        if isinstance(m, (LoRALinear, LoRAConv2d)):
            m.lora = None
