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
the fold (`StableDiffusionPipeline.fold_diag`) runs in bfloat16.

The kohya dropouts (`aqualora_tpu/models/lora.py:48-67`), training only:

- elementwise dropout (`LoRAConfig.dropout`, `--lora_dropout`): a
  Bernoulli(1 - p) mask on down(x), rescaled by 1 / (1 - p);
- module dropout (`LoRAConfig.module_dropout`, `--module_dropout`): one
  draw per site and step that removes the site's whole delta, with no
  rescale.

They act only inside `lora_dropout(draws)`, as JAX's act only when a
`lora_dropout` rng is given.  JAX draws the masks with flax's `make_rng`,
folded per module path, which torch cannot reproduce; here a step's
`SiteDraws` hold every site's keep flag and the seed of its mask (sites are
numbered by `number_sites`), so the masks are a function of the step's
draws: a transformer block recomputed under remat
(`layers.Transformer2DModel`) draws its masks again from the same seeds,
where a draw from a shared generator would silently differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Union

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


@dataclasses.dataclass
class SiteDraws:
    """One pass's dropout numbers for the LoRA sites of a model: `keep`
    [sites] bool on the device (module dropout) and `seeds` (one int a
    site, elementwise dropout), each None when that dropout is off."""

    keep: Optional[torch.Tensor] = None
    seeds: Optional[List[int]] = None


_ACTIVE: Optional[SiteDraws] = None


@contextlib.contextmanager
def lora_dropout(draws: Optional[SiteDraws]):
    """The kohya dropouts act inside this context, with `draws`."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, draws
    try:
        yield
    finally:
        _ACTIVE = prev


def active_dropout() -> Optional[SiteDraws]:
    return _ACTIVE


_GENERATORS: Dict[torch.device, torch.Generator] = {}


def _dropout(h: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """h * Bernoulli(1 - p) / (1 - p), the mask drawn from `seed` (one
    generator a device, reseeded at each site)."""
    gen = _GENERATORS.get(h.device)
    if gen is None:
        gen = _GENERATORS[h.device] = torch.Generator(device=h.device)
    gen.manual_seed(seed)
    mask = torch.empty_like(h).bernoulli_(1.0 - p, generator=gen)
    return h * mask / (1.0 - p)


class _LoRACore(nn.Module):
    """down/up linear pair over the last axis."""

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)

    def forward(self, x: torch.Tensor, scale: DiagScale,
                seed: Optional[int] = None, p: float = 0.0) -> torch.Tensor:
        h = F.linear(x, self.down.weight.to(x.dtype))
        if seed is not None:
            h = _dropout(h, p, seed)
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

    def forward(self, x: torch.Tensor, scale: DiagScale,
                seed: Optional[int] = None, p: float = 0.0) -> torch.Tensor:
        d = self.down
        h = F.conv2d(x, d.weight.to(x.dtype), None, d.stride, d.padding)
        if seed is not None:
            h = _dropout(h, p, seed)
        if _is_diag(scale):
            h = _apply_diag(h, scale, 1)
        h = F.conv2d(h, self.up.weight.to(x.dtype))
        return h if _is_diag(scale) else _scale_delta(h, scale)


def _enabled(lora: Optional[LoRAConfig]) -> bool:
    return lora is not None and lora.enabled


class _LoRASite(nn.Module):
    """What a LoRA layer adds to its base output: the delta, with the
    kohya dropouts when `lora_dropout` is active."""

    def _init_lora(self, lora: Optional[LoRAConfig]) -> None:
        on = _enabled(lora)
        self.alpha_scale = lora.alpha_scale if on else 1.0
        self.dropout = lora.dropout if on else 0.0
        self.module_dropout = lora.module_dropout if on else 0.0
        self.site = 0

    def _delta(self, x: torch.Tensor, scale: DiagScale) -> torch.Tensor:
        draws = _ACTIVE
        seed = (draws.seeds[self.site] if draws is not None
                and draws.seeds is not None and self.dropout > 0 else None)
        delta = self.lora(x, scale, seed, self.dropout)
        if (draws is not None and draws.keep is not None
                and self.module_dropout > 0):
            delta = torch.where(draws.keep[self.site], delta,
                                torch.zeros_like(delta))
        return self.alpha_scale * delta


class LoRALinear(_LoRASite):
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
        self._init_lora(lora)

    def forward(self, x: torch.Tensor, scale: DiagScale = None) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype), self.bias)
        if self.lora is not None and scale is not None:
            y = y + self._delta(x, scale)
        return y


class LoRAConv2d(_LoRASite):
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
        self._init_lora(lora)

    def forward(self, x: torch.Tensor, scale: DiagScale = None) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), self.bias, self.stride,
                     self.padding)
        if self.lora is not None and scale is not None:
            y = y + self._delta(x, scale)
        return y


def lora_sites(module: nn.Module):
    """The layers of `module` that carry a LoRA pair."""
    return [m for m in module.modules()
            if isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora is not None]


def number_sites(module: nn.Module) -> int:
    """Number the LoRA sites of `module` 0, 1, ... in `lora_sites` order
    (their index into `SiteDraws`); -> the count."""
    sites = lora_sites(module)
    for i, m in enumerate(sites):
        m.site = i
    return len(sites)


@torch.no_grad()
def fold_lora_tree(module: nn.Module, diag: torch.Tensor,
                   multiplier: float = 1.0, alpha_scale: float = 1.0) -> None:
    """Fold one message's diagonal into every LoRA layer's base weight, in
    place: W += alpha * down . diag(s) . up, added in float32 and written
    in W's type, so the denoise loop can run the plain layers (scale=None).
    diag: [rank].  The delta's sum over the rank runs in float64 and is
    rounded to float32 once, so it does not depend on the device's or the
    library's order of summation: `tools/merge_lora.py` computes the same
    float32 delta on the host, and a single file merged there gives the
    folded weights bit for bit.  The LoRA weights stay; call
    `strip_lora_params` to free them.  In place rather than a copy: a copy
    of the SD-1.5 U-Net would double its memory for no use."""
    for m in lora_sites(module):
        s = (diag.float() * (multiplier * alpha_scale)).to(
            m.weight.device).double()
        down = m.lora.down.weight.double()
        up = m.lora.up.weight.double()
        if isinstance(m, LoRALinear):   # [out, r] . diag . [r, in]
            delta = (up * s) @ down
        else:                           # sum_r up[o, r] s[r] down[r, i, h, w]
            delta = torch.einsum("or,rihw->oihw", up[:, :, 0, 0] * s, down)
        m.weight.copy_((m.weight.float() + delta.float()).to(m.weight.dtype))


def strip_lora_params(module: nn.Module) -> None:
    """Drop every LoRA down/up pair (after folding, scale=None never reads
    them)."""
    for m in module.modules():
        if isinstance(m, (LoRALinear, LoRAConv2d)):
            m.lora = None
