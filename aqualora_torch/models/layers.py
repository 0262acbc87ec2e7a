"""SD-1.5 building blocks in PyTorch (NCHW, LoRA-aware).

The port of `aqualora_tpu/models/layers.py`.  Module names are the diffusers
attribute paths, so the JAX parameter trees load with
`core.convert.jax_params_to_torch` and `load_state_dict(strict=True)`.
Traps the JAX side pinned, kept here:

- GEGLU gates with the tanh approximation of GELU, as flax `nn.gelu` does
  (diffusers uses exact GELU; see ROADMAP queue C);
- the transformer block's LayerNorms use eps 1e-5 with two-pass variance
  (torch's LayerNorm is two-pass);
- `Transformer2DModel`'s GroupNorm uses eps 1e-6; `ResnetBlock2D` takes its
  eps from the caller (1e-5 in the U-Net, 1e-6 in the VAE).

With `remat` (`UNetConfig.remat`, `--gradient_checkpointing`) each
`BasicTransformerBlock` that runs with gradients runs under
`torch.utils.checkpoint` (non-reentrant), as JAX's `nn.remat`
(`aqualora_tpu/models/layers.py:275-277`): its activations are recomputed
in the backward, the attention forward kernel included.  The recompute
runs under the LoRA dropout draws that were active in the forward
(`lora.active_dropout`), so its masks are the forward's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from aqualora_torch.core.config import LoRAConfig
from aqualora_torch.models.lora import (DiagScale, LoRAConv2d, LoRALinear,
                                        active_dropout, lora_dropout)
from aqualora_torch.ops.attention import dot_product_attention


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding),
    float32 [B, dim]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 (320 -> 1280 for SD-1.5)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv x2 with additive time embedding and 1x1 shortcut."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-5, temb_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_dim, out_channels)
                              if temb_dim else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  `pad` is ((top, bottom), (left, right)) as in the
    JAX module: ((1, 1), (1, 1)) in the U-Net, the asymmetric ((0, 1), (0,
    1)) in the VAE encoder, which is a zero pad before an unpadded conv."""

    def __init__(self, channels: int, out_channels: int,
                 pad: Tuple[Tuple[int, int], Tuple[int, int]] = ((1, 1),
                                                                (1, 1))):
        super().__init__()
        (top, bottom), (left, right) = pad
        symmetric = top == bottom == left == right
        self.pad = None if symmetric else (left, right, top, bottom)
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2,
                              padding=top if symmetric else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad is not None:
            x = F.pad(x, self.pad)
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 then 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, H*D] -> contiguous [B, H, T, D]."""
    b, s, c = t.shape
    return t.view(b, s, heads, c // heads).transpose(1, 2).contiguous()


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] -> [B, T, H*D]."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


class Attention(nn.Module):
    """Multi-head attention with LoRA on to_q / to_k / to_v / to_out.0."""

    def __init__(self, query_dim: int, heads: int,
                 cross_attention_dim: Optional[int] = None,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        ctx_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.to_q = LoRALinear(query_dim, query_dim, bias=False, lora=lora)
        self.to_k = LoRALinear(ctx_dim, query_dim, bias=False, lora=lora)
        self.to_v = LoRALinear(ctx_dim, query_dim, bias=False, lora=lora)
        self.to_out = nn.ModuleList([LoRALinear(query_dim, query_dim,
                                                lora=lora)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                scale: DiagScale = None) -> torch.Tensor:
        ctx = x if context is None else context
        head_dim = x.shape[-1] // self.heads
        q = split_heads(self.to_q(x, scale), self.heads)
        k = split_heads(self.to_k(ctx, scale), self.heads)
        v = split_heads(self.to_v(ctx, scale), self.heads)
        out = dot_product_attention(q, k, v, scale=head_dim ** -0.5)
        return self.to_out[0](merge_heads(out), scale)


class GEGLU(nn.Module):
    """proj to 2*inner, gate with tanh-approximate GELU. LoRA site
    `ff.net.0.proj`."""

    def __init__(self, dim: int, inner_dim: int,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.proj = LoRALinear(dim, inner_dim * 2, lora=lora)

    def forward(self, x: torch.Tensor, scale: DiagScale = None) -> torch.Tensor:
        h, gate = self.proj(x, scale).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU -> Linear; `net.1` holds no weights (diffusers' dropout slot)."""

    def __init__(self, dim: int, mult: int = 4,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, lora=lora),
                                  nn.Identity(),
                                  LoRALinear(dim * mult, dim, lora=lora)])

    def forward(self, x: torch.Tensor, scale: DiagScale = None) -> torch.Tensor:
        return self.net[2](self.net[0](x, scale), scale)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> ff, each pre-LayerNormed and residual."""

    def __init__(self, dim: int, heads: int, cross_attention_dim: int,
                 lora: Optional[LoRAConfig] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, lora=lora)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_attention_dim, lora=lora)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, lora=lora)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                scale: DiagScale = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), None, scale)
        x = x + self.attn2(self.norm2(x), context, scale)
        return x + self.ff(self.norm3(x), scale)


def _run_block(block: BasicTransformerBlock, draws, x, context, scale):
    with lora_dropout(draws):
        return block(x, context, scale)


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in (1x1) -> transformer blocks -> proj_out (1x1),
    plus the residual."""

    def __init__(self, channels: int, heads: int, cross_attention_dim: int,
                 num_layers: int = 1, groups: int = 32,
                 lora: Optional[LoRAConfig] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = LoRAConv2d(channels, channels, 1, lora=lora)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, cross_attention_dim,
                                   lora=lora) for _ in range(num_layers)])
        self.proj_out = LoRAConv2d(channels, channels, 1, lora=lora)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                scale: DiagScale = None) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self.proj_in(self.norm(x), scale)
        out = out.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(_run_block, block, active_dropout(), out,
                                 context, scale, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = block(out, context, scale)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(out, scale) + x
