"""SD-1.5 UNet2DConditionModel in PyTorch with the watermark LoRA.

The port of `aqualora_tpu/models/unet.py`: `unet(sample, timesteps,
context, scale)` with NCHW samples; the diagonal message scale is an
explicit argument threaded to every LoRA site (None after folding).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.core.config import UNetConfig
from aqualora_torch.models.lora import DiagScale, number_sites
from aqualora_torch.models.layers import (Downsample2D, ResnetBlock2D,
                                          TimestepEmbedding,
                                          Transformer2DModel, Upsample2D,
                                          timestep_embedding)


def _transformer(cfg: UNetConfig, channels: int) -> Transformer2DModel:
    return Transformer2DModel(channels, cfg.heads_for(channels),
                              cfg.cross_attention_dim,
                              groups=cfg.norm_num_groups, lora=cfg.lora,
                              remat=cfg.remat)


class DownBlock2D(nn.Module):
    """Resnets (+ transformers when `attn`) and an optional downsampler."""

    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int,
                 attn: bool, add_downsample: bool):
        super().__init__()
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, cfg.norm_num_groups, temb_dim=temb)
            for i in range(cfg.layers_per_block)])
        self.attentions = (nn.ModuleList([
            _transformer(cfg, out_channels)
            for _ in range(cfg.layers_per_block)]) if attn else None)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels,
                                                         out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context, scale: DiagScale):
        residuals: List[torch.Tensor] = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context, scale)
            residuals.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            residuals.append(x)
        return x, residuals


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, cfg.norm_num_groups,
                          temb_dim=temb) for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, channels)])

    def forward(self, x, temb, context, scale: DiagScale):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context, scale)
        return self.resnets[1](x, temb)


class UpBlock2D(nn.Module):
    """Concatenate a skip, resnet (+ transformer when `attn`), repeated
    layers_per_block + 1 times, then an optional upsampler."""

    def __init__(self, cfg: UNetConfig, prev_channels: int, out_channels: int,
                 skip_in_channels: int, attn: bool, add_upsample: bool):
        super().__init__()
        n = cfg.layers_per_block + 1
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock2D(
                (prev_channels if i == 0 else out_channels)
                + (skip_in_channels if i == n - 1 else out_channels),
                out_channels, cfg.norm_num_groups, temb_dim=temb)
            for i in range(n)])
        self.attentions = (nn.ModuleList([
            _transformer(cfg, out_channels) for _ in range(n)])
            if attn else None)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels,
                                                     out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples: List[torch.Tensor], temb, context,
                scale: DiagScale):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context, scale)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet2DConditionModel(nn.Module):
    """forward(sample NCHW, timesteps [B] or scalar, context [B, 77, C],
    scale) -> float32 prediction NCHW."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        n = len(ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        self.down_blocks = nn.ModuleList([
            DownBlock2D(cfg, ch[i - 1] if i else ch[0], ch[i],
                        cfg.attn_down_blocks[i], add_downsample=i < n - 1)
            for i in range(n)])
        self.mid_block = UNetMidBlock2DCrossAttn(cfg, ch[-1])
        rev = tuple(reversed(ch))
        self.up_blocks = nn.ModuleList([
            UpBlock2D(cfg, rev[i - 1] if i else rev[0], rev[i],
                      rev[min(i + 1, n - 1)], cfg.attn_up_blocks[i],
                      add_upsample=i < n - 1)
            for i in range(n)])
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.num_sites = number_sites(self)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                scale: DiagScale = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype))
        res_samples = [x]
        for block in self.down_blocks:
            x, res = block(x, temb, context, scale)
            res_samples.extend(res)
        x = self.mid_block(x, temb, context, scale)
        for block in self.up_blocks:
            x = block(x, res_samples, temb, context, scale)
        x = F.silu(self.conv_norm_out(x))
        # the output conv runs in float32, like the JAX model's
        return F.conv2d(x.float(), self.conv_out.weight.float(),
                        self.conv_out.bias.float(), padding=1)
