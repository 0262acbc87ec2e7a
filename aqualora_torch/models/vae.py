"""AutoencoderKL (the SD-1.5 VAE) in PyTorch, NCHW.

The port of `aqualora_tpu/models/vae.py`: the encoder, `quant_conv` and the
diagonal Gaussian posterior (`encode_moments`, `sample_from_moments`,
`sample`, `encode`), and `post_quant_conv` then the decoder.  Both halves
hold the single-head mid-block attention (d = 512, T = 4096 at 512 px),
which goes through the flash-attention forward kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.core.config import VAEConfig
from aqualora_torch.models.layers import (Downsample2D, ResnetBlock2D,
                                          Upsample2D)
from aqualora_torch.ops.attention import dot_product_attention

# diffusers builds every VAE resnet with eps 1e-6 (the U-Net's is 1e-5)
_EPS = 1e-6


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=_EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self.group_norm(x).flatten(2).transpose(1, 2)   # [B, HW, C]
        q, k, v = (proj(out)[:, None] for proj in
                   (self.to_q, self.to_k, self.to_v))
        out = dot_product_attention(q, k, v, scale=c ** -0.5)[:, 0]
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, groups, eps=_EPS)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 groups: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels,
                          out_channels, groups, eps=_EPS)
            for j in range(num_layers)])
        # the encoder's downsampler pads bottom/right only (diffusers)
        self.downsamplers = (nn.ModuleList([Downsample2D(
            out_channels, out_channels, pad=((0, 1), (0, 1)))])
            if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 groups: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels,
                          out_channels, groups, eps=_EPS)
            for j in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels,
                                                     out_channels)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(chans[i - 1] if i else chans[0], ch,
                               cfg.layers_per_block, g,
                               add_downsample=i < len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=_EPS)
        # unlike the decoder's, the encoder's output conv runs in the model
        # type, as in the JAX model
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = tuple(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(chans[i - 1] if i else chans[0], ch,
                             cfg.layers_per_block + 1, g,
                             add_upsample=i < len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=_EPS)
        self.conv_out = nn.Conv2d(chans[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        x = F.silu(self.conv_norm_out(x))
        # the output conv runs in float32, like the JAX model's
        return F.conv2d(x.float(), self.conv_out.weight.float(),
                        self.conv_out.bias.float(), padding=1)


class AutoencoderKL(nn.Module):
    """`encode_moments` / `sample_from_moments` / `sample` / `encode` on
    images NCHW in [-1, 1], `decode(z NCHW) -> image NCHW` (float32)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mean, logvar) of the diagonal Gaussian posterior, in the
        model's type; logvar clipped to [-30, 20]."""
        x = x.to(self.quant_conv.weight.dtype)
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    @staticmethod
    def sample_from_moments(mean: torch.Tensor, logvar: torch.Tensor,
                            noise: torch.Tensor) -> torch.Tensor:
        """`mean + std * noise`, the one home of the posterior sampling
        formula."""
        return mean + torch.exp(0.5 * logvar) * noise

    def sample(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A posterior sample (the reference's `.latent_dist.sample()`),
        its noise drawn from `generator` in the model's type."""
        mean, logvar = self.encode_moments(x)
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        return self.sample_from_moments(mean, logvar, noise)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior mode (deterministic encode)."""
        return self.encode_moments(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
