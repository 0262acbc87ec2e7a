"""SecretEncoder, SecretDecoder and MapperNet in PyTorch.

The port of `aqualora_tpu/models/watermark.py:42-119`:

  SecretEncoder: message bits [B, bits] -> additive latent watermark:
    Linear(bits -> base^2) -> SiLU -> [B, 1, base, base] repeated to the
    latent's channels -> nearest x(resolution / base) -> zero-init 3x3 conv;
    `forward(x, msg)` bilinearly resizes it to x's size and returns
    (x + c, c).  At a latent of side 2 * base the PPFT trainer takes the
    fused kernel instead (`ops/secret_inject.py`).

  SecretDecoder: image NCHW in [-1, 1] -> per-bit 2-way logits
    [B, bits, 2]: bilinear resize to the backbone's resolution, then
    EfficientNet-B1 with a Linear(-> bits * 2) head.  `forward(x, train)`
    is flax's `train` argument: with train=True BatchNorm takes the batch's
    statistics and updates its running ones (flax's rule, see
    `models/efficientnet.py`), and stochastic depth and dropout apply the
    given masks; the module's `training` flag plays no part.
  MapperNet: message bits [B, bits] -> diagonal LoRA scale [B, rank]:
    sum of the message-selected rows of `bit_embeddings` / sqrt(bits) + 1.
    `std` is baked into the weight at init, never a forward multiplier.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.core.config import EfficientNetConfig
from aqualora_torch.models.efficientnet import EfficientNet, Masks
from aqualora_torch.ops.resize import bilinear_resize


class SecretEncoder(nn.Module):
    """Runs in its weights' type; `secret_dense` and `conv_out` are the JAX
    module's names."""

    def __init__(self, secret_len: int, base_res: int = 32,
                 resolution: int = 64, latent_channels: int = 4):
        super().__init__()
        self.base_res = base_res
        self.resolution = resolution
        self.latent_channels = latent_channels
        self.secret_dense = nn.Linear(secret_len, base_res * base_res)
        self.conv_out = nn.Conv2d(latent_channels, latent_channels, 3,
                                  padding=1)
        # zero-init conv: training starts from an identity injection
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def encode(self, msg: torch.Tensor) -> torch.Tensor:
        """msg [B, bits] -> watermark [B, C, resolution, resolution]."""
        w = self.secret_dense.weight
        h = F.silu(self.secret_dense(msg.to(w.dtype)))
        b, r = h.shape[0], self.base_res
        h = h.reshape(b, 1, r, r).expand(b, self.latent_channels, r, r)
        factor = self.resolution // r
        if factor > 1:
            h = F.interpolate(h, scale_factor=float(factor), mode="nearest")
        return self.conv_out(h)

    def forward(self, x: torch.Tensor, msg: torch.Tensor):
        c = bilinear_resize(self.encode(msg), x.shape[2], x.shape[3])
        return x + c, c


class SecretDecoder(nn.Module):
    """Built on `device` ("cuda" unless the caller asks for the CPU) in
    `dtype`; `decode_bits` runs wherever the decoder lies."""

    def __init__(self, output_size: int = 48,
                 backbone: Optional[EfficientNetConfig] = None,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = backbone or EfficientNetConfig.b1()
        self.output_size = output_size
        self.resolution = cfg.decoder_resolution
        with torch.device(device):
            self.model = EfficientNet(dataclasses.replace(
                cfg, num_classes=output_size * 2))
        self.to(dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: Optional[Masks] = None) -> torch.Tensor:
        """`train` is flax's argument; a train-mode call takes the keep
        masks drawn by `self.model.draw_masks`."""
        x = bilinear_resize(x, self.resolution, self.resolution)
        return self.model(x, train, masks).reshape(-1, self.output_size, 2)


class MapperNet(nn.Module):
    def __init__(self, input_size: int = 48, output_size: int = 320,
                 std: float = 1.0):
        super().__init__()
        self.input_size = input_size
        self.std = std
        self.bit_embeddings = nn.Embedding(input_size, output_size)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """Orthogonal rows, each scaled to unit (Bessel-corrected) std, times
        `std` (the reference's init)."""
        w = self.bit_embeddings.weight
        if w.is_meta:
            return
        q = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        nn.init.orthogonal_(q)
        q = q / q.std(dim=1, keepdim=True, unbiased=True)
        w.copy_(q * self.std)

    def forward(self, msg: torch.Tensor) -> torch.Tensor:
        """-> float32 [B, rank], computed in the weight's type."""
        emb = self.bit_embeddings.weight
        return (msg.to(emb.dtype) @ emb / math.sqrt(self.input_size)
                + 1.0).float()
