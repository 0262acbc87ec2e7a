"""SecretDecoder and MapperNet in PyTorch.

The port of `aqualora_tpu/models/watermark.py:74-119`:

  SecretDecoder: image NCHW in [-1, 1] -> per-bit 2-way logits
    [B, bits, 2]: bilinear resize to the backbone's resolution, then
    EfficientNet-B1 with a Linear(-> bits * 2) head.
  MapperNet: message bits [B, bits] -> diagonal LoRA scale [B, rank]:
    sum of the message-selected rows of `bit_embeddings` / sqrt(bits) + 1.
    `std` is baked into the weight at init, never a forward multiplier.

The SecretEncoder is training-side and is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from aqualora_torch.core.config import EfficientNetConfig
from aqualora_torch.models.efficientnet import EfficientNet
from aqualora_torch.ops.resize import bilinear_resize


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = bilinear_resize(x, self.resolution, self.resolution)
        return self.model(x).reshape(-1, self.output_size, 2)


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
