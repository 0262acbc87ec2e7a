"""The DINO-layout ViT, the backbone family of the DreamSim metric, NCHW in.

The port of `aqualora_tpu/models/vit.py`, laid out as the DINO
VisionTransformer the reference's checkpoints use (`patch_embed.proj`,
`cls_token`, `pos_embed`, `pos_drop`, `blocks.N.{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2}`, `norm`, and the CLIP variants'
`proj`), so that `tools/torch_import.py` loads a published state dict with
`load_state_dict(strict=True)` and no transposes.  The CLIP variants differ
from DINO's topology by a LayerNorm in `pos_drop`'s slot (`pre_norm`),
QuickGELU (`quick_gelu`), LayerNorm eps 1e-5 and a final [dim, proj_dim]
projection of the cls token (`proj_dim`).

Feature taps (`aqualora_tpu/models/vit.py:111-128`):
  - 'cls'       : the cls token of block 11's output, before the final
                  norm: the reference hooks `blocks[11]` for every depth, an
                  inner block of the 24- and 32-deep MAE models;
  - 'last_layer': the cls token after the final norm;
  - 'tokens'    : the other tokens after the final norm;
  - 'embedding' : 'last_layer' @ proj.

Attention goes through `ops.attention.dot_product_attention` (the forward
kernel on a CUDA tensor, its plain version on a CPU one).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.models.clip import quick_gelu
from aqualora_torch.ops.attention import dot_product_attention

CLS_TAP_BLOCK = 11


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        head_dim = c // self.heads
        q, k, v = (s.reshape(b, t, self.heads, head_dim).transpose(1, 2)
                   for s in self.qkv(x).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, scale=head_dim ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, quick: bool):
        super().__init__()
        self.quick = quick
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = quick_gelu(h) if self.quick else F.gelu(h)     # exact (erf)
        return self.fc2(h)


class ViTBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int = 768, heads: int = 12, mlp_ratio: int = 4,
                 quick_gelu: bool = False, ln_eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, dim * mlp_ratio, quick_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)       # [B, T, dim]


class ViTB16(nn.Module):
    """forward(images NCHW) -> {'cls', 'last_layer', 'tokens' and, when
    proj_dim > 0, 'embedding'} (see the module docstring)."""

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 patch: int = 16, image_size: int = 224,
                 pre_norm: bool = False, quick_gelu: bool = False,
                 ln_eps: float = 1e-6, proj_dim: int = 0):
        super().__init__()
        self.dim, self.depth, self.proj_dim = dim, depth, proj_dim
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (image_size // patch) ** 2 + 1, dim))
        # CLIP's ln_pre in pos_drop's slot; DINO's pos_drop is a dropout,
        # the identity in eval
        self.pos_drop = (nn.LayerNorm(dim, eps=ln_eps) if pre_norm
                         else nn.Identity())
        self.blocks = nn.ModuleList(
            ViTBlock(dim, heads, quick_gelu=quick_gelu, ln_eps=ln_eps)
            for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=ln_eps)
        if proj_dim:
            self.proj = nn.Parameter(torch.zeros(dim, proj_dim))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = self.pos_drop(torch.cat([cls, x], 1) + self.pos_embed)
        cls_tap = None
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i == CLS_TAP_BLOCK:
                cls_tap = x[:, 0]
        out = {"cls": cls_tap if cls_tap is not None else x[:, 0]}
        x = self.norm(x)
        out["last_layer"] = x[:, 0]
        out["tokens"] = x[:, 1:]
        if self.proj_dim:
            out["embedding"] = x[:, 0] @ self.proj
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights, flax's initialisers in shape: dense and
        patch kernels N(0, 1 / fan_in), biases 0, LayerNorms the identity,
        cls_token 0, pos_embed and proj N(0, 0.02^2)."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls_token.zero_()
        normal(self.pos_embed, 0.02)
        if self.proj_dim:
            normal(self.proj, 0.02)


class DreamSimMLP(nn.Module):
    """The residual MLP head of DreamSim's non-LoRA configurations
    (`aqualora_tpu/models/vit.py:132-143`); the LoRA ensemble has none."""

    def __init__(self, in_features: int, hidden_size: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_size)
        self.fc2 = nn.Linear(hidden_size, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x))) + x
