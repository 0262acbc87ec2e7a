"""CLIP text encoder (the SD-1.5 text tower) in PyTorch.

The port of `aqualora_tpu/models/clip.py`: a causal-masked pre-LN
transformer with quick-GELU MLPs (GELU, tanh-approximate as in flax, for
the SD-2 tower), returning the last hidden state or, for SD-2, the
penultimate one.  The causal mask sends its attention to the plain path.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.core.config import CLIPTextConfig
from aqualora_torch.models.layers import merge_heads, split_heads
from aqualora_torch.models.lora import LoRALinear, number_sites
from aqualora_torch.ops.attention import dot_product_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = LoRALinear(c, c, lora=cfg.lora)
        self.k_proj = LoRALinear(c, c, lora=cfg.lora)
        self.v_proj = LoRALinear(c, c, lora=cfg.lora)
        self.out_proj = LoRALinear(c, c, lora=cfg.lora)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                lora_scale=None) -> torch.Tensor:
        head_dim = x.shape[-1] // self.heads
        q = split_heads(self.q_proj(x, lora_scale), self.heads)
        k = split_heads(self.k_proj(x, lora_scale), self.heads)
        v = split_heads(self.v_proj(x, lora_scale), self.heads)
        out = dot_product_attention(q, k, v, mask=mask, scale=head_dim ** -0.5)
        return self.out_proj(merge_heads(out), lora_scale)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.quick = cfg.hidden_act == "quick_gelu"
        self.fc1 = LoRALinear(cfg.hidden_size, cfg.intermediate_size,
                              lora=cfg.lora)
        self.fc2 = LoRALinear(cfg.intermediate_size, cfg.hidden_size,
                              lora=cfg.lora)

    def forward(self, x: torch.Tensor, lora_scale=None) -> torch.Tensor:
        h = self.fc1(x, lora_scale)
        h = quick_gelu(h) if self.quick else F.gelu(h, approximate="tanh")
        return self.fc2(h, lora_scale)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                lora_scale=None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask, lora_scale)
        return x + self.mlp(self.layer_norm2(x), lora_scale)


class CLIPTextModel(nn.Module):
    """forward(input_ids [B, 77]) -> hidden states [B, 77, hidden]."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.num_sites = number_sites(self)

    def forward(self, input_ids: torch.Tensor, lora_scale=None) -> torch.Tensor:
        t = input_ids.shape[1]
        pos = torch.arange(t, device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=input_ids.device).tril()[None, None]
        penult = None
        for i, layer in enumerate(self.layers):
            if self.cfg.penultimate and i == len(self.layers) - 1:
                penult = x
            x = layer(x, causal, lora_scale)
        return self.final_layer_norm(penult if self.cfg.penultimate else x)
