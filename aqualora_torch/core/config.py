"""Typed configuration for every model in the port.

A copy of `aqualora_tpu/core/config.py` (the dataclasses and the `sd15`,
`sd21` and `tiny` presets).  The port keeps its own copy because
importing anything under `aqualora_tpu.core` pulls in JAX; a test holds
every preset equal to the original field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text encoder (the SD-1.5 text tower)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    # quick_gelu for OpenAI CLIP; SD2's OpenCLIP uses plain gelu.
    hidden_act: str = "quick_gelu"
    # SD2 conditions on the penultimate layer (clip_skip=2 equivalent)
    penultimate: bool = False
    # text-encoder LoRA on the attention projections — the reference's
    # CustomLoraLoaderMixin._modify_text_encoder (utils/lora_modules.py:65-146)
    lora: "LoRAConfig" = None  # set post-definition; None => disabled

    def with_lora(self, rank: int = 4):
        return dataclasses.replace(self, lora=LoRAConfig(rank=rank,
                                                         enabled=True))

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sd2() -> "CLIPTextConfig":
        """OpenCLIP ViT-H text tower (stable-diffusion-2-1)."""
        return CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                              num_layers=23, num_heads=16,
                              hidden_act="gelu", penultimate=True)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1000, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_position_embeddings=77,
        )


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL as used by SD-1.5 (8x spatial compression, 4 latent ch)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    # `vae.config.scaling_factor` — applied to latents before the U-Net
    # (reference: train/ppft_train.py:997 multiplies by it).
    scaling_factor: float = 0.18215

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_num_groups=8)


@dataclass(frozen=True)
class LoRAConfig:
    """First-class functional LoRA over the U-Net's transformer modules.

    The reference injects rank-`rank` LoRA into the 192 modules listed in
    `utils/unet_keys.json` (proj_in/proj_out 1x1 convs + attn q/k/v/out +
    ff in/out of all 16 transformer blocks) at `train/ppft_train.py:620-678`,
    and monkey-patches the forwards so a *tensor* `scale` is applied as a
    diagonal matrix between down and up (`utils/lora_modules.py:9-44`).

    Here LoRA is a separate parameter collection threaded functionally:
    `h -> h + (alpha/rank) * (down(h) * diag_scale) @ up`.
    """

    rank: int = 320           # train/README.md:47
    network_alpha: float | None = None  # None => alpha == rank (scale 1)
    enabled: bool = True
    # kohya LoRANetwork dropouts (lib/lora.py:96-112), active only when a
    # 'lora_dropout' rng is supplied at apply time (i.e. training):
    dropout: float = 0.0         # elementwise on down(x), 1/(1-p) rescale
    module_dropout: float = 0.0  # whole-module Bernoulli, no rescale

    @property
    def alpha_scale(self) -> float:
        if self.network_alpha is None:
            return 1.0
        return self.network_alpha / self.rank


@dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 UNet2DConditionModel topology."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # diffusers' SD-1.5 sets attention_head_dim=8 which (by diffusers quirk)
    # is the *number of heads*; head size = channels // num_heads.
    num_attention_heads: int = 8
    # SD-2.x instead fixes the head *size* (64); when set, the head count
    # is channels // head_dim per block and num_attention_heads is ignored.
    head_dim: int | None = None
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    # which down blocks carry cross-attention transformers (last is plain)
    attn_down_blocks: Tuple[bool, ...] = (True, True, True, False)
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True
    # "epsilon" (SD-1.5) or "v_prediction" (SD-2.x): reference supports both
    # via velocity_to_eplison (utils/cschedulers.py:56-72).
    prediction_type: str = "epsilon"
    # gradient checkpointing: remat the transformer blocks
    # (reference --gradient_checkpointing, ppft_train.py:602-605)
    remat: bool = False
    lora: LoRAConfig = field(default_factory=lambda: LoRAConfig(enabled=False))

    @property
    def attn_up_blocks(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.attn_down_blocks))

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def with_lora(self, rank: int = 320, network_alpha: float | None = None) -> "UNetConfig":
        return dataclasses.replace(
            self, lora=LoRAConfig(rank=rank, network_alpha=network_alpha, enabled=True))

    def heads_for(self, channels: int) -> int:
        if self.head_dim:
            return max(1, channels // self.head_dim)
        return self.num_attention_heads

    @staticmethod
    def sd15(lora_rank: int | None = None) -> "UNetConfig":
        cfg = UNetConfig()
        if lora_rank:
            cfg = cfg.with_lora(lora_rank)
        return cfg

    @staticmethod
    def sd21(lora_rank: int | None = None) -> "UNetConfig":
        """stable-diffusion-2-1: 64-dim heads, 1024 cross dim, v-pred."""
        cfg = UNetConfig(head_dim=64, cross_attention_dim=1024,
                         prediction_type="v_prediction")
        if lora_rank:
            cfg = cfg.with_lora(lora_rank)
        return cfg

    @staticmethod
    def tiny(lora_rank: int | None = 4, cross_attention_dim: int = 32) -> "UNetConfig":
        cfg = UNetConfig(
            block_out_channels=(32, 64), layers_per_block=1,
            num_attention_heads=2, cross_attention_dim=cross_attention_dim,
            norm_num_groups=8, attn_down_blocks=(True, False),
        )
        if lora_rank:
            cfg = cfg.with_lora(lora_rank)
        return cfg


@dataclass(frozen=True)
class WatermarkConfig:
    """Watermark subsystem constants (reference `utils/models.py`)."""

    msg_bits: int = 48              # train/README.md:48,76
    lora_rank: int = 320            # mapper output size; train/README.md:47
    mapper_std: float = 1.0         # MapperNet std arg, utils/models.py:100
    # SecretEncoder internal grid: Linear(bits -> 32*32), utils/models.py:57
    secret_grid: int = 32
    # inference-time LoRA multiplier (scripts/create_wm_lora.py:58)
    inference_scale: float = 1.03

    @staticmethod
    def tiny() -> "WatermarkConfig":
        return WatermarkConfig(msg_bits=8, lora_rank=4, secret_grid=8)


@dataclass(frozen=True)
class EfficientNetConfig:
    """EfficientNet-B1 (the SecretDecoder backbone, utils/models.py:87-89)."""

    width_mult: float = 1.0
    depth_mult: float = 1.1
    dropout_rate: float = 0.2
    num_classes: int = 1000
    # decoder resizes input to 512x512 (utils/models.py:92-94)
    decoder_resolution: int = 512

    @staticmethod
    def b1(num_classes: int = 1000) -> "EfficientNetConfig":
        return EfficientNetConfig(num_classes=num_classes)

    @staticmethod
    def tiny(num_classes: int = 16) -> "EfficientNetConfig":
        return EfficientNetConfig(width_mult=0.1, depth_mult=0.1,
                                  num_classes=num_classes, decoder_resolution=64)


@dataclass(frozen=True)
class ScheduleConfig:
    """DDPM beta schedule — SD-1.5 scaled_linear defaults."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear", "squaredcos_cap_v2"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    # classic DDPM "linear" range, used by the generic scheduler tests
    @staticmethod
    def sd15() -> "ScheduleConfig":
        return ScheduleConfig()


@dataclass(frozen=True)
class PipelineConfig:
    """Bundle for the full text->image stack."""

    clip: CLIPTextConfig = field(default_factory=CLIPTextConfig.sd15)
    vae: VAEConfig = field(default_factory=VAEConfig.sd15)
    unet: UNetConfig = field(default_factory=UNetConfig.sd15)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig.sd15)
    watermark: WatermarkConfig = field(default_factory=WatermarkConfig)

    @staticmethod
    def sd15(lora_rank: int | None = None) -> "PipelineConfig":
        return PipelineConfig(unet=UNetConfig.sd15(lora_rank))

    @staticmethod
    def sd21(lora_rank: int | None = None) -> "PipelineConfig":
        """stable-diffusion-2-1 (768px, v-prediction) — the reference's SD2
        path via velocity_to_eplison (cschedulers.py:56-72)."""
        return PipelineConfig(
            clip=CLIPTextConfig.sd2(), unet=UNetConfig.sd21(lora_rank),
            schedule=ScheduleConfig(prediction_type="v_prediction"))

    @staticmethod
    def tiny() -> "PipelineConfig":
        wm = WatermarkConfig.tiny()
        return PipelineConfig(
            clip=CLIPTextConfig.tiny(), vae=VAEConfig.tiny(),
            unet=UNetConfig.tiny(lora_rank=wm.lora_rank),
            watermark=wm,
        )
