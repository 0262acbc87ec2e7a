"""Random-weight artifacts in the reference's exact file formats.

The port of `aqualora_tpu/tools/synthetic_artifacts.py`.  The golden gate
(`tools/golden_gate.py`) and its tests use them to drive the whole port ->
fold -> generate -> decode protocol without the published checkpoints.
Written under `out_dir` (the LoRA triple in `out_dir/ppft_trained/`, as the
release ships it):

  pretrained_latentwm.pth   torch pickle {'sec_encoder', 'sec_decoder'}
                            (train/latent_wm_pretrain.py:246-249)
  mapper.pt                 torch pickle MapperNet state
                            (utils/models.py:103; ppft_train.py:1225)
  msgdecoder.pt             torch pickle, torchvision EfficientNet-B1
                            layout under 'model.' (utils/models.py:84-96)
  pytorch_lora_weights.safetensors   diffusers LoRA layout over the 192
                            U-Net targets (ppft_train.py:443-471,1210-1229)

The same seed writes the same tensors as the JAX synthesizer: the torch
draws come from one `torch.Generator` in the same order (the SecretEncoder,
then the B1 in torchvision's state-dict order without
`num_batches_tracked`, then the mapper) with the same distributions, and
the LoRA's from `np.random.default_rng(seed)`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from aqualora_torch.core.config import EfficientNetConfig, UNetConfig
from aqualora_torch.core.io import (LORA_FILE, lora_torch_key,
                                    save_safetensors, unet_module_keys)


def _block_channels(config: UNetConfig, module_key: str) -> int:
    ch = config.block_out_channels
    part = module_key.split(".")
    if part[0] == "down_blocks":
        return ch[int(part[1])]
    if part[0] == "up_blocks":
        return tuple(reversed(ch))[int(part[1])]
    return ch[-1]                                  # mid_block


def lora_site_dims(config: UNetConfig, module_key: str):
    """(in_features, out_features, is_conv) for one unet_keys.json site."""
    c = _block_channels(config, module_key)
    if module_key.endswith(("proj_in", "proj_out")):
        return c, c, True
    if ".attn2.to_k" in module_key or ".attn2.to_v" in module_key:
        return config.cross_attention_dim, c, False
    if "ff.net.0.proj" in module_key:
        return c, 8 * c, False                     # GEGLU: 2 * (4c)
    if "ff.net.2" in module_key:
        return 4 * c, c, False
    return c, c, False                             # attn q/k/v/out


def synth_lora_state(config: UNetConfig, rank: int,
                     rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """Random LoRA safetensors dict in the reference torch layout: down ~
    N(0, 1/rank^2), up small random.  Deliberately not diffusers' zero-init
    up, which would make the folded LoRA a no-op and the gate's fold ->
    generate -> decode protocol vacuous."""
    out: Dict[str, torch.Tensor] = {}
    for mk in unet_module_keys(config):
        cin, cout, is_conv = lora_site_dims(config, mk)
        down = rng.standard_normal((rank, cin)).astype(np.float32) / rank
        up = rng.standard_normal((cout, rank)).astype(np.float32) * 0.01
        if is_conv:
            down = down[:, :, None, None]
            up = up[:, :, None, None]
        out[lora_torch_key(mk, "down")] = torch.from_numpy(
            np.ascontiguousarray(down))
        out[lora_torch_key(mk, "up")] = torch.from_numpy(
            np.ascontiguousarray(up))
    return out


def _synth_torch_b1_state(cfg: EfficientNetConfig, bits: int,
                          gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A torchvision efficientnet_b1 state dict of random weights, without
    `num_batches_tracked`, its shapes and order those of the port's
    EfficientNet (torchvision's layout) built on the meta device: conv and
    linear weights and biases rnd, BatchNorm weight 1 + rnd, bias and mean
    rnd, variance 1 + 0.1 |rnd|, rnd = N(0, 0.05^2)."""
    from aqualora_torch.models.efficientnet import EfficientNet
    with torch.device("meta"):
        model = EfficientNet(dataclasses.replace(cfg, num_classes=bits * 2))
    bn = {name for name, m in model.named_modules()
          if isinstance(m, nn.BatchNorm2d)}

    def rnd(shape):
        return torch.randn(*shape, generator=gen) * 0.05

    st: Dict[str, torch.Tensor] = {}
    for key, t in model.state_dict().items():
        owner, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        if owner in bn and leaf == "weight":
            st[key] = 1 + rnd(t.shape)
        elif leaf == "running_var":
            st[key] = 1 + 0.1 * rnd(t.shape).abs()
        else:
            st[key] = rnd(t.shape)
    return st


def perturb_zero_init(state: Dict[str, torch.Tensor], seed: int = 0,
                      std: float = 0.02) -> Dict[str, torch.Tensor]:
    """A copy of `state` with small Gaussian noise added to the zero-init
    tensors that make a fresh PPFT step degenerate: every LoRA `up` weight
    and every `conv_out` weight (the SecretEncoder's zero conv).  With them
    at zero the watermarked input equals the clean one, student equals
    teacher, and the first loss and every gradient are exactly 0, which is
    right for training but useless as a numerics check.  The same tensors
    as the JAX function's leaves; raises when there is none."""
    rng = np.random.default_rng(seed)
    out = dict(state)
    hit = 0
    for k, v in state.items():
        if k.endswith(("lora.up.weight", "conv_out.weight")):
            noise = rng.standard_normal(tuple(v.shape)) * std
            out[k] = v + torch.from_numpy(noise).to(v.dtype).to(v.device)
            hit += 1
    if hit == 0:
        raise ValueError("no zero-init LoRA-up / conv_out tensors found")
    return out


def synthesize_reference_artifacts(out_dir: str, msg_bits: int = 48,
                                   rank: int = 320,
                                   unet: UNetConfig | None = None,
                                   backbone: EfficientNetConfig | None = None,
                                   seed: int = 0) -> None:
    """Write the four reference release files under `out_dir` (the LoRA
    triple inside `out_dir/ppft_trained/`, README.md:46-51)."""
    unet = unet or UNetConfig.sd15()
    backbone = backbone or EfficientNetConfig.b1(num_classes=msg_bits * 2)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(out_dir, "ppft_trained")
    os.makedirs(train_dir, exist_ok=True)

    # the stage-1 handoff: the SecretEncoder (utils/models.py:57-64 layout)
    # and the SecretDecoder ('model.'-prefixed B1)
    enc = {
        "secret_scaler.0.weight": torch.randn(32 * 32, msg_bits,
                                              generator=gen) * 0.02,
        "secret_scaler.0.bias": torch.randn(32 * 32, generator=gen) * 0.02,
        "secret_scaler.5.weight": torch.randn(4, 4, 3, 3,
                                              generator=gen) * 0.01,
        "secret_scaler.5.bias": torch.randn(4, generator=gen) * 0.01,
    }
    b1 = _synth_torch_b1_state(backbone, msg_bits, gen)
    dec = {f"model.{k}": v for k, v in b1.items()}
    torch.save({"sec_encoder": enc, "sec_decoder": dec},
               os.path.join(out_dir, "pretrained_latentwm.pth"))

    torch.save({"bit_embeddings.weight":
                torch.randn(msg_bits, rank, generator=gen) / np.sqrt(rank)},
               os.path.join(train_dir, "mapper.pt"))
    torch.save(dec, os.path.join(train_dir, "msgdecoder.pt"))

    save_safetensors(synth_lora_state(unet, rank, rng),
                     os.path.join(train_dir, LORA_FILE))
