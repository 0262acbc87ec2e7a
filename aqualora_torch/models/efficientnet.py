"""EfficientNet (B1 by default), the SecretDecoder backbone, in eval mode.

The port of `aqualora_tpu/models/efficientnet.py` (MBConv + squeeze-excite),
laid out as torchvision's `efficientnet_b1` (`features.N`, `.block.N`,
`classifier.1`), the layout of the reference's `msgdecoder.pt`, so such a
checkpoint loads with `load_state_dict` as it is.  Stochastic depth and the
classifier dropout act only in training, which is not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn

from aqualora_torch.core.config import EfficientNetConfig

# (expand_ratio, channels, repeats, stride, kernel) - the EfficientNet-B0 base
B0_STAGES: List[Tuple[int, int, int, int, int]] = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def round_channels(ch: float, width_mult: float, divisor: int = 8) -> int:
    ch *= width_mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return new


def round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(r * depth_mult))


def conv_bn_act(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                groups: int = 1, act: bool = True) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: `.0` conv, `.1` BatchNorm."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                        groups=groups, bias=False),
              nn.BatchNorm2d(cout, eps=1e-5)]
    if act:
        layers.append(nn.SiLU())
    return nn.Sequential(*layers)


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.nn.functional.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand_ratio: int, kernel: int,
                 stride: int):
        super().__init__()
        expanded = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(conv_bn_act(cin, expanded, 1))
        layers += [conv_bn_act(expanded, expanded, kernel, stride,
                               groups=expanded),
                   SqueezeExcitation(expanded, max(1, cin // 4)),
                   conv_bn_act(expanded, cout, 1, act=False)]
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        return h + x if self.use_res else h


class EfficientNet(nn.Module):
    """forward(images NCHW) -> logits [B, num_classes]."""

    def __init__(self, cfg: EfficientNetConfig):
        super().__init__()
        stem = round_channels(32, cfg.width_mult)
        features = [conv_bn_act(3, stem, 3, 2)]
        cin = stem
        for er, ch, reps, stride, kernel in B0_STAGES:
            cout = round_channels(ch, cfg.width_mult)
            blocks = []
            for bi in range(round_repeats(reps, cfg.depth_mult)):
                blocks.append(MBConv(cin, cout, er, kernel,
                                     stride if bi == 0 else 1))
                cin = cout
            features.append(nn.Sequential(*blocks))
        head = round_channels(1280, cfg.width_mult)
        features.append(conv_bn_act(cin, head, 1))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(nn.Dropout(cfg.dropout_rate),
                                        nn.Linear(head, cfg.num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x).mean(dim=(2, 3))
        return self.classifier(x)
