"""LPIPS with a VGG16 backbone, the stage-1 perceptual loss, NCHW.

The port of `aqualora_tpu/models/lpips.py:29-79`: VGG16 features at
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each unit-normalised over
channels with the eps outside the square root (lpips' `normalize_tensor`,
the fix of dbdc671), the squared difference weighted by the non-negative
1x1 "lin" weights (taken as |w|), the spatial mean, the sum over the five
taps.  The inputs in [-1, 1] are shifted and scaled by lpips' constants,
and both images go through one VGG pass as one batch.

The layout is the lpips package's (`net.slice1.0` ... `net.slice5.28`, the
torchvision VGG16 feature indices, and `lin0.model.1.weight` [1, C, 1, 1]),
so its `vgg.pth` lin weights load as they are; index 0 of each `lin` is
the reference's dropout, which a frozen LPIPS never applies.  The weights
are random from a seed, as in the JAX package: nothing is downloaded.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

# (channels, convolutions) per stage; a tap at each stage's end
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# lpips' ScalingLayer, in [-1, 1] space
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def vgg16_conv_indices() -> List[List[int]]:
    """torchvision's `features` index of each convolution, per stage."""
    out, idx = [], 0
    for si, (_, n) in enumerate(VGG16_STAGES):
        if si:
            idx += 1                      # the max pool before the stage
        stage = []
        for _ in range(n):
            stage.append(idx)
            idx += 2                      # the convolution and its ReLU
        out.append(stage)
    return out


class VGG16Features(nn.Module):
    """forward(x) -> the five LPIPS taps, as lpips' `vgg16` slices."""

    def __init__(self):
        super().__init__()
        cin = 3
        for si, ((ch, _), idxs) in enumerate(zip(VGG16_STAGES,
                                                 vgg16_conv_indices())):
            sl = nn.Sequential()
            if si:
                sl.add_module(str(idxs[0] - 1), nn.MaxPool2d(2, 2))
            for i in idxs:
                sl.add_module(str(i), nn.Conv2d(cin, ch, 3, padding=1))
                sl.add_module(str(i + 1), nn.ReLU())
                cin = ch
            setattr(self, f"slice{si + 1}", sl)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for si in range(len(VGG16_STAGES)):
            x = getattr(self, f"slice{si + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """lpips(x0, x1) with [B, 3, H, W] inputs in [-1, 1] -> [B], computed
    in the weights' type."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, (ch, _) in enumerate(VGG16_STAGES):
            setattr(self, f"lin{i}", NetLinLayer(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None],
                             persistent=False)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        b0 = x0.shape[0]
        x = torch.cat([x0, x1], dim=0).to(next(self.parameters()).dtype)
        x = (x - self.shift.to(x.dtype)) / self.scale.to(x.dtype)
        total = 0.0
        for i, t in enumerate(self.net(x)):
            a, b = t[:b0], t[b0:]
            # eps outside the sqrt, as lpips.normalize_tensor
            a = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.abs()    # [1, C, 1, 1]
            d = F.conv2d((a - b) ** 2, w)                         # [B, 1, H, W]
            total = total + d.mean(dim=(1, 2, 3))
        return total
