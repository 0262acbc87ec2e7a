"""EfficientNet (B1 by default), the SecretDecoder backbone.

The port of `aqualora_tpu/models/efficientnet.py:54-145` (MBConv +
squeeze-excite), laid out as torchvision's `efficientnet_b1` (`features.N`,
`.block.N`, `classifier.1`), the layout of the reference's `msgdecoder.pt`,
so such a checkpoint loads with `load_state_dict` as it is.

The mode is the call's `train` argument, as in flax, not the module's
`training` flag, which nothing here reads.  In eval mode (the default)
BatchNorm uses its running statistics.  In train mode it follows flax's
`BatchNorm(momentum=0.9)`: it normalises with the batch's mean and biased
variance and updates the running statistics with the same biased variance,
`r = 0.9 r + 0.1 batch` (`torch.nn.BatchNorm2d` would update
`running_var` with the unbiased one).  Train mode also applies stochastic
depth (a residual block's branch times keep / (1 - p), keep a per-sample
Bernoulli(1 - p), p rising linearly to 0.2 over the blocks) and the head's
dropout (`dropout_rate`).  A train-mode call takes their keep masks as an
argument, drawn by `draw_masks` from the caller's generator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.core import sharding as sh
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


STOCHASTIC_DEPTH_PROB = 0.2
BN_MOMENTUM = 0.9          # flax's convention: r = 0.9 r + 0.1 batch


_BN_GROUP = None


@contextlib.contextmanager
def global_batch_norm(group):
    """Train-mode BatchNorm inside the context normalises over the global
    batch of the data-parallel `group` (None, or a group of 1: each
    process's own batch, as before)."""
    global _BN_GROUP
    prev, _BN_GROUP = _BN_GROUP, group
    try:
        yield
    finally:
        _BN_GROUP = prev


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d in the call's mode, with flax's training update:
    the running variance takes the biased batch variance (see the module
    docstring).  Under data parallelism (`global_batch_norm`) train mode
    takes the global batch's mean and biased variance, as JAX's GSPMD step
    does over its sharded batch: the per-channel sum and then the sum of
    squared deviations are all-reduced over the group (two passes, as
    `var_mean`), so every rank normalises alike and updates the running
    statistics alike.  `nn.SyncBatchNorm` is not used: it refuses CPU
    tensors."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        group = _BN_GROUP
        if group is not None and dist.get_world_size(group) > 1:
            return self._global_forward(x, group)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            self._track(mean, var)
        return y

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        for run, batch in ((self.running_mean, mean),
                           (self.running_var, var)):
            run.copy_(BN_MOMENTUM * run.float() + (1 - BN_MOMENTUM) * batch)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        xf = x.float()
        n = x.shape[0] * x.shape[2] * x.shape[3] * dist.get_world_size(group)
        mean = sh.sum_over(xf.sum(dim=(0, 2, 3)), group) / n
        centred = xf - mean[None, :, None, None]
        var = sh.sum_over((centred * centred).sum(dim=(0, 2, 3)), group) / n
        self._track(mean.detach(), var.detach())
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight.float()[None, :, None, None] \
            + self.bias.float()[None, :, None, None]
        return y.to(x.dtype)


class ConvBNAct(nn.Sequential):
    """torchvision's Conv2dNormActivation: `.0` conv, `.1` BatchNorm,
    `.2` SiLU when `act`."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                            groups=groups, bias=False),
                  BatchNorm2d(cout, eps=1e-5)]
        if act:
            layers.append(nn.SiLU())
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self[1](self[0](x), train)
        return self[2](x) if len(self) > 2 else x


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
                 stride: int, sd_prob: float = 0.0):
        super().__init__()
        expanded = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(cin, expanded, 1))
        layers += [ConvBNAct(expanded, expanded, kernel, stride,
                             groups=expanded),
                   SqueezeExcitation(expanded, max(1, cin // 4)),
                   ConvBNAct(expanded, cout, 1, act=False)]
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout
        self.sd_prob = sd_prob
        # whether train mode drops the residual branch per sample
        self.stochastic = self.use_res and sd_prob > 0

    def forward(self, x: torch.Tensor, train: bool = False,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """keep: the stochastic-depth mask [B] (bool), applied when given."""
        h = x
        for layer in self.block:
            h = layer(h, train) if isinstance(layer, ConvBNAct) else layer(h)
        if keep is not None:
            h = h * keep.to(h.dtype)[:, None, None, None] / (1.0 - self.sd_prob)
        return h + x if self.use_res else h


@dataclasses.dataclass
class Masks:
    """One training call's keep masks: one [B] bool tensor per stochastic
    block (`MBConv.stochastic`, in order) and the head dropout's [B, head]
    bool tensor (None when dropout_rate is 0)."""

    depth: List[torch.Tensor]
    dropout: Optional[torch.Tensor]

    def shard(self, rank: int, n: int) -> "Masks":
        """Data rank `rank` of `n`'s rows of the global batch's masks."""
        from aqualora_torch.core.sharding import shard_batch

        return Masks([shard_batch(m, rank, n) for m in self.depth],
                     shard_batch(self.dropout, rank, n))


class EfficientNet(nn.Module):
    """forward(images NCHW) -> logits [B, num_classes]."""

    def __init__(self, cfg: EfficientNetConfig):
        super().__init__()
        stem = round_channels(32, cfg.width_mult)
        features = [ConvBNAct(3, stem, 3, 2)]
        cin = stem
        total = sum(round_repeats(r, cfg.depth_mult)
                    for _, _, r, _, _ in B0_STAGES)
        idx = 0
        for er, ch, reps, stride, kernel in B0_STAGES:
            cout = round_channels(ch, cfg.width_mult)
            blocks = []
            for bi in range(round_repeats(reps, cfg.depth_mult)):
                blocks.append(MBConv(cin, cout, er, kernel,
                                     stride if bi == 0 else 1,
                                     STOCHASTIC_DEPTH_PROB * idx / total))
                cin = cout
                idx += 1
            features.append(nn.Sequential(*blocks))
        self.head_channels = round_channels(1280, cfg.width_mult)
        features.append(ConvBNAct(cin, self.head_channels, 1))
        self.features = nn.Sequential(*features)
        self.dropout_rate = cfg.dropout_rate
        # index 0 is torchvision's dropout; train mode applies it from the
        # masks instead
        self.classifier = nn.Sequential(
            nn.Identity(), nn.Linear(self.head_channels, cfg.num_classes))

    def stochastic_blocks(self) -> List[MBConv]:
        return [b for stage in self.features[1:-1] for b in stage
                if b.stochastic]

    def draw_masks(self, batch: int, generator: torch.Generator) -> Masks:
        """Keep masks for a training call, drawn from `generator` on its
        device: Bernoulli(1 - p) per sample and stochastic block,
        Bernoulli(1 - dropout_rate) per head feature."""

        def keep(p, shape):
            return torch.rand(shape, generator=generator,
                              device=generator.device) >= p

        depth = [keep(b.sd_prob, (batch,)) for b in self.stochastic_blocks()]
        dropout = (keep(self.dropout_rate, (batch, self.head_channels))
                   if self.dropout_rate > 0 else None)
        return Masks(depth, dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: Optional[Masks] = None) -> torch.Tensor:
        """images NCHW -> logits.  A train-mode call needs the `masks` of
        stochastic depth and dropout (`draw_masks`)."""
        if train and masks is None:
            raise ValueError("a train-mode call takes its keep masks "
                             "(EfficientNet.draw_masks)")
        depth = iter(masks.depth) if train else iter(())
        x = self.features[0](x, train)
        for stage in self.features[1:-1]:
            for block in stage:
                x = block(x, train,
                          next(depth) if train and block.stochastic else None)
        x = self.features[-1](x, train).mean(dim=(2, 3))
        if train and masks.dropout is not None:
            x = torch.where(masks.dropout, x / (1.0 - self.dropout_rate),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return self.classifier[1](x)
