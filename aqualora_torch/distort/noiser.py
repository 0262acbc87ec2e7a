"""The distortion samplers of stages 1 and 3: one distortion per batch.

The port of `aqualora_tpu/distort/noiser.py` (`Noiser`, `distortion_unit`,
`Stage3Noiser`).  The JAX samplers pick one layer with `jax.random.choice`
over a probability vector and apply it with that layer's own draws from a
key.  Here the pick and the layer's numbers are drawn first
(`Noiser.draw`, from a `torch.Generator`) and applied second
(`Noiser.__call__`), so that the training step takes them as arguments and
a test can hand it the JAX package's numbers.

The stage-1 menu (`Noiser`), in the reference's order: identity, JPEG
(Y/U/V keep 25/9/9), crop of U(256, 512)^2 resized back, Gaussian blur with
sigma U(0.001, 10), Gaussian noise with std U(0, 0.2) and colour jitter.
The table also has the stage-1 reference's rotation (U(-180, 180) degrees)
and sharpness (factor U(0, s), s ~ U(0, 1)).

The milder stage-3 menu (`Stage3Noiser`, `distortion_unit`), on [0, 1]
images: identity; colour jitter (brightness, contrast and saturation
U(0.8, 1.2), hue U(-0.1, 0.1)); a crop of U(432, 512)^2 resized back to the
image's own size; blur at sigma 4 with a 5-tap kernel; noise of std 0.1
clamped to [0, 1]; by default with probabilities (0.6, 0.1, 0.15, 0.05,
0.1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Sequence, Tuple

import torch

from aqualora_torch.distort import noises
from aqualora_torch.distort.jpeg import jpeg_compress

STAGE1_LAYERS = ("identity", "jpeg", "crop", "blur", "noise", "jitter")

Params = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _crop_range(n: int, lo: int = 256, hi: int = 512) -> Tuple[float, float]:
    """Both bounds clamped to the image, so a small image draws crops no
    larger than itself (the JAX package's rule)."""
    lo_n = min(lo, n)
    return lo_n, max(min(hi, n), lo_n + 1e-6)


def _draw_none(gen, shape) -> Params:
    return {}


def _draw_crop(gen, shape, lo: int = 256, hi: int = 512) -> Params:
    b, _, h, w = shape
    ch = _uniform(gen, (b,), *_crop_range(h, lo, hi))
    cw = _uniform(gen, (b,), *_crop_range(w, lo, hi))
    ty = _uniform(gen, (b,), 0.0, 1.0) * (h - ch)
    tx = _uniform(gen, (b,), 0.0, 1.0) * (w - cw)
    return {"ch": ch, "cw": cw, "ty": ty, "tx": tx}


def _draw_blur(gen, shape) -> Params:
    return {"sigma": _uniform(gen, (shape[0],), 1e-3, 10.0)}


def _draw_noise(gen, shape) -> Params:
    return {"std": _uniform(gen, (shape[0],), 0.0, 0.2),
            "noise": torch.randn(shape, generator=gen, device=gen.device)}


def _draw_jitter(gen, shape) -> Params:
    b = shape[0]
    return {"brightness": _uniform(gen, (b,), 0.7, 1.3),
            "contrast": _uniform(gen, (b,), 0.8, 1.25),
            "saturation": _uniform(gen, (b,), 0.8, 1.25),
            "hue": _uniform(gen, (b,), -0.2, 0.2)}


def _draw_rotation(gen, shape) -> Params:
    return {"angle": _uniform(gen, (shape[0],), -180.0, 180.0)}


def _draw_sharpness(gen, shape) -> Params:
    # two nested uniforms, as the reference's Sharpness(strength=1.)
    s = _uniform(gen, (), 0.0, 1.0)
    return {"factor": _uniform(gen, (shape[0],), 0.0, 1.0) * s}


def _crop(x, p):
    return noises.crop_and_resize(x, p["ch"], p["cw"], p["ty"], p["tx"],
                                  out_size=x.shape[2])


def _jitter(x, p, input_range="pm1"):
    return noises.color_jitter(x, p["brightness"], p["contrast"],
                               p["saturation"], p["hue"], input_range)


# name -> (draw(generator, shape), apply(x, params))
LAYERS: Dict[str, Tuple[Callable, Callable]] = {
    "identity": (_draw_none, lambda x, p: x),
    "jpeg": (_draw_none, lambda x, p: jpeg_compress(x).to(x.dtype)),
    "crop": (_draw_crop, _crop),
    "blur": (_draw_blur, lambda x, p: noises.gaussian_blur(x, p["sigma"])),
    "noise": (_draw_noise, lambda x, p: noises.gaussian_noise(
        x, p["std"], p["noise"])),
    "jitter": (_draw_jitter, _jitter),
    "rotation": (_draw_rotation, lambda x, p: noises.rotate(x, p["angle"])),
    "sharpness": (_draw_sharpness,
                  lambda x, p: noises.sharpness(x, p["factor"])),
}


# -- the stage-3 menu (`aqualora_tpu/distort/noiser.py:89-136`) -------------

def _draw_unit_jitter(gen, shape) -> Params:
    b = shape[0]
    return {"brightness": _uniform(gen, (b,), 0.8, 1.2),
            "contrast": _uniform(gen, (b,), 0.8, 1.2),
            "saturation": _uniform(gen, (b,), 0.8, 1.2),
            "hue": _uniform(gen, (b,), -0.1, 0.1)}


def _draw_unit_blur(gen, shape) -> Params:
    return {"sigma": _uniform(gen, (shape[0],), 4.0 - 1e-6, 4.0)}


def _draw_unit_noise(gen, shape) -> Params:
    return {"noise": torch.randn(shape, generator=gen, device=gen.device)}


def _unit_noise(x, p):
    std = torch.full((x.shape[0],), 0.1, device=x.device)
    return torch.clamp(noises.gaussian_noise(x, std, p["noise"]), 0.0, 1.0)


DISTORTION_UNITS: Dict[str, Tuple[Callable, Callable]] = {
    "identity": (_draw_none, lambda x, p: x),
    "color_jitter": (_draw_unit_jitter,
                     functools.partial(_jitter, input_range="01")),
    "crop": (functools.partial(_draw_crop, lo=432, hi=512), _crop),
    "blur": (_draw_unit_blur,
             lambda x, p: noises.gaussian_blur(x, p["sigma"], size=5)),
    "noise": (_draw_unit_noise, _unit_noise),
}


def distortion_unit(x01: torch.Tensor, kind: str, params: Params
                    ) -> torch.Tensor:
    """Apply one named stage-3 distortion, with its numbers, to [0, 1]
    images."""
    return DISTORTION_UNITS[kind][1](x01, params)


@dataclasses.dataclass
class NoiseDraw:
    """The layer picked (an index into the Noiser's layers) and its
    numbers."""

    index: int
    params: Params

    def shard(self, batch: int, rank: int, n: int) -> "NoiseDraw":
        """Data rank `rank` of `n`'s rows of the per-sample numbers
        (leading axis the global `batch`); the scalars stay."""
        from aqualora_torch.core.sharding import shard_batch

        return NoiseDraw(self.index, {
            k: shard_batch(v, rank, n) if v.dim() and v.shape[0] == batch
            else v for k, v in self.params.items()})


class Noiser:
    """draw(generator, shape, probs) -> NoiseDraw; noiser(x, draw) -> the
    distorted images (one layer for the whole batch).  `table` maps a
    layer's name to its (draw, apply) pair."""

    def __init__(self, layers: Sequence[str] = STAGE1_LAYERS,
                 table: Dict[str, Tuple[Callable, Callable]] = None):
        self.names = list(layers)
        self.table = LAYERS if table is None else table

    def draw(self, gen: torch.Generator, shape, probs) -> NoiseDraw:
        """Pick a layer with the probabilities `probs` (one per layer) and
        draw its numbers for a batch of `shape` [B, C, H, W]."""
        p = [float(x) for x in probs]
        if len(p) != len(self.names) or min(p) < 0 or sum(p) <= 0:
            raise ValueError(f"want {len(self.names)} probabilities, got {p}")
        u = float(torch.rand((), generator=gen, device=gen.device)) * sum(p)
        index, acc = 0, 0.0
        for index, pi in enumerate(p):
            acc += pi
            if u < acc:
                break
        return NoiseDraw(index, self.table[self.names[index]][0](gen, shape))

    def __call__(self, x: torch.Tensor, draw: NoiseDraw) -> torch.Tensor:
        return self.table[self.names[draw.index]][1](x, draw.params)


class Stage3Noiser(Noiser):
    """The stage-3 sampler (`Stage3Noiser`, the reference's
    `rob_enhance_finetune.py:121-132`) over [identity, color_jitter, crop,
    blur, noise] on [0, 1] images; `draw` takes DEFAULT_PROBS unless given
    others."""

    ORDER = ("identity", "color_jitter", "crop", "blur", "noise")
    DEFAULT_PROBS = (0.6, 0.1, 0.15, 0.05, 0.1)

    def __init__(self):
        super().__init__(self.ORDER, DISTORTION_UNITS)

    def draw(self, gen: torch.Generator, shape, probs=None) -> NoiseDraw:
        return super().draw(gen, shape,
                            self.DEFAULT_PROBS if probs is None else probs)
