"""The stage-1 distortion sampler: one distortion per batch.

The port of `aqualora_tpu/distort/noiser.py:25-86` (`Noiser`).  The JAX
`Noiser` picks one layer with `jax.random.choice` over a probability
vector and applies it with that layer's own draws from a key.  Here the
pick and the layer's numbers are drawn first (`Noiser.draw`, from a
`torch.Generator`) and applied second (`Noiser.__call__`), so that the
training step takes them as arguments and a test can hand it the JAX
package's numbers.

The stage-1 menu, in the reference's order: identity, JPEG (Y/U/V keep
25/9/9), crop of U(256, 512)^2 resized back, Gaussian blur with sigma
U(0.001, 10), Gaussian noise with std U(0, 0.2) and colour jitter.  The
table also has the stage-1 reference's rotation (U(-180, 180) degrees)
and sharpness (factor U(0, s), s ~ U(0, 1)).  `Stage3Noiser` and
`distortion_unit` belong to stage 3 and are not ported yet.
"""

from __future__ import annotations

import dataclasses
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


def _draw_crop(gen, shape) -> Params:
    b, _, h, w = shape
    ch = _uniform(gen, (b,), *_crop_range(h))
    cw = _uniform(gen, (b,), *_crop_range(w))
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


# name -> (draw(generator, shape), apply(x, params))
LAYERS: Dict[str, Tuple[Callable, Callable]] = {
    "identity": (_draw_none, lambda x, p: x),
    "jpeg": (_draw_none, lambda x, p: jpeg_compress(x).to(x.dtype)),
    "crop": (_draw_crop, lambda x, p: noises.crop_and_resize(
        x, p["ch"], p["cw"], p["ty"], p["tx"], out_size=x.shape[2])),
    "blur": (_draw_blur, lambda x, p: noises.gaussian_blur(x, p["sigma"])),
    "noise": (_draw_noise, lambda x, p: noises.gaussian_noise(
        x, p["std"], p["noise"])),
    "jitter": (_draw_jitter, lambda x, p: noises.color_jitter(
        x, p["brightness"], p["contrast"], p["saturation"], p["hue"])),
    "rotation": (_draw_rotation, lambda x, p: noises.rotate(x, p["angle"])),
    "sharpness": (_draw_sharpness,
                  lambda x, p: noises.sharpness(x, p["factor"])),
}


@dataclasses.dataclass
class NoiseDraw:
    """The layer picked (an index into the Noiser's layers) and its
    numbers."""

    index: int
    params: Params


class Noiser:
    """draw(generator, shape, probs) -> NoiseDraw; noiser(x, draw) -> the
    distorted images (one layer for the whole batch)."""

    def __init__(self, layers: Sequence[str] = STAGE1_LAYERS):
        self.names = list(layers)

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
        return NoiseDraw(index, LAYERS[self.names[index]][0](gen, shape))

    def __call__(self, x: torch.Tensor, draw: NoiseDraw) -> torch.Tensor:
        return LAYERS[self.names[draw.index]][1](x, draw.params)
