"""The eval protocol's distortions: the robustness benchmark's attacks.

The port of `aqualora_tpu/eval/distortions.py`, after the reference's
`evaluation/utils_eval.py:216-311`: fixed-strength colour jitter, a 460^2
crop after a resize to 512^2, blur, noise, real JPEG at quality 50, a
rotation of exactly +15 degrees, sharpness, and the SDEdit regeneration
attacks (img2img at strength 0.1 with SD-1.5, 0.2 with SD-2.1).

Images are [B, 3, H, W] in [0, 1] on the device.  Each distortion's random
numbers are drawn first (`draw(kind, generator, shape)`, from a
`torch.Generator`) and applied second (`apply(kind, x01, params)`), so a
test can hand the port the JAX package's draws; `distortion_unit` does both.
Every output is quantized to 8 bits on the device (`fetch01`), as the JAX
package's `_fetch01`, since the next step is the PNG save.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from aqualora_torch.distort import noises
from aqualora_torch.eval.jpeg import jpeg_roundtrip
from aqualora_torch.ops.resize import bilinear_resize

DISTORTION_TYPES = ("color_jitter", "crop", "blur", "noise", "jpeg_compress",
                    "rotation", "sharpness", "SDEdit", "SDEdit2")

Params = Dict[str, torch.Tensor]

CROP_SIZE = 460
JPEG_QUALITY = 50
ROTATION_DEGREES = 15.0


def fetch01(y: torch.Tensor) -> torch.Tensor:
    """round(clip(y, 0, 1) * 255) / 255 in float32: the 8-bit levels the PNG
    save keeps."""
    return torch.round(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8).float() \
        / 255.0


def to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> [B, H, W, 3] uint8, rounded (the JAX
    runner's `np.round(d * 255).clip(0, 255)` before its PNG save)."""
    return torch.round(x01 * 255.0).clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1)


def resize512(x01: torch.Tensor) -> torch.Tensor:
    """The reference's resize decorator: bilinear to 512^2 without
    antialiasing (torchvision's T.Resize on tensors), quantized."""
    if tuple(x01.shape[-2:]) == (512, 512):
        return x01
    return fetch01(bilinear_resize(x01, 512, 512))


def _uniform(gen: torch.Generator, b: int, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand((b,), generator=gen, device=gen.device) * (hi - lo) + lo


# ---------------------------------------------------------------------------
# the draws: kind -> (generator, [B, 3, H, W]) -> params
# ---------------------------------------------------------------------------

def _draw_jitter(gen, shape) -> Params:
    b = shape[0]
    return {"brightness": _uniform(gen, b, 0.9, 1.1),
            "contrast": _uniform(gen, b, 0.9, 1.1),
            "saturation": _uniform(gen, b, 0.9, 1.1),
            "hue": _uniform(gen, b, -0.1, 0.1)}


def _draw_crop(gen, shape) -> Params:
    """An offset for each image (kornia's RandomCrop), in the 512^2 image
    that `resize512` makes."""
    high = 512 - CROP_SIZE + 1
    return {k: torch.randint(0, high, (shape[0],), generator=gen,
                             device=gen.device) for k in ("ty", "tx")}


def _draw_blur(gen, shape) -> Params:
    # sigma 4 fixed: the JAX call's U(4 - 1e-6, 4)
    return {"sigma": _uniform(gen, shape[0], 4.0 - 1e-6, 4.0)}


def _draw_noise(gen, shape) -> Params:
    return {"noise": torch.randn(shape, generator=gen, device=gen.device)}


def _draw_sharpness(gen, shape) -> Params:
    return {"factor": _uniform(gen, shape[0], 0.0, 10.0)}


def _draw_none(gen, shape) -> Params:
    return {}


# ---------------------------------------------------------------------------
# the distortions: [B, 3, H, W] in [0, 1], params -> the same, quantized
# ---------------------------------------------------------------------------

def color_jitter(x01, p: Params):
    return fetch01(noises.color_jitter(x01, p["brightness"], p["contrast"],
                                       p["saturation"], p["hue"],
                                       input_range="01"))


def crop(x01, p: Params):
    x01 = resize512(x01)
    return torch.stack([
        img[:, ty:ty + CROP_SIZE, tx:tx + CROP_SIZE]
        for img, ty, tx in zip(x01, p["ty"].tolist(), p["tx"].tolist())])


def blur(x01, p: Params):
    return fetch01(noises.gaussian_blur(x01, p["sigma"], size=3))


def noise(x01, p: Params):
    std = torch.full((x01.shape[0],), 0.1, device=x01.device)
    return fetch01(noises.gaussian_noise(x01, std, p["noise"]))


def jpeg_compress(x01, p: Params, quality: int = JPEG_QUALITY):
    """Real JPEG: the 8-bit image (truncated, as the JAX function's
    astype) through libjpeg's round trip (`eval/jpeg.py`)."""
    u8 = (x01 * 255).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return jpeg_roundtrip(u8, quality).permute(0, 3, 1, 2).float() / 255.0


def rotation(x01, p: Params):
    """RandomRotation(degrees=(15, 15)): always exactly +15 degrees."""
    angle = torch.full((x01.shape[0],), ROTATION_DEGREES, device=x01.device)
    return fetch01(noises.rotate(x01, angle))


def sharpness(x01, p: Params):
    return fetch01(noises.sharpness(x01, p["factor"], input_range="01"))


TABLE: Dict[str, tuple] = {
    "color_jitter": (_draw_jitter, color_jitter),
    "crop": (_draw_crop, crop),
    "blur": (_draw_blur, blur),
    "noise": (_draw_noise, noise),
    "jpeg_compress": (_draw_none, jpeg_compress),
    "rotation": (_draw_none, rotation),
    "sharpness": (_draw_sharpness, sharpness),
}


def draw(kind: str, gen: torch.Generator, shape) -> Params:
    """The random numbers of distortion `kind` for a batch of `shape`."""
    return TABLE[kind][0](gen, tuple(shape))


def apply(kind: str, x01: torch.Tensor, params: Params) -> torch.Tensor:
    return TABLE[kind][1](x01, params)


# ---------------------------------------------------------------------------
# the regeneration attack
# ---------------------------------------------------------------------------

class SDEditAttack:
    """img2img at strength 0.1 (version 1, SD-1.5) or 0.2 (version 2, the
    reference's SD-2.1), 10 steps, CFG 7.5, the prompt "masterpiece" and
    an empty negative prompt (`utils_eval.py:244-262`).  `pipe` holds the
    weights; images go through in chunks of `batch_size`, the last chunk
    padded with its last image so every call has one shape."""

    def __init__(self, pipe, tokenizer: Callable, version: int = 1,
                 resolution: int = 512, batch_size: int = 8):
        self.strength = 0.1 if version == 1 else 0.2
        self.fn = pipe.make_img2img(num_steps=10, strength=self.strength,
                                    height=resolution, width=resolution)
        self.latent = (resolution // pipe.config.vae.downscale,
                       resolution // pipe.config.vae.downscale,
                       pipe.config.vae.latent_channels)
        self.batch_size = batch_size
        self.ids = np.asarray(tokenizer(["masterpiece"]))
        self.neg = np.asarray(tokenizer([""]))

    def draw(self, gen: torch.Generator, b: int) -> Params:
        """One call's draws: the posterior sample's noise, then the forward
        process's, NHWC latents."""
        shape = (b,) + self.latent
        return {k: torch.randn(shape, generator=gen, device=gen.device)
                for k in ("posterior_noise", "noise")}

    def __call__(self, x01: torch.Tensor, gen: torch.Generator
                 ) -> torch.Tensor:
        x = x01.permute(0, 2, 3, 1) * 2.0 - 1.0
        n = x.shape[0]
        bs = min(self.batch_size, n)
        ids, neg = np.repeat(self.ids, bs, 0), np.repeat(self.neg, bs, 0)
        outs = []
        for i in range(0, n, bs):
            chunk = x[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    pad, *chunk.shape[1:])])
            out = self.fn(chunk, ids, neg, 7.5, **self.draw(gen, bs))
            outs.append(fetch01((out.permute(0, 3, 1, 2) + 1.0) * 0.5)
                        [:bs - pad])
        return torch.cat(outs)


def distortion_unit(x01: torch.Tensor, kind: str, gen: torch.Generator,
                    sdedit: Optional[SDEditAttack] = None,
                    sdedit2: Optional[SDEditAttack] = None) -> torch.Tensor:
    """Distortion `kind` of [B, 3, H, W] images in [0, 1], its numbers
    drawn from `gen`."""
    if kind in TABLE:
        return apply(kind, x01, draw(kind, gen, x01.shape))
    if kind in ("SDEdit", "SDEdit2"):
        attack = sdedit if kind == "SDEdit" else sdedit2
        if attack is None:
            raise ValueError(f"{kind} attack requires a pipeline instance")
        return attack(x01, gen)
    raise ValueError(f"unknown distortion {kind}")


def check_kinds(names: Sequence[str]) -> list:
    """`names` as a list, or ValueError for an unknown kind: a runner
    calls it before anything runs."""
    bad = [k for k in names if k not in DISTORTION_TYPES]
    if bad:
        raise ValueError(f"unknown distortion {bad[0]}; have "
                         f"{DISTORTION_TYPES}")
    return list(names)
