"""Differentiable image distortions on NCHW batches, with their random
numbers as arguments.

The port of `aqualora_tpu/distort/noises.py:35-246`.  Each JAX function
draws its own numbers from a key; here each takes them as tensors, so that
a test can hand the port the JAX package's draws, and `distort/noiser.py`
draws them from a `torch.Generator`:

  rotate            angle [B] in degrees, bilinear resample about the centre
  crop_and_resize   crop size (ch, cw) [B] and offset (ty, tx) [B], one
                    bilinear resample to out_size (pixel centres, as torch's
                    align_corners=False)
  gaussian_blur     sigma [B], separable 9-tap kernel, edge padding
  gaussian_noise    x + std [B] * noise [x.shape]
  color_jitter      brightness, contrast, saturation, hue [B] on [0, 1]
                    (input in [-1, 1] renormalised); hue as a YIQ rotation
  sharpness         blend factor [B] between a 3x3 blur and the image, the
                    border pixels kept

`bilinear_sample` and `affine_resample` are the resampling core: zero
outside the image.  Every output has the input's type.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# resampling core
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor
                    ) -> torch.Tensor:
    """Sample img [B, C, H, W] at float coordinates yy, xx [B, h, w] ->
    [B, C, h, w], bilinear, zero outside the image."""
    b, c, h, w = img.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy, wx = yy - y0, xx - x0
    flat = img.reshape(b, c, h * w)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = flat.gather(2, idx.reshape(b, 1, -1).expand(b, c, -1))
        return vals.reshape(b, c, *yy.shape[1:]) * inside[:, None]

    return (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
            + gather(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
            + gather(y0 + 1, x0) * (wy * (1 - wx))[:, None]
            + gather(y0 + 1, x0 + 1) * (wy * wx)[:, None])


def affine_resample(img: torch.Tensor, matrix: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """img [B, C, H, W]; matrix [B, 2, 3] maps output (y, x, 1) to input
    (y, x)."""
    oh, ow = out_hw
    gy, gx = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=img.device),
        torch.arange(ow, dtype=torch.float32, device=img.device),
        indexing="ij")
    m = matrix.float()[:, :, :, None, None]
    src_y = gy * m[:, 0, 0] + gx * m[:, 0, 1] + m[:, 0, 2]
    src_x = gy * m[:, 1, 0] + gx * m[:, 1, 1] + m[:, 1, 2]
    return bilinear_sample(img, src_y, src_x)


# ---------------------------------------------------------------------------
# distortions
# ---------------------------------------------------------------------------

def rotate(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each image by angle [B] degrees about its centre."""
    b, _, h, w = x.shape
    rad = angle.float() * (np.pi / 180.0)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    c, s = torch.cos(rad), torch.sin(rad)
    # src = R^T (dst - centre) + centre
    m = torch.stack([torch.stack([c, -s, cy - c * cy + s * cx], -1),
                     torch.stack([s, c, cx - s * cy - c * cx], -1)], 1)
    return affine_resample(x, m, (h, w)).to(x.dtype)


def crop_and_resize(x: torch.Tensor, ch: torch.Tensor, cw: torch.Tensor,
                    ty: torch.Tensor, tx: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """Crop (ch, cw) at (ty, tx) of each image (all [B], float), resampled
    to out_size x out_size: src = (dst + 0.5) * s - 0.5 + offset."""
    sy, sx = ch.float() / out_size, cw.float() / out_size
    zero = torch.zeros_like(sy)
    m = torch.stack([torch.stack([sy, zero, ty + 0.5 * (sy - 1.0)], -1),
                     torch.stack([zero, sx, tx + 0.5 * (sx - 1.0)], -1)], 1)
    return affine_resample(x, m, (out_size, out_size)).to(x.dtype)


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor,
                  size: int = 9) -> torch.Tensor:
    """Separable depthwise Gaussian blur with sigma [B] per image, edge
    padding (the kernel is symmetric, so correlation is convolution)."""
    b, c, h, w = x.shape
    off = torch.arange(size, dtype=torch.float32, device=x.device) - (
        size - 1) / 2.0
    k1d = torch.exp(-0.5 * (off[None, :] / sigma.float()[:, None]) ** 2)
    k1d = (k1d / k1d.sum(-1, keepdim=True)).to(x.dtype)        # [B, size]
    k = k1d.repeat_interleave(c, dim=0)                         # [B*C, size]
    pad = size // 2
    y = x.reshape(1, b * c, h, w)
    y = F.conv2d(F.pad(y, (0, 0, pad, pad), mode="replicate"),
                 k[:, None, :, None], groups=b * c)
    y = F.conv2d(F.pad(y, (pad, pad, 0, 0), mode="replicate"),
                 k[:, None, None, :], groups=b * c)
    return y.reshape(b, c, h, w)


def gaussian_noise(x: torch.Tensor, std: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """x + std [B] * noise [x.shape]."""
    return (x + std.reshape(-1, 1, 1, 1) * noise).to(x.dtype)


_YIQ = np.array([[0.299, 0.587, 0.114],
                 [0.596, -0.274, -0.322],
                 [0.211, -0.523, 0.312]], np.float32)
_YIQ_INV = np.linalg.inv(_YIQ).astype(np.float32)


def _grayscale(x01: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x01.dtype,
                     device=x01.device)
    return (x01 * w[None, :, None, None]).sum(1, keepdim=True)


def color_jitter(x: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, saturation: torch.Tensor,
                 hue: torch.Tensor, input_range: str = "pm1"
                 ) -> torch.Tensor:
    """kornia's ColorJiggle with the factors given, each [B]: brightness
    and contrast and saturation multiply, hue is a fraction of a turn.
    input_range "pm1" maps [-1, 1] to [0, 1] and back; "01" works on
    [0, 1]."""
    def per_image(f):
        return f.float().reshape(-1, 1, 1, 1)

    x01 = x / 2.0 + 0.5 if input_range == "pm1" else x
    x01 = torch.clamp(x01 * per_image(brightness), 0, 1)
    mean = _grayscale(x01).mean(dim=(2, 3), keepdim=True)
    x01 = torch.clamp(mean + (x01 - mean) * per_image(contrast), 0, 1)
    gray = _grayscale(x01)
    x01 = torch.clamp(gray + (x01 - gray) * per_image(saturation), 0, 1)
    # hue: rotate the chroma (I, Q) of YIQ
    ang = per_image(hue)[:, 0] * (2 * np.pi)                     # [B, 1, 1]
    yiq = torch.einsum("bchw,dc->bdhw", x01,
                       torch.from_numpy(_YIQ).to(x01.device, x01.dtype))
    c, s = torch.cos(ang), torch.sin(ang)
    i, q = yiq[:, 1], yiq[:, 2]
    yiq = torch.stack([yiq[:, 0], c * i - s * q, s * i + c * q], dim=1)
    x01 = torch.clamp(torch.einsum(
        "bdhw,cd->bchw", yiq,
        torch.from_numpy(_YIQ_INV).to(x01.device, yiq.dtype)), 0, 1)
    out = x01 * 2.0 - 1.0 if input_range == "pm1" else x01
    # the einsum leaves the channels last; the port's modules take NCHW
    return out.to(x.dtype).contiguous()


_SHARP_KERNEL = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]],
                         np.float32) / 13.0


def sharpness(x: torch.Tensor, factor: torch.Tensor,
              input_range: str = "pm1") -> torch.Tensor:
    """PIL's sharpness blend with factor [B]: 0 gives the 3x3 blur, 1 the
    image, f the image + (f - 1) (image - blur); border pixels keep the
    image."""
    c = x.shape[1]
    x01 = x / 2.0 + 0.5 if input_range == "pm1" else x
    k = torch.from_numpy(_SHARP_KERNEL).to(x.device, x01.dtype)
    blurred = F.conv2d(x01, k.expand(c, 1, 3, 3), padding=1, groups=c)
    f = factor.float().reshape(-1, 1, 1, 1)
    out = torch.clamp(blurred + f * (x01 - blurred), 0, 1)
    out[:, :, 0] = x01[:, :, 0]
    out[:, :, -1] = x01[:, :, -1]
    out[:, :, :, 0] = x01[:, :, :, 0]
    out[:, :, :, -1] = x01[:, :, :, -1]
    out = out * 2.0 - 1.0 if input_range == "pm1" else out
    return out.to(x.dtype)
