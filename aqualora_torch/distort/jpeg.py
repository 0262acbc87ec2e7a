"""Differentiable JPEG simulation on NCHW images.

The port of `aqualora_tpu/distort/jpeg.py:76-89`: RGB -> YUV, a DCT of each
8x8 block as two 8x8 products (einsum), the zig-zag mask that keeps the
first (25, 9, 9) coefficients of Y, U and V, the inverse DCT and YUV ->
RGB.  The value range is kept.  The bases and the mask are numpy constants,
copies of the JAX package's builders (`:31-65`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_RGB2YUV = np.array([[0.299, 0.587, 0.114],
                     [-0.14713, -0.28886, 0.436],
                     [0.615, -0.51499, -0.10001]], np.float32)
_YUV2RGB = np.array([[1.0, 0.0, 1.13983],
                     [1.0, -0.39465, -0.58060],
                     [1.0, 2.03211, 0.0]], np.float32)


def _dct_coeff(n, k, N):
    return np.cos(np.pi / N * (n + 0.5) * k)


def _idct_coeff(n, k, N):
    return ((n == 0) * (-0.5) + np.cos(np.pi / N * (k + 0.5) * n)) * np.sqrt(
        1.0 / (2.0 * N))


@functools.lru_cache()
def _bases(N: int = 8):
    """(DCT [n, k], inverse DCT [coefficient, pixel]) as float32."""
    n = np.arange(N)[:, None]
    k = np.arange(N)[None, :]
    return (_dct_coeff(n, k, N).astype(np.float32),
            _idct_coeff(n, k, N).astype(np.float32))


@functools.lru_cache()
def _zigzag_mask(keep: int, N: int = 8) -> np.ndarray:
    """Keep the first `keep` coefficients in zig-zag order."""
    order = sorted(((x, y) for x in range(N) for y in range(N)),
                   key=lambda p: (p[0] + p[1],
                                  -p[1] if (p[0] + p[1]) % 2 else p[1]))
    mask = np.zeros((N, N), np.float32)
    for i, j in order[:keep]:
        mask[i, j] = 1.0
    return mask


@functools.lru_cache()
def _yuv_mask(yuv_keep=(25, 9, 9)) -> np.ndarray:
    return np.stack([_zigzag_mask(k) for k in yuv_keep])   # [3, 8, 8]


def jpeg_compress(x: torch.Tensor, yuv_keep=(25, 9, 9)) -> torch.Tensor:
    """Differentiable JPEG of [B, 3, H, W] images, any H and W (zero pad to
    multiples of 8, cropped after)."""
    dev, dt = x.device, x.dtype
    md, mi = (torch.from_numpy(m).to(dev, dt) for m in _bases())
    mask = torch.from_numpy(_yuv_mask(tuple(yuv_keep))).to(dev, dt)
    rgb2yuv = torch.from_numpy(_RGB2YUV).to(dev, dt)
    yuv2rgb = torch.from_numpy(_YUV2RGB).to(dev, dt)
    b, _, h, w = x.shape
    yuv = torch.einsum("bchw,dc->bdhw", x, rgb2yuv)
    yuv = F.pad(yuv, (0, (-w) % 8, 0, (-h) % 8))
    nh, nw = yuv.shape[2] // 8, yuv.shape[3] // 8
    blocks = yuv.reshape(b, 3, nh, 8, nw, 8)
    # DCT: Y = Md^T X Md over each 8x8 block
    coef = torch.einsum("bcHiWj,ik,jl->bcHkWl", blocks, md, md)
    coef = coef * mask[None, :, None, :, None, :]
    # inverse: Mi^T C Mi
    out = torch.einsum("bcHiWj,ik,jl->bcHkWl", coef, mi, mi)
    out = out.reshape(b, 3, nh * 8, nw * 8)[:, :, :h, :w]
    # the einsum leaves the channels last; the port's modules take NCHW
    return torch.einsum("bdhw,cd->bchw", out, yuv2rgb).contiguous()
