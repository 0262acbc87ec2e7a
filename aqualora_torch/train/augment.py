"""Stage-1 augmentations on NCHW tensors, with their random numbers as
arguments.

The port of `aqualora_tpu/train/augment.py:21-79`:

- `cornerfy(wm_latent, hs, ws)`: the four corner quadrants of the
  watermark latent are placed at the corners of a canvas (round(h * hs),
  round(w * ws)) with hs, ws in [1, 2), and the canvas is resized back to
  (h, w) bilinearly at pixel centres: the watermark's corners shrink
  towards the image's corners around an empty middle.  The JAX package
  keeps a fixed 2h x 2w canvas for static shapes; the values are the same.
- `maybe_cornerfy`: cornerfy when the step's draw says so (probability 1/4
  in `train/latent_wm_pretrain.py`).
- `base_augment`: when `apply`, a horizontal flip (when `flip`) and then a
  rotation by k quarter turns, for the whole batch.
"""

from __future__ import annotations

import torch

from aqualora_torch.distort.noises import bilinear_sample


def cornerfy(wm_latent: torch.Tensor, hs: float, ws: float) -> torch.Tensor:
    """Corner augmentation of a watermark latent [B, C, h, w]; hs, ws are
    float32 scalars (tensors or numbers) in [1, 2)."""
    b, c, h, w = wm_latent.shape
    dev = wm_latent.device
    hs = torch.as_tensor(hs, dtype=torch.float32, device=dev)
    ws = torch.as_tensor(ws, dtype=torch.float32, device=dev)
    h2 = int(torch.round(h * hs))
    w2 = int(torch.round(w * ws))
    hh, hw = h // 2, w // 2
    canvas = wm_latent.new_zeros((b, c, 2 * h, 2 * w))
    canvas[:, :, :hh, :hw] = wm_latent[:, :, :hh, :hw]
    canvas[:, :, :hh, w2 - hw:w2] = wm_latent[:, :, :hh, -hw:]
    canvas[:, :, h2 - hh:h2, :hw] = wm_latent[:, :, -hh:, :hw]
    canvas[:, :, h2 - hh:h2, w2 - hw:w2] = wm_latent[:, :, -hh:, -hw:]
    # resize [0:h2, 0:w2] back to (h, w): src = (dst + 0.5) * scale - 0.5
    sy = torch.tensor(h2, dtype=torch.float32, device=dev) / h
    sx = torch.tensor(w2, dtype=torch.float32, device=dev) / w
    gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    out = bilinear_sample(canvas, yy.expand(b, h, w), xx.expand(b, h, w))
    return out.to(wm_latent.dtype)


def maybe_cornerfy(wm_latent: torch.Tensor, do: bool, hs: float,
                   ws: float) -> torch.Tensor:
    """cornerfy(wm_latent, hs, ws) if `do`, else wm_latent."""
    return cornerfy(wm_latent, hs, ws) if do else wm_latent


def base_augment(image: torch.Tensor, apply: bool, flip: bool,
                 k: int) -> torch.Tensor:
    """Random horizontal flip + rot90 of a [B, C, H, W] batch, as drawn."""
    if not apply:
        return image
    if flip:
        image = torch.flip(image, dims=(3,))
    return torch.rot90(image, int(k), dims=(2, 3))
