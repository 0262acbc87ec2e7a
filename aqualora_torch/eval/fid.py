"""FID: InceptionV3 pool3 statistics and the Frechet distance, in PyTorch.

The port of `aqualora_tpu/eval/fid.py` (the reference's vendored
`pytorch_fid`): images in [0, 1] are resized to 299x299 (bilinear, no
antialias, as pytorch_fid's `F.interpolate`), mapped to [-1, 1] and run
through `models/inception.py` on `device` (the card unless the caller asks
for the CPU) in full float32 (`utils/precision.full_float32`); the
statistics (mu, sigma) and the distance are computed on the host with numpy
and scipy's `sqrtm` (`pytorch_fid/fid_score.py:160,257`).

Folders are read with the port's own decoders (`train/image_decode.
decode_file`: JPEG in host C++, PNG by hand), never PIL, converted to RGB as
PIL's `convert("RGB")` converts, and streamed one image at a time.  There is
no mesh (ROADMAP A.9).

    python -m aqualora_torch.eval.fid DIR_A DIR_B --torch-weights W.pth
    python -m aqualora_torch.eval.fid DIR out.npz --save-stats ...
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from aqualora_torch.models.inception import InceptionV3Features
from aqualora_torch.ops.resize import bilinear_resize
from aqualora_torch.utils.precision import full_float32

FEATURES = 2048


def _resize299(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] -> [..., 299, 299, 3], bilinear without antialias
    (FID is sensitive to the resize kernel)."""
    if tuple(x.shape[-3:-1]) == (299, 299):
        return x
    lead = x.shape[:-3]
    nchw = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    out = bilinear_resize(nchw, 299, 299).permute(0, 2, 3, 1)
    return out.reshape(tuple(lead) + (299, 299, 3))


def _padded_batches(images01, batch_size: int):
    """Yield ([batch_size, H, W, 3] float32 chunk, n_valid) pairs from an
    [N, H, W, 3] array or from an iterable of single [H, W, 3] images
    (streamed: a protocol folder of 5000 images is never held whole).  The
    tail chunk is zero-padded to batch_size, so every model call has one
    shape; a chunk of mixed sizes is resized to 299 image by image before
    it is stacked."""
    def _pad(chunk):
        n = len(chunk)
        if n < batch_size:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - n,) + chunk.shape[1:],
                                 chunk.dtype)])
        return chunk, n

    if hasattr(images01, "shape"):          # in-memory array
        for i in range(0, len(images01), batch_size):
            yield _pad(np.ascontiguousarray(images01[i:i + batch_size],
                                            np.float32))
        return
    buf = []

    def _flush():
        if len({im.shape for im in buf}) > 1:
            return _pad(np.stack([_resize299(torch.from_numpy(im)).numpy()
                                  for im in buf]))
        return _pad(np.stack(buf))

    for im in images01:                      # streamed iterable
        buf.append(np.ascontiguousarray(im, np.float32))
        if len(buf) == batch_size:
            yield _flush()
            buf = []
    if buf:
        yield _flush()


class InceptionExtractor:
    """Batched pool3 features.  `params`: a state dict of
    `InceptionV3Features` (from `tools/torch_import.inception_from_torch`
    or the port's own file); None gives seeded random weights
    (`InceptionV3Features.init_weights`, generator seed 0).  The weights
    go to `device` once."""

    def __init__(self, params=None, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        model = InceptionV3Features()
        if params is None:
            model.init_weights(torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, images01, batch_size: int = 32) -> np.ndarray:
        """images01: [N, H, W, 3] in [0, 1], or a streamed iterable of [H,
        W, 3] images -> [N, 2048] float32 features."""
        feats = []
        with full_float32():
            for chunk, n in _padded_batches(images01, batch_size):
                x = _resize299(torch.from_numpy(chunk).to(self.device))
                x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)  # FID normalization
                feats.append(self.model(x)[:n].cpu().numpy())
        if not feats:
            return np.zeros((0, FEATURES), np.float32)
        return np.concatenate(feats, axis=0)


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(feats, axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy's matrix square root, its warnings silenced as pytorch_fid's
    `disp=False` silences them: FID's covariances are routinely near
    singular, and a non-finite result is handled by the caller's eps retry.
    `disp` is deprecated in scipy 1.17 and gone in 1.18."""
    import warnings

    from scipy import linalg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        try:
            r = linalg.sqrtm(m, disp=False)   # (X, errest) before 1.18
        except TypeError:
            r = linalg.sqrtm(m)
    return r[0] if isinstance(r, tuple) else r


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """`pytorch_fid/fid_score.py:160`: |mu1 - mu2|^2 + tr(s1) + tr(s2) -
    2 tr(sqrt(s1 s2)); eps on the diagonals when the root is not finite; a
    large imaginary diagonal raises."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        # pytorch_fid's check (fid_score.py:205-209): a large imaginary
        # diagonal means the product is numerically broken (far too few
        # images for the covariance)
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def _load_images(path: str,
                 limit: Optional[int] = None) -> Iterable[np.ndarray]:
    """The folder's *.png, *.jpg and *.jpeg files, sorted by path (the
    order `limit` cuts), each as HWC float32 RGB in [0, 1], one at a
    time."""
    from aqualora_torch.train.image_decode import decode_file
    files = sorted(sum((glob.glob(os.path.join(path, e))
                        for e in ("*.png", "*.jpg", "*.jpeg")), []))
    for f in files[:limit] if limit else files:
        yield decode_file(f, pil=True).astype(np.float32) / 255.0


def fid_given_paths(path1: str, path2: str, batch_size: int = 32,
                    limit: Optional[int] = None,
                    extractor: Optional[InceptionExtractor] = None,
                    device: str | torch.device = "cuda") -> float:
    """`calculate_fid_given_paths` (fid_score.py:257): two image folders,
    or .npz files of precomputed mu and sigma.  Without an `extractor`,
    one with seeded random weights is built on `device`."""
    ex = extractor or InceptionExtractor(device=device)
    stats = []
    for p in (path1, path2):
        if p.endswith(".npz"):
            with np.load(p) as f:
                stats.append((f["mu"], f["sigma"]))
            continue
        feats = ex(_load_images(p, limit), batch_size)   # streamed
        if len(feats) == 0:
            raise FileNotFoundError(f"no images under {p}")
        stats.append(activation_statistics(feats))
    (m1, s1), (m2, s2) = stats
    return frechet_distance(m1, s1, m2, s2)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FID of two image folders (or .npz mu/sigma files), "
                    "the CLI of pytorch_fid (`python -m pytorch_fid path1 "
                    "path2`); --save-stats writes a folder's .npz instead")
    p.add_argument("paths", nargs=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--save-stats", action="store_true",
                   help="treat paths as (image_dir, out.npz): compute and "
                        "save mu/sigma instead of a FID")
    p.add_argument("--torch-weights", type=str, default=None,
                   help="pt_inception .pth (torchvision inception_v3 "
                        "layout), read by tools/torch_import."
                        "inception_from_torch")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="permit a randomly initialized Inception (smoke "
                        "tests only: the FID is meaningless)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    params = None
    if args.torch_weights:
        from aqualora_torch.tools.torch_import import inception_from_torch
        params = inception_from_torch(args.torch_weights)
    elif not args.allow_random_weights:
        # pytorch_fid always runs pretrained weights; a random-init
        # extractor would print a plausible but meaningless FID
        p.error("no Inception weights: pass --torch-weights "
                "pt_inception-*.pth (or --allow-random-weights for a "
                "smoke run whose FID is meaningless)")
    ex = InceptionExtractor(params=params, device=args.device)
    if args.save_stats:
        feats = ex(_load_images(args.paths[0], args.limit), args.batch_size)
        if len(feats) == 0:
            p.error(f"no images under {args.paths[0]}")
        mu, sigma = activation_statistics(feats)
        np.savez(args.paths[1], mu=mu, sigma=sigma)
        print(f"saved stats for {len(feats)} images -> {args.paths[1]}")
        return mu, sigma
    fid = fid_given_paths(args.paths[0], args.paths[1],
                          batch_size=args.batch_size, limit=args.limit,
                          extractor=ex)
    print(f"FID: {fid:.6f}")
    return fid


if __name__ == "__main__":
    main()
