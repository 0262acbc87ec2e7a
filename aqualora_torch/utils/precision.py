"""Full float32 for the metrics' networks, whoever calls them.

PyTorch lets cuDNN run float32 convolutions as TF32 by default
(`torch.backends.cudnn.allow_tf32`), and a caller may have enabled TF32
matrix products too.  The JAX package computes FID's InceptionV3 and
DreamSim's ViTs in float32, so their extractors run inside `full_float32()`,
which turns both off for the block and restores the caller's flags after it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
