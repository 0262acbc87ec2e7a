"""Training data for the port: the synthetic dataset.

A copy of `aqualora_tpu/train/data.py:SyntheticDataset` (numpy only) for
one process: seeded uniform images in [-1, 1], NHWC float32, with captions,
in the same order for the same seed, so the two trainers see the same
pixels.  `make_dataset` is the trainers' factory; it refuses a path.  The
process sharding, the image-folder and HF datasets (PIL decode, the native
loader) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class SyntheticDataset:
    """Deterministic random images + captions (tests/benchmarks)."""

    resolution: int = 512
    size: int = 256

    def __len__(self):
        return self.size

    def batches(self, batch_size: int, seed: int = 0):
        """Yields (images [batch_size, res, res, 3] float32, captions)
        forever; each epoch is `size // batch_size` batches (at least one)
        from its own generator, as the JAX dataset's `drop_last` epochs."""
        n_batches = max(1, self.size // batch_size)
        epoch = 0
        while True:
            rng = np.random.default_rng(seed + 1000 * epoch)
            for _ in range(n_batches):
                imgs = rng.uniform(-1, 1, (batch_size, self.resolution,
                                           self.resolution, 3)).astype(np.float32)
                caps = [f"synthetic caption {int(x)}"
                        for x in rng.integers(0, 1000, batch_size)]
                yield imgs, caps
            epoch += 1


def make_dataset(path: Optional[str], resolution: int) -> SyntheticDataset:
    """The synthetic dataset at `resolution`.  A path is refused: the
    image-folder dataset is not ported, and a run must never train on
    noise in its place (the JAX factory refuses a path that is not a
    directory for the same reason)."""
    if path:
        raise NotImplementedError(
            f"dataset path {path!r}: the image-folder and HF datasets are "
            f"not ported yet; run without --dataset for synthetic images")
    return SyntheticDataset(resolution)
