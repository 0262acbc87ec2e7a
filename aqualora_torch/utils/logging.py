"""Experiment tracking for the trainers.

The port of `aqualora_tpu/utils/logging.py`.  The trainers print every
logged scalar to stdout themselves; the tracker adds TensorBoard (torch's
`SummaryWriter`, under `<output_dir>/logs`) when `report_to` is
"tensorboard" or "all" and the `tensorboard` package is installed, and
wandb when `report_to` is "wandb" or "all" and wandb is installed and
starts.  A writer that is missing is skipped with a printed line, as in the
JAX package; without an output directory there is no writer.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class Tracker:
    def __init__(self, output_dir: Optional[str],
                 report_to: str = "tensorboard",
                 config: Optional[Dict] = None):
        self.writers = []
        if output_dir is None:
            return
        if report_to in ("tensorboard", "all"):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"tensorboard tracking disabled ({e}); scalars go to "
                      "stdout only", flush=True)
            else:
                logs = os.path.join(output_dir, "logs")
                os.makedirs(logs, exist_ok=True)
                self.writers.append(("tb", SummaryWriter(logs)))
        if report_to in ("wandb", "all"):
            # any failure to start (not installed, no credentials) leaves
            # the other writers, as in the JAX package
            try:
                import wandb
                wandb.init(project="aqualora-tpu", dir=output_dir,
                           config=config or {})
                self.writers.append(("wandb", wandb))
            except Exception as e:
                print(f"wandb tracking disabled ({type(e).__name__}: {e}); "
                      "continuing with the remaining trackers", flush=True)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        for kind, w in self.writers:
            if kind == "tb":
                for k, v in metrics.items():
                    w.add_scalar(k, float(v), step)
            else:
                w.log(dict(metrics), step=step)

    def log_images(self, tag: str, images, step: int) -> None:
        """images: [N, H, W, 3] in [-1, 1] (numpy or a tensor)."""
        arr = ((np.asarray(images, np.float32) + 1) * 127.5).clip(
            0, 255).astype(np.uint8)
        for kind, w in self.writers:
            if kind == "tb":
                w.add_images(tag, arr, step, dataformats="NHWC")
            else:
                w.log({tag: [w.Image(a) for a in arr]}, step=step)

    def close(self) -> None:
        for kind, w in self.writers:
            if kind == "tb":
                w.close()
            else:
                try:
                    w.finish()
                except Exception:
                    pass
