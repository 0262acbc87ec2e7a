"""Training checkpoints: save a step's state, restore the latest or a given
step, keep at most `max_to_keep`.

The port of `aqualora_tpu/core/checkpoint.py` (an orbax manager).  Each
checkpoint here is one torch file, `<directory>/<step>.pt`, holding the
state with every tensor on the CPU: written to a temporary name and renamed,
so a crash mid-write leaves the previous checkpoints whole, and read back
with `weights_only=True`.  The files are the port's own, as `msgdecoder.pt`
is: the JAX package's orbax directories are not read.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _to_cpu(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


class CheckpointManager:
    """save(step, state) / restore(step=None) / latest_step(); after each
    save only the newest `max_to_keep` checkpoints stay (all of them when
    it is None)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: Any) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at `step` (the latest when None), tensors on the
        CPU; FileNotFoundError when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.isfile(self._path(step)):
            raise FileNotFoundError(
                f"no checkpoint {'' if step is None else step} in "
                f"{self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
