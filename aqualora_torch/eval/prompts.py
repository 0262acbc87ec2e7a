"""Eval prompt list handling.

The port's own copy of `aqualora_tpu/eval/prompts.py` (the port imports
nothing of the JAX package); tests/test_torch_port_eval.py holds the two
equal.

The reference protocol uses `evaluation/prompt.txt` (100 prompts,
`run_eval_base.py:39-54`).  We load a user-supplied prompt file when given
(pass the reference's prompt.txt for exact protocol parity); otherwise a
built-in list of 100 original COCO-caption-style prompts keeps the
pipeline runnable standalone.
"""

from __future__ import annotations

import itertools
import os
from typing import List

_SUBJECTS = ["a red fox", "an old sailboat", "a street musician",
             "a mountain cabin", "a bowl of ramen", "two golden retrievers",
             "a vintage motorcycle", "a lighthouse", "an astronaut",
             "a jazz band"]
_SETTINGS = ["in a snowy forest", "at sunset by the ocean",
             "on a rainy city street", "inside a cozy library",
             "under northern lights", "in a blooming garden",
             "on a desert highway", "at a busy market",
             "on a foggy mountain pass", "in an art-deco hall"]


def builtin_prompts(n: int = 100) -> List[str]:
    out = [f"{s} {w}, highly detailed photograph"
           for s, w in itertools.product(_SUBJECTS, _SETTINGS)]
    if n > len(out):
        # don't silently run a benchmark on fewer prompts than requested
        raise ValueError(f"built-in prompt list has {len(out)} entries "
                         f"(< {n}); pass --prompt_file for larger runs")
    return out[:n]


def load_prompts(path: str | None = None, n: int = 100) -> List[str]:
    if path:
        # an explicitly requested prompt file must exist — silently
        # falling back to the builtin list would run the whole benchmark
        # on the wrong protocol (the reference crashes on a missing file)
        if not os.path.exists(path):
            raise FileNotFoundError(f"prompt file {path!r} not found")
        with open(path) as f:
            lines = [l.strip() for l in f if l.strip()]
        if len(lines) < n:
            # the multi-hour benchmark must not quietly run a smaller
            # protocol than the one the flags claim
            raise ValueError(f"prompt file {path!r} has {len(lines)} "
                             f"prompts, --num_prompts asked for {n}")
        return lines[:n]
    return builtin_prompts(n)
