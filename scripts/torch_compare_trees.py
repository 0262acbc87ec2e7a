#!/usr/bin/env python3
"""Time two checkouts of the PyTorch port on one CUDA card, in turns.

    python3 scripts/torch_compare_trees.py PARENT CHANGE

runs each tree's own `aqualora_torch` (its kernels built from that tree's
sources into its own `aqualora_torch/_build/`) in a process of its own, in
the order PARENT, CHANGE, CHANGE, PARENT, and prints one JSON line a run:

- `inject_wrapper_ms`: `fused_secret_inject` at the PPFT types (a bf16
  [8, 4, 64, 64] latent, bf16 SecretEncoder weights, 48 bits), CUDA events
  around 200 back-to-back calls: the wrapper's host cost, since its kernel
  takes microseconds;
- `fwd_f32_d512_b5_ms`: the float32 flash-attention forward at stage 1's
  (5, 1, 4096, 4096, 512), CUDA events around 10 calls;
- `stage1_f32_samples_per_s`: the stage-1 float32 step at 512^2 B5 (the
  CLI's defaults, set up as chip_smoke.py's phase 14), the median of 3
  steps after a warm-up.

Two calls may land on two cards, so compare versions only within one run
of this script.  PyTorch's own float32 products and convolutions run in
full float32 (TF32 off), as in chip_smoke.py.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(label: str) -> dict:
    """The three numbers of the tree in the working directory."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.getcwd())
    from aqualora_torch.ops import _build
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.ops import secret_inject as si
    from aqualora_torch.train import latent_wm_pretrain as s1
    _build.build_all(("flash_fwd", "flash_bwd", "secret_inject"))

    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    msg = torch.bernoulli(torch.full((8, 48), 0.5, device="cuda"),
                          generator=gen)
    weights = tuple(w.bfloat16() for w in (
        0.2 * rnd(1024, 48), 0.1 * rnd(1024), 0.1 * rnd(4, 4, 3, 3),
        0.1 * rnd(4)))
    latent = rnd(8, 4, 64, 64).bfloat16()
    inject_ms = time_ms(lambda: si.fused_secret_inject(
        latent, msg, *weights, base_res=32), 200)
    q, k, v = (rnd(5, 1, 4096, 512) for _ in range(3))
    fwd_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, 512 ** -0.5),
                     10, 2)
    del q, k, v

    args = s1.build_argparser().parse_args(
        ["--batch_size", "5", "--mixed_precision", "no", "--seed", "0"])
    tr = s1.build_trainer(args)
    with torch.no_grad():    # a non-zero encoder conv, as in phase 14
        w = tr.models.sec_encoder.conv_out.weight
        w.copy_(0.1 * torch.randn(w.shape, device="cuda", generator=torch
                                  .Generator(device="cuda").manual_seed(14)))
    ctl = s1.Control()
    batches = tr.dataset.batches(5, seed=0)
    times = []
    for step in range(4):
        pixels, _ = next(batches)
        draws = s1.draw(tr.models, tr.generator, (5, 3, 512, 512),
                        ctl.distort_probs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(pixels, draws, ctl)
        torch.cuda.synchronize()
        if step:
            times.append(time.perf_counter() - t0)
    return {"tree": label, "device": torch.cuda.get_device_name(0),
            "inject_wrapper_ms": inject_ms, "fwd_f32_d512_b5_ms": fwd_ms,
            "stage1_f32_samples_per_s": 5 / statistics.median(times),
            "stage1_f32_step_s": times}


def main(argv: list[str]) -> None:
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(argv[1])), flush=True)
        return
    if len(argv) != 2:
        raise SystemExit(__doc__)
    trees = {"parent": os.path.abspath(argv[0]),
             "change": os.path.abspath(argv[1])}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for label in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", label],
            cwd=trees[label], capture_output=True, text=True, check=True)
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
