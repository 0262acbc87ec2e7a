#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA GPU and hold every kernel against
its plain version.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 0,2    # some phases (no kernels line)
    python3 chip_smoke.py --phases 15     # the publisher's chain only
    python3 chip_smoke.py --phases 16     # the chain, then the auditor's path

Phases (any failure raises, so the exit code is not 0):
  0. torch and CUDA versions, the card's name and power limit (nvidia-smi).
     Without a CUDA card the script stops here with an error.
  1. Build the three kernel sources of aqualora_torch/csrc (flash_fwd,
     flash_bwd, secret_inject), one nvcc each, all started together, and
     count the tensor-core instructions (HMMA, HGMMA) of every attention
     kernel in the built libraries with cuobjdump: each bfloat16 forward,
     dQ and dK/dV instance (`*_tc_kernel`) and the float32 d = 512
     forward, dQ and dK/dV instances (`*_d512_tc_kernel<float>`, 3xTF32)
     must have some, each other float32 instance (the CUDA-core kernels at
     d <= 160) none.
  2. The forward kernel against `flash_attention_plain` on the card at every
     attention shape of the serving path, O and lse: float32 and bfloat16
     at batch 2, then bfloat16 at the serving batch, where the tiling the
     kernel picks (printed: 16-row tiles or wide ones) is the one the
     generate call launches, and at the eval protocol's batch (4 images:
     2 x 4 for the U-Net under CFG, 4 for the VAE), whose tiling may
     differ.  Then the same at SD-2.1's 512^2 shapes, d = 64 at every level
     (the DP = 80 instances, 16 columns masked), self- and
     cross-attention.  At each batch two kernel calls must give the same
     bits; then the kernel's time, the plain version's, PyTorch's
     scaled_dot_product_attention's (a yardstick only: the port never
     calls it) and the H100 bound.
  3. The serving path: SD-1.5 at full width with seeded random bfloat16
     weights and the rank-320 message LoRA, one random 48-bit message folded
     into the U-Net, 8 prompts at 512x512, DDIM-25, CFG 7.5, VAE decode and
     SecretDecoder (EfficientNet-B1) bits.  Every generate call must launch
     the forward kernel exactly 801 times.  Then the first call once more,
     same seed, with this script swapping `flash_attention_fwd` for
     `flash_attention_plain`: its images must agree with the kernel's
     within PLAIN_SWAP_MAX_TOL and PLAIN_SWAP_MEAN_TOL (a supplement to
     phase 2: see their comment).
  4. The tiny serving slice on the card (kernel path) against the same
     slice on the CPU (plain path), same weights and initial latents.
  5. The backward kernels (dQ, dK/dV) against their plain versions at
     every differentiated attention shape of the training step, float32
     and bfloat16 (batch cut to 2); then at the training batch in bfloat16
     the forward against its plain version (the step's forward instances),
     each backward kernel's time and bound, and the pair's (flash_attention_bwd,
     delta included) beside the plain backward's.  At 64^2 self two
     bfloat16 calls must give the same bits.
  6. The secret-injection kernel against `inject_plain` at the training
     latent [8, 4, 64, 64], float32 and bfloat16 latents with float32 and
     bfloat16 weights (the PPFT trainer's are bf16), with its time and
     bound.  First of the profiled phases, one call under torch.profiler
     must run exactly one CUDA kernel, the injection's.
  7. The tiny PPFT step on the card (kernels) against the CPU (plain), the
     same weights and draws, float32: the loss and every trainable's
     gradient.
  8. The training path: one PPFT step of SD-1.5 at full width (rank-320
     LoRA on 192 sites, 48 bits, 512^2 synthetic pixels, B8, bfloat16
     frozen modules and float32 trainables, AdamW) through
     `aqualora_torch.train.ppft_train`, 1 warm-up and 3 timed steps.  Every
     step must launch 65 forward, 32 dQ, 32 dK/dV and 1 injection kernels;
     the loss and gradient norm must be finite and positive and the LoRA up
     weights must move.  After phase 12's profile, one more step under
     torch.profiler.
  9. SDPA's backward at each training shape, B8 bf16, as device time under
     torch.profiler (a yardstick for the pair; the port never calls it),
     beside the pair's own device time (delta, dQ and dK/dV kernels): at
     the small shapes phase 5's times are the host's launch cost.
 10. The forward kernel and SDPA's forward at each serving shape and batch,
     at the protocol's batch and at SD-2.1's d = 64 shapes, bf16, as device
     time under torch.profiler.
 11. One more generate call of phase 3's pipeline, kept from phase 3,
     under torch.profiler: the device's busy share of the median call, its
     largest kernels and the forward kernel's share (`--phases 11` runs
     phase 3 too).
 12. Stage 1's attention, the VAE mid-block at d = 512 differentiated
     through the watermarked decode: the d = 512 forward and backward
     kernels (dQ, dK/dV) against their plain versions at the stage-1 batch
     (5, 1, 4096, 4096, 512) and at a ragged (2, 1, 1000, 1000, 512),
     float32 and bfloat16, two calls of either type bit-identical; then at
     B5 each kernel's time, the plain version's and the bound (float32: at
     the 3xTF32 rate, beside the bound at the CUDA cores' float32 rate).
     After phase 10, the forward's and SDPA's forward, the pair's and SDPA's
     backward (a yardstick; the port never calls it) as device time under
     torch.profiler, with the SDPA backend torch picked.
 13. The tiny stage-1 step on the card (kernels) against the CPU (plain),
     the same weights and draws, float32: the loss and every trainable's
     gradient, once for each of the six stage-1 distortions.
 14. The stage-1 path: the full-width step through
     `aqualora_torch.train.latent_wm_pretrain` (SD-1.5 VAE, 48-bit
     SecretEncoder, EfficientNet-B1 SecretDecoder in train mode,
     LPIPS-VGG16, 512^2 synthetic pixels, B5), loss weights (5, 1, 1.5)
     and the late distortion probabilities, 1 warm-up and 3 timed steps in
     float32, then the same in bf16.  Every step must launch the d = 512
     forward 3 times and the dQ and dK/dV kernels once each; the loss must
     be finite and positive, every encoder and decoder parameter and the
     BatchNorm statistics must move.  After phase 12's profile, one step of
     each under torch.profiler: the busy share and the d = 512 pair's
     share of device time.
 15. The publisher's chain at full width, each stage through the entry
     point a user calls: stage 1 (`latent_wm_pretrain.run`, 512^2 B5 bf16,
     2 steps) writes pretrained_latentwm.pt to a temporary directory; PPFT
     (`ppft_train.run`, 512^2 B8 rank 320 bf16, 2 steps) starts from it
     with --start_from_pretrain, saves the LoRA, mapper and msgdecoder with
     --output_dir and runs its final sanity inference; the LoRA file must
     hold 384 tensors and a second export the same bytes (its size, write
     and read seconds printed), the PPFT SecretEncoder must be stage 1's bit
     for bit and float32; a fresh SD-1.5 pipeline loads the LoRA, mapper and
     decoder (bit for bit the trained ones), folds a message and generates
     8 images at 512^2 with DPM-Solver++(2M) 25 steps, CFG 7.5, from
     per-image generators: 801 forward launches a call, imgs/s (median of
     3 after a warm-up) beside phase 3's DDIM-25, peak memory, finite
     images, a repeat call bit-identical, row i of the initial latent the
     B1 draw of generator i, the decoded bit accuracy (printed only: the
     weights are random).  Each stage's launches are counted from 0.  Then
     the tiny dpms_m slice on the card against the CPU, as phase 4 for DDIM.
     The temporary directory stays until phase 16 ends.
 16. The auditor's path at full width on phase 15's artifacts, through the
     entry points a user calls (`--phases 16` runs phase 15 too):
     `aqualora_torch.eval.run_eval_base` with --train_folder --hidinfo
     (SD-1.5 512^2, dpms_m 25, CFG 7.5, bf16, batch 4, 8 prompts x 2 seeds:
     16 images written as PNGs, read back through the PIL-exact bicubic
     preprocess and decoded), then create_wm_lora's CLI and run_eval_base
     with --lora --msg_gt.  Every generate call must launch the forward
     801 times; 16 PNGs and eval_base.json as written; the PNGs must equal
     the device-quantized images and decode to the same bits; both flows
     must give the same images and fields.  Then simple_sample with four
     messages in one B4 batch (801 launches), each image beside the same
     message folded (printed).  Prints images/s end to end, the seconds of
     the parts (generate calls, quantize and fetch, PNG write, PNG read and
     preprocess, decode, the rest), peak memory and the bit accuracy
     (printed: the weights are random).
 17. The twelve samplers: each on the tiny slice on the card against the
     CPU (the stochastic ones with the same draws on both sides); then at
     full width (SD-1.5 512^2, B8, CFG 7.5, 25 steps, bf16, a folded
     message) one timed call each after a shared warm-up, beside DDIM-25's
     in the same run: finite images, forward launches = 32 per U-Net
     evaluation of the sampler + 1 (801; 833 for pndm; 1569 for heun,
     kdpm2, kdpm2a and dpms_s).
The timed phases run first (0-7, 12, 13, 14, 8, 15, 16, 17) and the profiled ones
after them, so that the profiler touches no timed phase: first the short
sessions (6's profile, 9, 10, 12's profile), then the profiles of whole
steps (8, 14) and of a generate call (11).  After a session of a whole
step, short sessions in the same process have recorded some device events
or none (PERF.md, section 7).  The line before the last names the card and its
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# H100 SXM data sheet: dense bf16 tensor-core rate, the float32 rate of the
# CUDA cores (the float32 kernels' units at d <= 160), the dense TF32
# tensor-core rate and HBM3 bandwidth.  The float32 d = 512 kernels do each
# product as three TF32 products (3xTF32): PEAK_TF32_FLOPS / 3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_PER_S = 3.35e12

# name, heads, Tq, Tk, head dim, serving batch (the CFG batch of 2 x 8
# prompts for the U-Net, 8 images for the VAE), launches per generate call
SHAPES = [
    ("unet64_self", 8, 4096, 4096, 40, 16, 125),
    ("unet64_cross", 8, 4096, 77, 40, 16, 125),
    ("unet32_self", 8, 1024, 1024, 80, 16, 125),
    ("unet32_cross", 8, 1024, 77, 80, 16, 125),
    ("unet16_self", 8, 256, 256, 160, 16, 125),
    ("unet16_cross", 8, 256, 77, 160, 16, 125),
    ("unet8_self", 8, 64, 64, 160, 16, 25),
    ("unet8_cross", 8, 64, 77, 160, 16, 25),
    ("vae_mid", 1, 4096, 4096, 512, 8, 1),
]
LAUNCHES_PER_GENERATE = sum(s[-1] for s in SHAPES)          # 801
# the eval protocol's batch (run_eval_base): 4 prompts, so 2 x 4 for the
# U-Net under CFG and 4 for the VAE; the bf16 tiling depends on the batch
PROTOCOL_IMAGES = 4
# SD-2.1 at 512^2: the JAX package sends d = 64 to the forward kernel at every
# level (flash_shapes_ok), which the port runs on its DP = 80 instances with
# 16 columns masked.  name, heads, Tq, Tk, head dim, serving batch (CFG of 8)
SD21_SHAPES = [
    ("sd21_64_self", 5, 4096, 4096, 64, 16),
    ("sd21_64_cross", 5, 4096, 77, 64, 16),
    ("sd21_32_self", 10, 1024, 1024, 64, 16),
    ("sd21_32_cross", 10, 1024, 77, 64, 16),
    ("sd21_16_self", 20, 256, 256, 64, 16),
    ("sd21_16_cross", 20, 256, 77, 64, 16),
    ("sd21_8_self", 20, 64, 64, 64, 16),
    ("sd21_8_cross", 20, 64, 77, 64, 16),
]
SOURCES = ("flash_fwd", "flash_bwd", "secret_inject")
# the differentiated attentions of one PPFT step at 512 px: name, heads,
# Tq, Tk, head dim, student launches per step (each also runs once in the
# teacher, forward only).  16 transformer blocks, self + cross each.
TRAIN_SHAPES = [
    ("unet64_self", 8, 4096, 4096, 40, 5),
    ("unet64_cross", 8, 4096, 77, 40, 5),
    ("unet32_self", 8, 1024, 1024, 80, 5),
    ("unet32_cross", 8, 1024, 77, 80, 5),
    ("unet16_self", 8, 256, 256, 160, 5),
    ("unet16_cross", 8, 256, 77, 160, 5),
    ("unet8_self", 8, 64, 64, 160, 1),
    ("unet8_cross", 8, 64, 77, 160, 1),
]
TRAIN_BATCH = 8
BWD_PER_STEP = sum(s[-1] for s in TRAIN_SHAPES)              # 32
# forward launches per step: teacher and student at every shape, plus the
# VAE encoder's mid-block (H1, T4096, d512)
FWD_PER_STEP = 2 * BWD_PER_STEP + 1                          # 65
TRAIN_STEPS = 4                # 1 warm-up + 3 timed
CHECK_BATCH = 2
# max abs error allowed against the plain version.  float32 O: both sides
# accumulate in float32 in different orders (~1e-6).  lse is float32 on both
# sides for either input type.
TOL_F32 = 1e-4
TOL_LSE = 1e-4
TINY_IMAGE_TOL = 2e-3
# tiny PPFT step, card against CPU (float32, TF32 off): the loss to 1e-4
# relative; each gradient to 1e-3 of its leaf's largest value, since the
# card sums in other orders (cuDNN's convolutions, the kernels' tiles)
# through the whole U-Net and its backward
TINY_LOSS_RTOL = 1e-4
TINY_GRAD_TOL = 1e-3
# phase 3, the kernel's generate call against the same call with the plain
# forward, images in [-1, 1]: the 25 denoising steps amplify single bf16
# ulps of O, so the earlier float32 CUDA-core forward already gave max |d|
# 0.8096 and mean |d| 0.0382 (and other bits) on an NVIDIA H100 80GB HBM3,
# one seed.  The limits are twice those readings.  The max limit spans most
# of the range of 2 and cannot fail a wrong kernel; the mean limit can.
# The kernel's correctness is phase 2's check of every instance the paths
# launch; this one shows how far a whole call drifts.
PLAIN_SWAP_MAX_TOL = 1.62
PLAIN_SWAP_MEAN_TOL = 0.076
# stage 1: the VAE mid-block's single-head attention (T 4096 at 512 px, d
# 512), differentiated through the watermarked decode.  name, batch, heads,
# Tq, Tk, head dim; the first is the stage-1 batch (the CLI default).
S1_SHAPES = [("vae_mid_b5", 5, 1, 4096, 4096, 512),
             ("vae_mid_ragged", 2, 1, 1000, 1000, 512)]
S1_BATCH = 5
S1_RES = 512
S1_STEPS = 4                   # 1 warm-up + 3 timed, per type
# launches of one stage-1 step: the forward in the encode, the clean decode
# and the watermarked decode; the backward in the watermarked decode
S1_PER_STEP = {"fwd": 3, "dq": 1, "dkv": 1, "inject": 0}
S1_KEY = (1, 4096, 4096, 512)
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of `fn`: the CUDA kernels' time under
    torch.profiler over `iters` calls, so host gaps between its launches do
    not count.  NaN if the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else float("nan")


def tolerance_o(dtype: torch.dtype, o_ref: torch.Tensor) -> float:
    """bfloat16 O is rounded on both sides from float32 values that differ
    by the float32 limit, so an element may differ by one bf16 ulp at its own
    magnitude: at most 2^-7 * max|O_ref|, which scales with O (about
    Tk^-1/2 at randn inputs)."""
    if dtype == torch.float32:
        return TOL_F32
    return 2.0 ** -7 * o_ref.float().abs().max().item() + TOL_F32


def attention_bound(b, h, tq, tk, d, elem_bytes=2, peak=PEAK_BF16_FLOPS):
    """The forward's least time: QK^T and PV, or the bytes of q, k, v read
    once and o (+ float32 lse) written once."""
    return bound(4.0 * b * h * tq * tk * d,
                 (2 * b * h * tq * d + 2 * b * h * tk * d) * elem_bytes
                 + 4 * b * h * tq, peak)


def tolerance_grad(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """float32 gradients: both sides accumulate in float32 in other orders
    over up to Tq or Tk terms, so 1e-4 of the largest reference gradient
    plus 1e-5.  bfloat16 adds one bf16 ulp at that value (2^-7 of it):
    each side rounds its float32 gradient once."""
    m = ref.float().abs().max().item()
    tol = 1e-4 * m + 1e-5
    return tol if dtype == torch.float32 else tol + 2.0 ** -7 * m


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    """Least time on the card, ms: the operations at `peak` (the bf16
    tensor-core rate unless said otherwise) or the bytes at the HBM rate,
    whichever is larger."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_bounds(b, h, tq, tk, d, elem_bytes=2, peak=PEAK_BF16_FLOPS) -> dict:
    """Per kernel and for the pair: operations are 2*Tq*Tk*d per product
    and (b, h); dQ computes S, dP and dQ (3), dK/dV computes S, dP, dV and dK
    (4), the pair's least work is S, dP, dQ, dK, dV (5).  Bytes: each input
    read once and each output written once, lse and delta float32."""
    bh, e = b * h, elem_bytes
    row_q, row_k, stats = bh * tq * d * e, bh * tk * d * e, 2 * 4 * bh * tq
    prod = 2.0 * bh * tq * tk * d
    return {
        "dq": bound(3 * prod, 3 * row_q + 2 * row_k + stats, peak),
        "dkv": bound(4 * prod, 2 * row_q + 4 * row_k + stats, peak),
        "pair": bound(5 * prod, 4 * row_q + 4 * row_k + stats, peak),  # + o
    }


def phase0() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = nvidia_smi()
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" | nvidia-smi: {smi}", flush=True)
    # state both precisions: float32 products and convolutions in full
    # float32, so the float32 comparisons hold the kernel to float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[0] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def tensor_core_counts(name: str) -> dict:
    """{kernel symbol: (HMMA, HGMMA)} of the built csrc/<name>.cu, from
    cuobjdump -sass of the toolkit that built it."""
    from aqualora_torch.ops import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][1] += "HGMMA" in line
            counts[fn][0] += "HMMA" in line and "HGMMA" not in line
    return {f: tuple(c) for f, c in counts.items()}


def phase1():
    from aqualora_torch.ops import _build
    seconds = _build.build_all(SOURCES, verbose=True)
    for name in SOURCES:
        print(f"[1] built csrc/{name}.cu in {seconds[name]:.1f} s "
              f"(all {len(SOURCES)} nvcc started together)", flush=True)
    # bf16 instances: forward 3 head-dim tiles x 2 row tilings + d = 512;
    # backward 3 x 2 x (dQ, dK/dV) + d = 512 x (dQ, dK/dV).  float32 on the
    # tensor cores (3xTF32): the d = 512 forward, dQ and dK/dV.  float32 on
    # the CUDA cores (d <= 160): forward 3, backward 3 x (dQ, dK/dV).
    for name, n_tc, n_tf32, n_f32 in (("flash_fwd", 7, 1, 3),
                                      ("flash_bwd", 14, 2, 6)):
        counts = tensor_core_counts(name)
        for fn, (hmma, hgmma) in sorted(counts.items()):
            print(f"[1] {name} SASS {fn}: HMMA {hmma} HGMMA {hgmma}",
                  flush=True)
        # the float32 instances of the d = 512 template, mangled or not
        tf32 = {fn: c for fn, c in counts.items()
                if re.search(r"d512_tc_kernel(IfE|<float>)", fn)}
        tc = {fn: c for fn, c in counts.items()
              if "_tc_kernel" in fn and fn not in tf32}
        f32 = {fn: c for fn, c in counts.items()
               if fn not in tc and fn not in tf32}
        if len(tc) != n_tc or not all(sum(c) > 0 for c in tc.values()):
            raise AssertionError(f"{name}: bf16 instances without "
                                 f"tensor-core instructions: {tc}")
        if len(tf32) != n_tf32 or not all(sum(c) > 0 for c in tf32.values()):
            raise AssertionError(f"{name}: float32 d = 512 instances without "
                                 f"tensor-core instructions: {tf32}")
        if len(f32) != n_f32 or any(sum(c) for c in f32.values()):
            raise AssertionError(f"{name}: CUDA-core float32 instances with "
                                 f"tensor-core instructions: {f32}")


def counters() -> dict:
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.ops import secret_inject as si
    return {"fwd": fa.launches, "dq": fa.dq_launches,
            "dkv": fa.dkv_launches, "inject": si.launches}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def counts() -> dict:
    return {k: c.count for k, c in counters().items()}


def check_fwd(tag: str, q, k, v, scale: float, out=None) -> float:
    """Hold the forward kernel's (o, lse) (`out`, else one call) against
    `flash_attention_plain` on the same inputs; print the line, with the
    query rows per block of the bf16 instance that ran, and return max|dO|."""
    from aqualora_torch.ops import flash_attention as fa
    o, lse = fa.flash_attention_fwd(q, k, v, scale) if out is None else out
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    tol_o = tolerance_o(q.dtype, o_ref)
    b, h, tq, d = q.shape
    tiles = (f", {fa.fwd_tile_rows(q)}-row tiles"
             if q.dtype == torch.bfloat16 else "")
    line = (f"{tag} B{b} H{h} Tq{tq} Tk{k.shape[2]} d{d} {str(q.dtype)[6:]}"
            f"{tiles}: max|dO| {err_o:.3e} (tol {tol_o:.3e}, "
            f"{err_o / tol_o:.2f} of it, max|O| "
            f"{o_ref.float().abs().max().item():.3e}) max|dlse| {err_l:.3e} "
            f"(tol {TOL_LSE:g})")
    print(line, flush=True)
    if not (err_o <= tol_o and err_l <= TOL_LSE):
        raise AssertionError(f"kernel disagrees with plain: {line}")
    return err_o


def check_serving_shape(tag: str, h, tq, tk, d, b, gen, smi: str,
                        at_b2: bool = True) -> dict:
    """The forward at one attention shape: float32 and bf16 against the
    plain version at batch 2 (`at_b2`), then bf16 at batch `b`, whose
    tiling is the one a call at that batch launches: two calls bit-identical,
    against the plain version, then the kernel's, the plain version's and
    SDPA's times (SDPA a yardstick only: the port never calls it) and the
    H100 bound.  Returns the row."""
    from aqualora_torch.ops import flash_attention as fa
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16) if at_b2 else ():
        q, k, v = (torch.randn(CHECK_BATCH, h, t, d, device="cuda",
                               generator=gen).to(dtype)
                   for t in (tq, tk, tk))
        check_fwd(f"[2] {tag}", q, k, v, scale)
        del q, k, v
    q, k, v = (torch.randn(b, h, t, d, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for t in (tq, tk, tk))
    first, again = (fa.flash_attention_fwd(q, k, v, scale) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{tag}: two forward calls differ")
    err = check_fwd(f"[2] {tag}", q, k, v, scale, out=first)
    del first, again
    kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale),
                       iters=3, warmup=1)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale))
    bound_ms, bound_by = attention_bound(b, h, tq, tk, d)
    print(f"[2] {tag} B{b} bf16 (two calls bit-identical): "
          f"kernel_ms {kernel_ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms(sdpa) {library_ms:.4f} "
          f"= {kernel_ms / library_ms:.2f}x, bound_ms {bound_ms:.4f} "
          f"({bound_by}) | {smi}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def protocol_shapes():
    """SHAPES at the eval protocol's batch: (key, name, heads, Tq, Tk, d,
    batch)."""
    return [(f"protocol_b{PROTOCOL_IMAGES}/{name}", name, h, tq, tk, d,
             b * PROTOCOL_IMAGES // N_IMG)
            for name, h, tq, tk, d, b, _ in SHAPES]


def phase2(smi: str) -> dict:
    """Every serving shape at batch 2 and at the serving batch, each of them
    at the protocol's batch, and SD-2.1's d = 64 shapes; rows keyed by the
    shape's name (the protocol's under `protocol_b4/`)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, h, tq, tk, d, serve_b, _ in SHAPES:
        rows[name] = check_serving_shape(name, h, tq, tk, d, serve_b, gen,
                                         smi)
    for key, name, h, tq, tk, d, b in protocol_shapes():
        rows[key] = check_serving_shape(key, h, tq, tk, d, b, gen, smi,
                                        at_b2=False)
    for name, h, tq, tk, d, serve_b in SD21_SHAPES:
        rows[name] = check_serving_shape(name, h, tq, tk, d, serve_b, gen,
                                         smi)
    return rows


N_IMG, STEPS, RES = 8, 25, 512
PROMPTS = ["a photograph of an astronaut riding a horse",
           "a watercolor of a lighthouse at dusk",
           "a bowl of ramen, studio lighting",
           "a red fox in fresh snow",
           "an isometric city block at night",
           "a portrait of an old fisherman",
           "a field of sunflowers under storm clouds",
           "a cat reading a newspaper"]


def serving_setup():
    """SD-1.5 at full width with seeded random bf16 weights, the rank-320
    LoRA with one folded message, the SecretDecoder, 8 prompts; returns
    (run, decoder, msg_bits), run(seed) being one generate call."""
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.models.watermark import SecretDecoder

    cfg = PipelineConfig.sd15(lora_rank=320)
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16, device="cuda")
    pipe.init_params(seed=0)
    decoder = SecretDecoder(cfg.watermark.msg_bits, EfficientNetConfig.b1(),
                            dtype=torch.bfloat16).eval()
    init_module_weights(decoder, torch.Generator(device="cuda").manual_seed(1))
    msg = torch.bernoulli(torch.full((cfg.watermark.msg_bits,), 0.5),
                          generator=torch.Generator().manual_seed(2))
    pipe.fold_message(msg)
    tok = FallbackTokenizer(cfg.clip.vocab_size)
    ids, neg = tok(PROMPTS), tok([""] * N_IMG)
    generate = pipe.make_generate(num_steps=STEPS, sampler="ddim",
                                  height=RES, width=RES)
    torch.cuda.synchronize()
    print(f"[3] SD-1.5 bf16 weights ready in "
          f"{time.perf_counter() - t0:.1f} s (rank-320 LoRA folded)",
          flush=True)

    def run(seed):
        return generate(ids, neg, guidance_scale=7.5,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(seed))

    return run, decoder, cfg.watermark.msg_bits


def phase3(smi: str) -> tuple:
    """The serving path; returns its launches per shape, the median call in
    seconds and the generate call, which phase 11 profiles."""
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.ops import flash_attention as fa

    run, decoder, msg_bits = serving_setup()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                              # counts start here
    images = run(3)
    torch.cuda.synchronize()
    by_shape = dict(fa.launches.by_shape)
    total = fa.launches.count
    print(f"[3] kernel launches in one generate call: {counts()}", flush=True)
    if total != LAUNCHES_PER_GENERATE:
        raise AssertionError(f"{total} launches, want {LAUNCHES_PER_GENERATE}")
    if counts() != {"fwd": total, "dq": 0, "dkv": 0, "inject": 0}:
        raise AssertionError("serving launched a training kernel")
    launches = {}
    for name, h, tq, tk, d, _, want in SHAPES:
        got = by_shape.get((h, tq, tk, d), 0)
        if got != want:
            raise AssertionError(f"{name}: {got} launches, want {want}")
        launches[name] = got
    if tuple(images.shape) != (N_IMG, RES, RES, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise AssertionError("non-finite image values")
    if images.min() < -1 or images.max() > 1:
        raise AssertionError("images outside [-1, 1]")
    bits, margins = decode_bits(decoder, images)
    if tuple(bits.shape) != (N_IMG, msg_bits):
        raise AssertionError(f"bits {tuple(bits.shape)}")
    if not torch.isfinite(margins).all():
        raise AssertionError("non-finite decoder margins")
    print(f"[3] images {tuple(images.shape)} finite in "
          f"[{images.min().item():.3f}, {images.max().item():.3f}] "
          f"std {images.float().std().item():.3f}; bits "
          f"{tuple(bits.shape)}, first "
          f"{''.join(map(str, bits[0].tolist()))}", flush=True)

    times = []
    for i in range(3):
        before = fa.launches.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(10 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if fa.launches.count - before != LAUNCHES_PER_GENERATE:
            raise AssertionError("launch count changed between calls")
    med = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[3] generate 8 x 512^2 DDIM-25 CFG 7.5 bf16: "
          f"{N_IMG / med:.4f} imgs/s (median of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)} s), peak memory "
          f"{peak_gib:.2f} GiB | {smi}", flush=True)

    # the first call again with the plain forward in the kernel's place
    kernel_fwd, before = fa.flash_attention_fwd, fa.launches.count
    fa.flash_attention_fwd = fa.flash_attention_plain
    try:
        plain_images = run(3)
    finally:
        fa.flash_attention_fwd = kernel_fwd
    diff = (images.float() - plain_images.float()).abs()
    same_bits = torch.equal(bits, decode_bits(decoder, plain_images)[0])
    print(f"[3] the same call with the plain forward "
          f"({fa.launches.count - before} kernel launches): max|d image| "
          f"{diff.max().item():.4e} (tol {PLAIN_SWAP_MAX_TOL:g}), mean "
          f"{diff.mean().item():.4e} (tol {PLAIN_SWAP_MEAN_TOL:g}), images "
          f"bit-identical {torch.equal(images, plain_images)}, bits equal "
          f"{same_bits}", flush=True)
    if not (diff.max().item() <= PLAIN_SWAP_MAX_TOL
            and diff.mean().item() <= PLAIN_SWAP_MEAN_TOL
            and fa.launches.count == before):
        raise AssertionError("the kernel's images disagree with the plain "
                             "forward's")
    del decoder, images, plain_images, diff
    torch.cuda.empty_cache()
    return launches, med, run


def phase4():
    """Tiny slice: kernel path on the card against the plain path on the
    CPU, float32, the same weights and the same initial latents."""
    import numpy as np

    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                          device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(seed=5)
    pipes["cuda"].load_state_from(pipes["cpu"])
    decs = {dev: SecretDecoder(cfg.watermark.msg_bits,
                               EfficientNetConfig.tiny(), device=dev).eval()
            for dev in ("cpu", "cuda")}
    init_module_weights(decs["cpu"], torch.Generator().manual_seed(6))
    decs["cuda"].load_state_dict(decs["cpu"].state_dict())
    rng = np.random.default_rng(7)
    msg = torch.from_numpy(rng.integers(0, 2, cfg.watermark.msg_bits)
                           .astype(np.float32))
    z = rng.standard_normal((2, 16, 16, cfg.unet.in_channels),
                            dtype=np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    out = {}
    fa.launches.reset()
    for dev, pipe in pipes.items():
        pipe.fold_message(msg)
        gen = pipe.make_generate(num_steps=2, sampler="ddim", height=32,
                                 width=32)
        images = gen(ids, neg, guidance_scale=7.5,
                     z=torch.from_numpy(z).to(dev))
        bits, _ = decode_bits(decs[dev], images)
        out[dev] = (images.cpu(), bits.cpu())
    err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    same_bits = torch.equal(out["cuda"][1], out["cpu"][1])
    print(f"[4] tiny slice card vs CPU: max|d image| {err:.3e} "
          f"(tol {TINY_IMAGE_TOL:g}), bits equal {same_bits}, kernel "
          f"launches {fa.launches.count}", flush=True)
    if not (err <= TINY_IMAGE_TOL and same_bits and fa.launches.count > 0):
        raise AssertionError("tiny slice on the card disagrees with the CPU")


def phase5(smi: str) -> dict:
    """The backward kernels against their plain versions at every
    differentiated attention shape of the training step; times at B8."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, h, tq, tk, d, _ in TRAIN_SHAPES:
        scale = d ** -0.5
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(CHECK_BATCH, h, tq, d, device="cuda",
                                 generator=gen).to(dtype) for _ in range(2))
            k, v = (torch.randn(CHECK_BATCH, h, tk, d, device="cuda",
                                generator=gen).to(dtype) for _ in range(2))
            o, lse = fa.flash_attention_plain(q, k, v, scale)
            delta = fa.attention_delta(o, do)
            got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
                   *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               scale))
            want = (fa.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                scale),
                    *fa.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                  scale))
            torch.cuda.synchronize()
            parts = []
            for gname, g, r in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - r.float()).abs().max().item()
                tol = tolerance_grad(dtype, r)
                parts.append(f"{gname} {err:.3e} (tol {tol:.3e}, max "
                             f"{r.float().abs().max().item():.3e})")
                if not err <= tol:
                    raise AssertionError(f"backward kernel disagrees with "
                                         f"plain: {name} {dtype} {gname} "
                                         f"{err} > {tol}")
                errs[(dtype, gname)] = err
            print(f"[5] {name} B{CHECK_BATCH} H{h} Tq{tq} Tk{tk} d{d} "
                  f"{str(dtype)[6:]}: " + ", ".join(parts), flush=True)
            del q, k, v, do, o, lse, delta, got, want
        b = TRAIN_BATCH
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        # the training batch's forward instance, which the step launches
        check_fwd(f"[5] {name} forward", q, k, v, scale, out=(o, lse))
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        t = {"dq": time_ms(lambda: fa.flash_attention_bwd_dq(*args)),
             "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(*args)),
             "pair": time_ms(lambda: fa.flash_attention_bwd(
                 q, k, v, o, lse, do, scale)),
             "dq_plain": time_ms(lambda: fa.flash_attention_dq_plain(*args),
                                 iters=3, warmup=1),
             "dkv_plain": time_ms(
                 lambda: fa.flash_attention_dkv_plain(*args), iters=3,
                 warmup=1),
             "pair_plain": time_ms(lambda: fa.flash_attention_bwd_plain(
                 q, k, v, o, lse, do, scale), iters=3, warmup=1)}
        if name == "unet64_self":
            first = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            print(f"[5] {name} B{b} bf16: two backward calls bit-identical "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError("the backward kernels are not "
                                     "deterministic")
            del first, again
        bounds = bwd_bounds(b, h, tq, tk, d)
        print(f"[5] {name} B{b} bf16: dq kernel_ms {t['dq']:.4f} plain_ms "
              f"{t['dq_plain']:.4f} bound_ms {bounds['dq'][0]:.4f} "
              f"({bounds['dq'][1]}); dkv kernel_ms {t['dkv']:.4f} plain_ms "
              f"{t['dkv_plain']:.4f} bound_ms {bounds['dkv'][0]:.4f} "
              f"({bounds['dkv'][1]}) | {smi}", flush=True)
        print(f"[5] {name} B{b} bf16 dQ + dK/dV pair: kernel_ms "
              f"{t['pair']:.4f} plain_ms {t['pair_plain']:.4f} bound_ms "
              f"{bounds['pair'][0]:.4f} ({bounds['pair'][1]}) | {smi}",
              flush=True)
        for kern in ("dq", "dkv"):
            err = errs[(torch.bfloat16, "dq")] if kern == "dq" else max(
                errs[(torch.bfloat16, "dk")], errs[(torch.bfloat16, "dv")])
            rows[(kern, name)] = {
                "max_abs_err": err, "ms": t[kern],
                "plain_ms": t[f"{kern}_plain"], "bound_ms": bounds[kern][0],
                "bound_by": bounds[kern][1], "library_ms": None}
        rows[("pair", name)] = t["pair"]
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    return rows


def inject_inputs(wdtype: torch.dtype, seed: int = 6) -> tuple:
    """The training latent's message and SecretEncoder weights [8, 48],
    dense [1024, 48] and [1024], conv [4, 4, 3, 3] and [4], the weights in
    `wdtype`, and a float32 latent maker."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    b, c, res, base, bits = TRAIN_BATCH, 4, 64, 32, 48
    msg = torch.bernoulli(torch.full((b, bits), 0.5, device="cuda"),
                          generator=gen)
    weights = tuple(w.to(wdtype) for w in (
        0.2 * rnd(base * base, bits), 0.1 * rnd(base * base),
        0.1 * rnd(c, c, 3, 3), 0.1 * rnd(c)))
    return msg, weights, lambda: rnd(b, c, res, res)


def phase6(smi: str) -> dict:
    """The injection kernel against `inject_plain` at the training latent,
    float32 and bf16 latents and weights; the time and bound at the PPFT
    trainer's types (bf16 latent, bf16 weights)."""
    from aqualora_torch.ops import secret_inject as si
    b, c, res, base, bits = TRAIN_BATCH, 4, 64, 32, 48
    row = {}
    for wdtype in (torch.float32, torch.bfloat16):
        msg, weights, latent_of = inject_inputs(wdtype)
        for dtype in (torch.float32, torch.bfloat16):
            latent = latent_of().to(dtype)
            before = si.launches.count
            out = si.fused_secret_inject(latent, msg, *weights,
                                         base_res=base)
            ref = si.inject_plain(latent, msg, *weights, base_res=base)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # float32: float32 sums in other orders; bf16: one ulp at the
            # output's largest value (both sides round float32 once)
            tol = 1e-5 if dtype == torch.float32 else \
                2.0 ** -7 * ref.float().abs().max().item() + 1e-5
            line = (f"[6] inject [{b}, {c}, {res}, {res}] latent "
                    f"{str(dtype)[6:]}, weights {str(wdtype)[6:]}: max|d| "
                    f"{err:.3e} (tol {tol:.3e}, {err / tol:.2f} of it)")
            print(line, flush=True)
            if not (err <= tol and si.launches.count == before + 1):
                raise AssertionError(f"inject kernel disagrees: {line}")
            row["max_abs_err"] = err       # the last: the PPFT types
    args = (latent, msg, *weights)
    ms = time_ms(lambda: si.fused_secret_inject(*args, base_res=base),
                 iters=100)
    plain_ms = time_ms(lambda: si.inject_plain(*args, base_res=base),
                       iters=100)
    n, cells = b * c * res * res, base * base
    # bytes: latent in and out, msg (float32), the dense and conv weights
    # and biases (bf16), each once; operations: the dense layer (a
    # multiply-add per bit, the bias) and the stencil (nine multiply-adds,
    # the latent and the bias), SiLU not counted
    nbytes = (2 * 2 * n + 4 * b * bits
              + 2 * (cells * bits + cells + 9 * c * c + c))
    bound_ms, bound_by = bound(b * cells * (2.0 * bits + 1) + 20.0 * n,
                               nbytes)
    print(f"[6] inject B{b} bf16 latent and weights: kernel_ms {ms:.4f} (the "
          f"whole wrapper: one launch) plain_ms {plain_ms:.4f} library_ms "
          f"none (no one PyTorch call computes it) bound_ms "
          f"{bound_ms:.6f} ({bound_by}) | {smi}", flush=True)
    row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
    return row


def phase6_profile(smi: str) -> None:
    """One injection call at the PPFT types under torch.profiler: it must
    run exactly one CUDA kernel, the injection's; then its device time."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.ops import secret_inject as si
    msg, weights, latent_of = inject_inputs(torch.bfloat16)
    args = (latent_of().to(torch.bfloat16), msg, *weights)
    si.fused_secret_inject(*args, base_res=32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        si.fused_secret_inject(*args, base_res=32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = device_ms(lambda: si.fused_secret_inject(*args, base_res=32),
                    iters=20)
    print(f"[6] one inject call B{TRAIN_BATCH} bf16 runs {len(kernels)} CUDA "
          f"kernel(s): {kernels}; its device time {dev:.4f} ms | {smi}",
          flush=True)
    if len(kernels) != 1 or "secret_inject_kernel" not in kernels[0]:
        raise AssertionError(f"one inject call ran {kernels}")


def phase7():
    """Tiny PPFT step: the card (kernels) against the CPU (plain versions),
    float32, the same weights and the same draws, at 32 px so that the
    latent is 2 * secret_grid and the fused injection is taken."""
    import numpy as np

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.models.watermark import SecretEncoder
    from aqualora_torch.train import ppft_train as pt

    cfg = PipelineConfig.tiny()
    wm = cfg.watermark
    gen = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(12)
    pixels = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    losses, grads = {}, {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        pipe = StableDiffusionPipeline(cfg, dtype=torch.float32, device=dev)
        sec = SecretEncoder(wm.msg_bits, wm.secret_grid, 16,
                            cfg.vae.latent_channels).to(dev)
        if side == "cpu":
            pipe.init_params(seed=11)
            init_module_weights(sec, gen)          # non-zero conv_out too
            cpu_pipe, cpu_sec = pipe, sec
            draws = pt.draw(pipe, gen, pixels)
        else:
            pipe.load_state_from(cpu_pipe)
            sec.load_state_dict(cpu_sec.state_dict())
            reset_counts()
        sec.requires_grad_(False)
        groups = pt.trainable_groups(pipe)
        loss, _ = pt.make_loss_fn(pipe, sec)(
            pixels, ids, pt.Draws(*(t.to(dev) for t in (
                draws.msg, draws.vae_noise, draws.noise, draws.t))))
        loss.backward()
        losses[side] = loss.item()
        grads[side] = [p.grad.cpu() for params in groups.values()
                       for p in params]
    launched = counts()
    worst = max(((g - r).abs().max() / r.abs().max()).item()
                for g, r in zip(grads["card"], grads["cpu"]))
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"[7] tiny PPFT step card vs CPU: loss {losses['card']:.6e} vs "
          f"{losses['cpu']:.6e} (rel {rel:.2e}, tol {TINY_LOSS_RTOL:g}); "
          f"{len(grads['cpu'])} trainable gradients, worst "
          f"max|d|/max|g| {worst:.2e} (tol {TINY_GRAD_TOL:g}); kernel "
          f"launches {launched}", flush=True)
    if not (rel <= TINY_LOSS_RTOL and worst <= TINY_GRAD_TOL
            and losses["cpu"] > 0 and min(launched.values()) > 0):
        raise AssertionError("tiny PPFT step on the card disagrees with the "
                             "CPU or skipped a kernel")


# substrings of the kernels' symbols: flash_bwd_dq matches the float32
# flash_bwd_dq_kernel and the bf16 flash_bwd_dq_tc_kernel, and not dK/dV's;
# flash_fwd every forward instance
KERNEL_NAMES = {"flash_fwd": "flash fwd", "flash_bwd_dq": "dQ",
                "flash_bwd_dkv": "dK/dV", "secret_inject_kernel": "inject"}


def profile_step(tr, step_s: float, smi: str) -> None:
    """One more training step under torch.profiler: device time by kernel
    name, the port's kernels summed, and the busy share of the median
    unprofiled step (the profiler's own cost is on the host, so the device
    times hold; the wall time under it does not)."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.train import ppft_train as pt
    pixels, captions = next(tr.batches)
    ids = tr.tokenizer(captions)
    draws = pt.draw(tr.pipe, tr.generator, pixels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(pixels, ids, draws)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print("[8] device time by kernel: not measured (the profiler saw no "
              "CUDA kernel)", flush=True)
        return
    ours = {label: 0.0 for label in KERNEL_NAMES.values()}
    for e in events:
        for key, label in KERNEL_NAMES.items():
            if key in e.key:
                ours[label] += e.self_device_time_total / 1e3
    print(f"[8] profiled step: device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (step_s * 1e3):.1f}% of the {step_s * 1e3:.1f} "
          f"ms median step; the port's kernels "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in ours.items())
          + f" ({100 * sum(ours.values()) / busy_ms:.1f}% of device time) "
          f"| {smi}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[8]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d}"
              f" {e.key[:100]}", flush=True)


def phase8(smi: str) -> tuple:
    """The training path at full width through the trainer's entry point;
    returns the launches per shape and of the injection, and the trainer
    with its median step, for the profiled step after phase 12's profile."""
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.ops import secret_inject as si
    from aqualora_torch.train import ppft_train as pt

    args = pt.build_argparser().parse_args([
        "--rank", "320", "--msg_bits", "48", "--resolution", "512",
        "--train_batch_size", str(TRAIN_BATCH), "--mixed_precision", "bf16",
        "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
        "--max_train_steps", str(TRAIN_STEPS), "--seed", "0"])
    # phase 3's pipeline stays resident for phase 11: the step's peak is
    # counted above it
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr = pt.build_trainer(args)
    # a non-zero SecretEncoder conv stands in for stage 1's weights (phase
    # 15 loads real ones with --start_from_pretrain): with its zero init
    # and the zero-init LoRA ups, student == teacher and the loss and every
    # gradient are exactly 0
    with torch.no_grad():
        w = tr.sec_encoder.conv_out.weight
        w.copy_(0.1 * torch.randn(w.shape, device="cuda",
                                  generator=torch.Generator(device="cuda")
                                  .manual_seed(21)))
    ups = {n: p.detach().clone() for n, p in pt.split_lora(tr.pipe.unet)[1]
           .items() if n.endswith("up.weight")}
    torch.cuda.synchronize()
    print(f"[8] SD-1.5 trainer ready in {time.perf_counter() - t0:.1f} s: "
          f"{len(ups)} LoRA sites, rank {tr.pipe.config.unet.lora.rank}, "
          f"{sum(p.numel() for g in tr.groups.values() for p in g)} "
          f"float32 trainables, frozen modules in bf16", flush=True)
    want = {"fwd": FWD_PER_STEP, "dq": BWD_PER_STEP, "dkv": BWD_PER_STEP,
            "inject": 1}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                              # counts start here
    times = []
    for step in range(TRAIN_STEPS):
        pixels, captions = next(tr.batches)
        ids = tr.tokenizer(captions)
        draws = pt.draw(tr.pipe, tr.generator, pixels)
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = tr.train_step(pixels, ids, draws)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = {k: v - before[k] for k, v in counts().items()}
        loss, gnorm = (float(metrics[k]) for k in ("ppft_loss", "grad_norm"))
        print(f"[8] step {step}: {dt:.4f} s, ppft_loss {loss:.6e}, "
              f"grad_norm {gnorm:.6e}, launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"launches {got} in one step, want {want}")
        if not (math.isfinite(loss) and loss > 0 and math.isfinite(gnorm)
                and gnorm > 0):
            raise AssertionError("loss or gradient norm not finite positive")
        if step:
            times.append(dt)
    per_shape = {}
    for name, h, tq, tk, d, n in TRAIN_SHAPES:
        key = (h, tq, tk, d)
        got = (fa.launches.by_shape[key], fa.dq_launches.by_shape[key],
               fa.dkv_launches.by_shape[key])
        if got != (2 * n * TRAIN_STEPS, n * TRAIN_STEPS, n * TRAIN_STEPS):
            raise AssertionError(f"{name}: launches {got}")
        per_shape[name] = n * TRAIN_STEPS
    if fa.launches.by_shape[(1, 4096, 4096, 512)] != TRAIN_STEPS:
        raise AssertionError("VAE encoder mid-block launches")
    inject_launches = si.launches.count
    moved = sum(not torch.equal(p, ups[n]) for n, p in
                pt.split_lora(tr.pipe.unet)[1].items() if n in ups)
    print(f"[8] LoRA up weights moved at {moved} of {len(ups)} sites",
          flush=True)
    if moved != len(ups):
        raise AssertionError("LoRA up weights did not all move")
    med = statistics.median(times)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"[8] PPFT step SD-1.5 512^2 B{TRAIN_BATCH} rank 320 bf16/f32: "
          f"{TRAIN_BATCH / med:.4f} samples/s (median of {len(times)}: "
          f"{', '.join(f'{x:.4f}' for x in times)} s), peak memory "
          f"{peak_gib:.2f} GiB | {smi}", flush=True)
    return per_shape, inject_launches, (tr, med)


def phase9(smi: str, bwd_rows: dict) -> None:
    """SDPA's backward and the pair at each training shape, device time."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(9)
    for name, h, tq, tk, d, _ in TRAIN_SHAPES:
        b, scale = TRAIN_BATCH, d ** -0.5
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        pair_dev = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, scale))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        library_ms = device_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do, retain_graph=True))
        host = (f" (phase 5's kernel_ms {bwd_rows[('pair', name)]:.4f})"
                if ("pair", name) in bwd_rows else "")
        print(f"[9] {name} B{b} bf16: library_ms(sdpa bwd, device time) "
              f"{library_ms:.4f}; the pair's device time {pair_dev:.4f} "
              f"= {pair_dev / library_ms:.2f}x{host} | {smi}", flush=True)
        del q, k, v, do, o, lse, out
        torch.cuda.empty_cache()


def phase10(smi: str, rows: dict) -> None:
    """The forward kernel and SDPA's forward at each serving shape and
    batch, at the protocol's batch and at SD-2.1's d = 64 shapes, device
    time (phase 2's kernel_ms is host-timed, which at the small shapes is
    the wrapper's launch cost)."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = ([(name, h, tq, tk, d, b) for name, h, tq, tk, d, b, _ in SHAPES]
             + [(key, h, tq, tk, d, b)
                for key, _, h, tq, tk, d, b in protocol_shapes()]
             + SD21_SHAPES)
    for name, h, tq, tk, d, b in cases:
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for t in (tq, tk, tk))
        kernel_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        library_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d)
        host = (f" (phase 2's kernel_ms {rows[name]['ms']:.4f})"
                if name in rows else "")
        print(f"[10] {name} B{b} bf16: forward device time {kernel_dev:.4f} "
              f"ms, sdpa forward {library_dev:.4f} = "
              f"{kernel_dev / library_dev:.2f}x, bound {bound_ms:.4f} "
              f"({bound_by}){host} | {smi}", flush=True)
        if name in rows:
            rows[name].update(device_ms=kernel_dev,
                              library_device_ms=library_dev)
        del q, k, v
        torch.cuda.empty_cache()


def phase11(smi: str, run, call_s: float) -> None:
    """One more generate call of phase 3 (its pipeline, already warm) under
    torch.profiler: device time by kernel, the forward kernel's share and
    the busy share of phase 3's median unprofiled call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(3)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        print("[11] device time by kernel: not measured (the profiler saw "
              "no CUDA kernel)", flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    fwd_ms = sum(e.self_device_time_total for e in events
                 if "flash_fwd" in e.key) / 1e3
    call_ms = call_s * 1e3
    print(f"[11] profiled generate call: device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / call_ms:.1f}% of the {call_ms:.1f} ms median "
          f"call; the forward kernel {fwd_ms:.1f} ms "
          f"({100 * fwd_ms / busy_ms:.1f}% of device time) | {smi}",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"[11]   {e.self_device_time_total / 1e3:9.2f} ms  "
              f"x{e.count:<5d} {e.key[:100]}", flush=True)


def phase12(smi: str) -> dict:
    """The d = 512 forward and backward against the plain versions at the
    stage-1 shapes; times at B5."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for name, b, h, tq, tk, d in S1_SHAPES:
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            tag = DTYPE_NAMES[dtype]
            # the kernels' peak: float32 runs 3xTF32 on the tensor cores
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else \
                PEAK_TF32_FLOPS / 3
            q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                    .to(dtype) for _ in range(2))
            o, lse = fa.flash_attention_plain(q, k, v, scale)
            delta = fa.attention_delta(o, do)
            args = (q, k, v, do, lse, delta, scale)
            got = (fa.flash_attention_bwd_dq(*args),
                   *fa.flash_attention_bwd_dkv(*args))
            want = (fa.flash_attention_dq_plain(*args),
                    *fa.flash_attention_dkv_plain(*args))
            torch.cuda.synchronize()
            errs, parts = {}, []
            for gname, g, r in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - r.float()).abs().max().item()
                tol = tolerance_grad(dtype, r)
                parts.append(f"{gname} {err:.3e} (tol {tol:.3e}, {err / tol:.2f}"
                             f" of it, max {r.float().abs().max().item():.3e})")
                if not err <= tol:
                    raise AssertionError(f"d = 512 backward disagrees with "
                                         f"plain: {name} {tag} {gname} "
                                         f"{err} > {tol}")
                errs[gname] = err
            again = (fa.flash_attention_bwd_dq(*args),
                     *fa.flash_attention_bwd_dkv(*args))
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two d = 512 backward "
                                     f"calls differ")
            del again
            print(f"[12] {name} B{b} H{h} Tq{tq} Tk{tk} d{d} {tag} (two calls "
                  f"bit-identical): "
                  + ", ".join(parts), flush=True)
            del got, want
            # the forward's instance of this type, two calls bit-identical
            fwd_out = fa.flash_attention_fwd(q, k, v, scale)
            fwd_again = fa.flash_attention_fwd(q, k, v, scale)
            if not all(torch.equal(x, y) for x, y in zip(fwd_out, fwd_again)):
                raise AssertionError(f"{name} {tag}: two d = 512 forward "
                                     f"calls differ")
            fwd_err = check_fwd(f"[12] {name} forward (two calls "
                                f"bit-identical)", q, k, v, scale,
                                out=fwd_out)
            del fwd_out, fwd_again
            if b != S1_BATCH:
                del q, k, v, do, o, lse, delta, args
                continue
            t = {"fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale),
                                iters=5, warmup=1),
                 "fwd_plain": time_ms(lambda: fa.flash_attention_plain(
                     q, k, v, scale), iters=3, warmup=1),
                 "fwd_library": time_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=scale), iters=5, warmup=1),
                 "dq": time_ms(lambda: fa.flash_attention_bwd_dq(*args),
                               iters=5, warmup=1),
                 "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(*args),
                                iters=5, warmup=1),
                 "dq_plain": time_ms(lambda: fa.flash_attention_dq_plain(
                     *args), iters=3, warmup=1),
                 "dkv_plain": time_ms(lambda: fa.flash_attention_dkv_plain(
                     *args), iters=3, warmup=1)}
            eb = 2 if dtype == torch.bfloat16 else 4
            bounds = bwd_bounds(b, h, tq, tk, d, eb, peak)
            fb, fby = attention_bound(b, h, tq, tk, d, eb, peak)
            cuda_core = ""
            if dtype == torch.float32:
                cc = bwd_bounds(b, h, tq, tk, d, eb, PEAK_F32_FLOPS)
                cf = attention_bound(b, h, tq, tk, d, eb, PEAK_F32_FLOPS)
                cuda_core = (f" (at the CUDA cores' float32 rate: forward "
                             f"{cf[0]:.4f}, dq {cc['dq'][0]:.4f}, dkv "
                             f"{cc['dkv'][0]:.4f}, pair {cc['pair'][0]:.4f})")
            print(f"[12] {name} B{b} {tag}: forward kernel_ms {t['fwd']:.4f} "
                  f"plain_ms {t['fwd_plain']:.4f} library_ms(sdpa) "
                  f"{t['fwd_library']:.4f} bound_ms {fb:.4f} ({fby}); dq "
                  f"kernel_ms {t['dq']:.4f} plain_ms {t['dq_plain']:.4f} "
                  f"bound_ms {bounds['dq'][0]:.4f} ({bounds['dq'][1]}); dkv "
                  f"kernel_ms {t['dkv']:.4f} plain_ms {t['dkv_plain']:.4f} "
                  f"bound_ms {bounds['dkv'][0]:.4f} ({bounds['dkv'][1]}); "
                  f"pair bound_ms {bounds['pair'][0]:.4f}{cuda_core} | {smi}",
                  flush=True)
            rows[("fwd", tag)] = {
                "max_abs_err": fwd_err, "ms": t["fwd"],
                "plain_ms": t["fwd_plain"], "bound_ms": fb, "bound_by": fby,
                "library_ms": t["fwd_library"]}
            for kern, err in (("dq", errs["dq"]),
                              ("dkv", max(errs["dk"], errs["dv"]))):
                rows[(kern, tag)] = {
                    "max_abs_err": err, "ms": t[kern],
                    "plain_ms": t[f"{kern}_plain"],
                    "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1],
                    "library_ms": None}
            del q, k, v, do, o, lse, delta, args
            torch.cuda.empty_cache()
    return rows


def phase12_profile(smi: str) -> None:
    """The d = 512 forward and SDPA's forward, the pair and SDPA's backward,
    at the stage-1 batch as device time, and the SDPA backend torch picked
    (its backward node)."""
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    name, b, h, tq, tk, d = S1_SHAPES[0]
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, h, tk, d, device="cuda", generator=gen)
                .to(dtype) for _ in range(2))
        fwd_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v, scale),
                            iters=3)
        sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), iters=3)
        bound_ms, bound_by = attention_bound(
            b, h, tq, tk, d, 2 if dtype == torch.bfloat16 else 4,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else
            PEAK_TF32_FLOPS / 3)
        print(f"[12] {name} B{b} {DTYPE_NAMES[dtype]}: the d = 512 forward's "
              f"device time {fwd_dev:.4f} ms; library_ms(sdpa forward, "
              f"device time) {sdpa_fwd:.4f} = {fwd_dev / sdpa_fwd:.2f}x; "
              f"bound {bound_ms:.4f} ({bound_by}) | {smi}", flush=True)
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        pair_dev = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, scale), iters=3)
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        backend = type(out.grad_fn).__name__
        library_ms = device_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do, retain_graph=True), iters=3)
        print(f"[12] {name} B{b} {DTYPE_NAMES[dtype]}: the d = 512 pair's "
              f"device time {pair_dev:.4f} ms; library_ms(sdpa bwd, device "
              f"time, {backend}) {library_ms:.4f} = "
              f"{pair_dev / library_ms:.2f}x | {smi}", flush=True)
        del q, k, v, do, o, lse, out
        torch.cuda.empty_cache()


def phase13():
    """The tiny stage-1 step: the card (kernels) against the CPU (plain),
    float32, the same weights and draws, for each stage-1 distortion."""
    from aqualora_torch.core.config import (EfficientNetConfig, VAEConfig,
                                            WatermarkConfig)
    from aqualora_torch.train import latent_wm_pretrain as s1

    pixels = torch.rand(2, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(13)) * 2 - 1
    models = {dev: s1.build_models(VAEConfig.tiny(), WatermarkConfig.tiny(),
                                   EfficientNetConfig.tiny(), dev)
              for dev in ("cpu", "cuda")}
    s1.init_models(models["cpu"], 13)
    with torch.no_grad():      # a non-zero encoder conv: every term lives
        w = models["cpu"].sec_encoder.conv_out.weight
        w.copy_(0.1 * torch.randn(w.shape, generator=torch.Generator()
                                  .manual_seed(14)))
    for part in ("vae", "lpips", "sec_encoder", "sec_decoder"):
        getattr(models["cuda"], part).load_state_dict(
            getattr(models["cpu"], part).state_dict())
    gen = torch.Generator().manual_seed(15)
    names = models["cpu"].noiser.names
    for index, layer in enumerate(names):
        probs = [float(i == index) for i in range(len(names))]
        draws = s1.draw(models["cpu"], gen, (2, 3, 64, 64), probs)
        out = {}
        for dev, m in models.items():
            for part in ("sec_encoder", "sec_decoder"):
                getattr(m, part).zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = s1.make_loss_fn(m)(pixels.to(dev).permute(0, 3, 1, 2),
                                         draws.to(dev), s1.Control())
            loss.backward()
            out[dev] = (loss.item(), counts(), {
                f"{part}.{n}": p.grad.cpu() for part in
                ("sec_encoder", "sec_decoder") for n, p in
                getattr(m, part).named_parameters()})
        (l_card, launched, g_card), (l_cpu, _, g_cpu) = out["cuda"], out["cpu"]
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        parts = {}
        for key, g in g_cpu.items():
            part = key.split(".")[0]
            parts[part] = max(parts.get(part, 0.0), g.abs().max().item())
        # 1e-3 of each leaf's largest gradient (phase 7's limit) plus 1e-5
        # of its module's: leaves with an exact gradient of 0 (the decoder's
        # project BatchNorm biases) read float32 noise on both sides
        worst = max((g_card[key] - g).abs().max().item()
                    / (TINY_GRAD_TOL * g.abs().max().item()
                       + 1e-5 * parts[key.split(".")[0]])
                    for key, g in g_cpu.items())
        print(f"[13] tiny stage-1 step, {layer}: loss {l_card:.6e} vs "
              f"{l_cpu:.6e} (rel {rel:.2e}, tol {TINY_LOSS_RTOL:g}); "
              f"{len(g_cpu)} gradients, worst {worst:.2f} of the limit; "
              f"kernel launches {launched}", flush=True)
        want = {"fwd": 3, "dq": 1, "dkv": 1, "inject": 0}
        if not (rel <= TINY_LOSS_RTOL and worst <= 1.0 and l_cpu > 0
                and launched == want):
            raise AssertionError(f"tiny stage-1 step ({layer}) on the card "
                                 f"disagrees with the CPU or skipped a kernel")


def phase14(smi: str) -> tuple:
    """The stage-1 path at full width through the trainer's entry points,
    float32 then bf16; returns the launches per type and the trainers with
    their median step, for the profiled step after phase 12's profile."""
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train import latent_wm_pretrain as s1

    launches, kept = {}, {}
    for mp, dtype in (("no", torch.float32), ("bf16", torch.bfloat16)):
        tag = DTYPE_NAMES[dtype]
        args = s1.build_argparser().parse_args([
            "--batch_size", str(S1_BATCH), "--mixed_precision", mp,
            "--seed", "0"])
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = s1.build_trainer(args)
        models = tr.models
        # a non-zero encoder conv (it starts at zero): every loss term and
        # every encoder gradient live from the first step
        with torch.no_grad():
            w = models.sec_encoder.conv_out.weight
            w.copy_(0.1 * torch.randn(w.shape, device="cuda", generator=torch
                                      .Generator(device="cuda").manual_seed(
                                          14)))
        trainable = {f"{part}.{n}": p.detach().clone() for part in
                     ("sec_encoder", "sec_decoder") for n, p in
                     getattr(models, part).named_parameters()}
        stats = {n: b.clone() for n, b in
                 models.sec_decoder.named_buffers() if "running" in n}
        ctl = s1.Control()
        batches = tr.dataset.batches(S1_BATCH, seed=0)
        torch.cuda.synchronize()
        print(f"[14] stage-1 trainer ({tag}) ready in "
              f"{time.perf_counter() - t0:.1f} s: {len(trainable)} trainable "
              f"tensors, {sum(p.numel() for p in trainable.values())} "
              f"parameters; frozen VAE and LPIPS in {tag}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                          # counts start here
        times = []
        for step in range(S1_STEPS):
            pixels, _ = next(batches)
            draws = s1.draw(models, tr.generator, (S1_BATCH, 3, S1_RES,
                                                   S1_RES), ctl.distort_probs)
            before = counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = tr.train_step(pixels, draws, ctl)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            got = {k: v - before[k] for k, v in counts().items()}
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[14] {tag} step {step}: {dt:.4f} s, "
                  + ", ".join(f"{k} {v:.6e}" for k, v in m.items())
                  + f", distortion {models.noiser.names[draws.noise.index]}, "
                  f"launches {got}", flush=True)
            if got != S1_PER_STEP:
                raise AssertionError(f"launches {got} in one step, want "
                                     f"{S1_PER_STEP}")
            if not (math.isfinite(m["loss"]) and m["loss"] > 0):
                raise AssertionError("stage-1 loss not finite positive")
            if step:
                times.append(dt)
        n_steps = S1_STEPS
        by_shape = (fa.launches.by_shape[S1_KEY], fa.dq_launches.by_shape[
            S1_KEY], fa.dkv_launches.by_shape[S1_KEY])
        if by_shape != (3 * n_steps, n_steps, n_steps):
            raise AssertionError(f"d = 512 launches {by_shape}")
        launches[tag] = {"fwd": by_shape[0], "dq": by_shape[1],
                         "dkv": by_shape[2]}
        moved = sum(not torch.equal(p.detach(), trainable[f"{part}.{n}"])
                    for part in ("sec_encoder", "sec_decoder") for n, p in
                    getattr(models, part).named_parameters())
        stats_moved = sum(not torch.equal(b, stats[n]) for n, b in
                          models.sec_decoder.named_buffers() if n in stats)
        print(f"[14] {tag}: {moved} of {len(trainable)} trainable tensors "
              f"moved, {stats_moved} of {len(stats)} BatchNorm statistics "
              f"moved", flush=True)
        if moved != len(trainable) or stats_moved != len(stats):
            raise AssertionError("a trainable or a BatchNorm statistic did "
                                 "not move")
        med = statistics.median(times)
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[14] stage-1 step SD-1.5 VAE, EfficientNet-B1, LPIPS-VGG16, "
              f"{S1_RES}^2 B{S1_BATCH} {tag}: {S1_BATCH / med:.4f} samples/s "
              f"(median of {len(times)}: {', '.join(f'{x:.4f}' for x in times)}"
              f" s), peak memory {peak_gib:.2f} GiB | {smi}", flush=True)
        kept[tag] = (tr, med)
    return launches, kept


def kernel_union_ms(prof) -> float:
    """Device time covered by at least one CUDA event of the profile: the
    union of their intervals (events on several streams can overlap, so
    their summed time can exceed the wall time)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def phase14_profile(smi: str, kept: dict) -> None:
    """One stage-1 step of each type under torch.profiler: the busy share
    (`kernel_union_ms`) of that step's own wall time, synchronised around
    it, and the d = 512 kernels' shares of the summed kernel time.  A
    step's work depends on its draws (the distortion), so the same pixels
    and draws are first timed without the profiler, beside phase 14's
    median step."""
    from torch.profiler import ProfilerActivity, profile

    from aqualora_torch.train import latent_wm_pretrain as s1
    for tag, (tr, med) in kept.items():
        ctl = s1.Control()
        pixels, _ = next(tr.dataset.batches(S1_BATCH, seed=1))
        draws = s1.draw(tr.models, tr.generator, (S1_BATCH, 3, S1_RES,
                                                  S1_RES), ctl.distort_probs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(pixels, draws, ctl)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_step(pixels, draws, ctl)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if not events:
            print(f"[14] {tag} device time by kernel: not measured (the "
                  f"profiler saw no CUDA kernel)", flush=True)
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        ours = {label: 0.0 for label in KERNEL_NAMES.values()}
        for e in events:
            for key, label in KERNEL_NAMES.items():
                if key in e.key:
                    ours[label] += e.self_device_time_total / 1e3
        pair = ours["dQ"] + ours["dK/dV"]
        name = tr.models.noiser.names[draws.noise.index]
        union_ms = kernel_union_ms(prof)
        print(f"[14] profiled {tag} stage-1 step ({name}): device busy "
              f"{union_ms:.1f} ms = {100 * union_ms / wall_ms:.1f}% of its "
              f"own {wall_ms:.1f} ms wall time (the same draws unprofiled "
              f"{plain_s * 1e3:.1f} ms, phase 14's median step "
              f"{med * 1e3:.1f} ms); kernel time summed {busy_ms:.1f} ms; "
              f"the d = 512 pair "
              f"{pair:.1f} ms ({100 * pair / busy_ms:.1f}% of device time: "
              f"dQ {ours['dQ']:.1f}, dK/dV {ours['dK/dV']:.1f}), the forward "
              f"{ours['flash fwd']:.1f} ms "
              f"({100 * ours['flash fwd'] / busy_ms:.1f}%) | {smi}",
              flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[14]   {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"x{e.count:<5d} {e.key[:100]}", flush=True)


# phase 15, the publisher's chain: steps of each stage, the LoRA file's
# tensors at SD-1.5 widths (192 sites, down and up), the sampler's steps,
# and the tiny dpms_m slice's steps (three or more, so that a second-order
# step runs: below 15 steps the first and the last are first order)
CHAIN_STEPS = 2
CHAIN_LORA_TENSORS = 384
CHAIN_TINY_STEPS = 4


def chain_stage1(tmp: str):
    """Chain step 1: stage 1 through its entry point at 512^2 B5 bf16."""
    from aqualora_torch.train import latent_wm_pretrain as s1
    out_dir = str(Path(tmp) / "stage1")
    args = s1.build_argparser().parse_args([
        "--batch_size", str(S1_BATCH), "--mixed_precision", "bf16",
        "--max_train_steps", str(CHAIN_STEPS), "--seed", "0",
        "--output_dir", out_dir])
    reset_counts()
    res = s1.run(args)
    torch.cuda.synchronize()
    got = counts()
    # each step 3 / 1 / 1, and the epoch's eval encodes and decodes once
    want = {"fwd": 3 * CHAIN_STEPS + 2, "dq": CHAIN_STEPS, "dkv": CHAIN_STEPS,
            "inject": 0}
    print(f"[15] stage 1 bf16 512^2 B{S1_BATCH}, {CHAIN_STEPS} steps through "
          f"latent_wm_pretrain.run: step wall times "
          f"{', '.join(f'{x:.4f}' for x in res['seconds'])} s, final loss "
          f"{res['history'][-1]['loss']:.6e}, launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"stage-1 launches {got}, want {want}")
    if not all(math.isfinite(h["loss"]) and h["loss"] > 0
               for h in res["history"]):
        raise AssertionError("stage-1 loss not finite positive")
    enc = {k: v.detach().clone() for k, v in
           res["trainer"].models.sec_encoder.state_dict().items()}
    return str(Path(out_dir) / "pretrained_latentwm.pt"), enc


def chain_ppft(tmp: str, s1_file: str, s1_encoder: dict):
    """Chain steps 2-3: PPFT from stage 1's file through its entry point
    at 512^2 B8 rank 320 bf16, with the artifacts and the final sanity
    inference; then the three files and the LoRA file's write and read
    times.  Returns the output directory and the trained tensors."""
    from aqualora_torch.core import io as aio
    from aqualora_torch.train import ppft_train as pt
    out_dir = str(Path(tmp) / "ppft")
    args = pt.build_argparser().parse_args([
        "--rank", "320", "--msg_bits", "48", "--resolution", "512",
        "--train_batch_size", str(TRAIN_BATCH), "--mixed_precision", "bf16",
        "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
        "--max_train_steps", str(CHAIN_STEPS), "--seed", "0",
        "--start_from_pretrain", s1_file, "--output_dir", out_dir,
        "--validation_prompt", PROMPTS[0],
        "--num_validation_images", "1"])
    reset_counts()
    res = pt.run(args)
    torch.cuda.synchronize()
    got = counts()
    # each step 65 / 32 / 32 / 1; the sanity inference is one generate call
    want = {"fwd": FWD_PER_STEP * CHAIN_STEPS + LAUNCHES_PER_GENERATE,
            "dq": BWD_PER_STEP * CHAIN_STEPS,
            "dkv": BWD_PER_STEP * CHAIN_STEPS, "inject": CHAIN_STEPS}
    hist = res["history"]
    print(f"[15] PPFT 512^2 B{TRAIN_BATCH} rank 320 bf16 from stage 1's file, "
          f"{CHAIN_STEPS} steps through ppft_train.run: step wall times "
          f"{', '.join(f'{x:.4f}' for x in res['seconds'])} s, ppft_loss "
          f"{', '.join(f'{h['ppft_loss']:.6e}' for h in hist)}, grad_norm "
          f"{', '.join(f'{h['grad_norm']:.6e}' for h in hist)}; sanity "
          f"inference (dpms_m 25, B1) bit accuracy "
          f"{res['sanity_bit_accuracy']:.4f}; launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"PPFT launches {got}, want {want}")
    if not all(math.isfinite(h[k]) and h[k] > 0 for h in hist
               for k in ("ppft_loss", "grad_norm")):
        raise AssertionError("PPFT loss or gradient norm not finite positive")
    tr = res["trainer"]
    enc = tr.sec_encoder.state_dict()
    same_enc = all(torch.equal(enc[k], s1_encoder[k]) for k in s1_encoder)
    f32_enc = all(v.dtype == torch.float32 for v in enc.values())
    print(f"[15] PPFT SecretEncoder equals stage 1's bit for bit: "
          f"{same_enc}; float32: {f32_enc}", flush=True)
    if not (same_enc and f32_enc and set(enc) == set(s1_encoder)):
        raise AssertionError("the PPFT encoder is not stage 1's, in float32")

    lora_path = Path(out_dir) / aio.LORA_FILE
    header, _, _, data_len = aio.read_safetensors_header(str(lora_path))
    n_params = sum(math.prod(h["shape"]) for h in header.values())
    mapper = aio.load_safetensors(str(Path(out_dir) / aio.MAPPER_FILE))
    dec_state = torch.load(Path(out_dir) / pt.MSGDECODER_FILE,
                           map_location="cpu", weights_only=True)
    # the LoRA file's write (the export save_artifacts makes) and read times
    again = Path(tmp) / "again.safetensors"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aio.export_lora_safetensors(tr.pipe.unet, tr.pipe.config.unet, str(again))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = aio.load_safetensors(str(lora_path), "cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same_bytes = again.read_bytes() == lora_path.read_bytes()
    size = lora_path.stat().st_size
    print(f"[15] {aio.LORA_FILE}: {len(header)} tensors, {n_params} "
          f"parameters, {size} bytes ({size / 2 ** 30:.4f} GiB); write "
          f"{write_s:.4f} s ({size / write_s / 2 ** 30:.3f} GiB/s), read to "
          f"the card {read_s:.4f} s ({size / read_s / 2 ** 30:.3f} GiB/s); a "
          f"second export gives the same bytes: {same_bytes}; "
          f"{aio.MAPPER_FILE}: "
          + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}" for k, v in
                      mapper.items())
          + f"; {pt.MSGDECODER_FILE}: {len(dec_state)} tensors", flush=True)
    emb = mapper.get("bit_embeddings.weight")
    if not (len(header) == CHAIN_LORA_TENSORS and same_bytes
            and data_len == 4 * n_params and emb is not None
            and emb.dtype == torch.float32
            and tuple(emb.shape) == (48, 320)
            and set(dec_state) == set(tr.msgdecoder.state_dict())):
        raise AssertionError("the saved artifacts are not as written")
    trained = {"lora": {k: p.detach().clone() for k, p in
                        pt.split_lora(tr.pipe.unet)[1].items()},
               "mapper": tr.pipe.mapper.bit_embeddings.weight.detach().clone(),
               "decoder": {k: v.detach().clone() for k, v in
                           tr.msgdecoder.state_dict().items()}}
    del res, tr, loaded
    torch.cuda.empty_cache()
    return out_dir, trained


def chain_generate(smi: str, out_dir: str, trained: dict,
                   ddim_s: float | None) -> float:
    """Chain steps 4-5: a fresh pipeline loads the saved LoRA, mapper and
    decoder, folds a message and generates B8 at 512^2 with DPM-Solver++(2M)
    25 steps at CFG 7.5 from per-image generators; decode the bits.
    Returns the median call in seconds."""
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion import pipeline as pl
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.train import ppft_train as pt

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = PipelineConfig.sd15(lora_rank=320)
    pipe = pl.StableDiffusionPipeline(cfg, dtype=torch.bfloat16,
                                      device="cuda")
    pipe.init_params(seed=0)                 # the trainer's base weights
    pipe.load_watermark_lora(out_dir)
    decoder = SecretDecoder(cfg.watermark.msg_bits, EfficientNetConfig.b1(),
                            device="cuda")
    decoder.load_state_dict(torch.load(Path(out_dir) / pt.MSGDECODER_FILE,
                                       map_location="cuda",
                                       weights_only=True))
    decoder.eval()
    lora = pt.split_lora(pipe.unet)[1]
    same = (set(lora) == set(trained["lora"])
            and all(torch.equal(lora[k], v) for k, v in
                    trained["lora"].items())
            and torch.equal(pipe.mapper.bit_embeddings.weight,
                            trained["mapper"])
            and all(torch.equal(decoder.state_dict()[k], v)
                    for k, v in trained["decoder"].items()))
    print(f"[15] fresh pipeline: {len(lora)} LoRA tensors, the mapper and "
          f"the decoder loaded from {Path(out_dir).name}/; equal to the "
          f"trained ones bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError("the loaded artifacts differ from the trained")
    msg = torch.bernoulli(torch.full((cfg.watermark.msg_bits,), 0.5),
                          generator=torch.Generator().manual_seed(15))
    pipe.fold_message(msg)
    tok = FallbackTokenizer(cfg.clip.vocab_size)
    ids, neg = tok(PROMPTS), tok([""] * N_IMG)
    generate = pipe.make_generate(num_steps=STEPS, sampler="dpms_m",
                                  height=RES, width=RES)

    def gens(seed):
        return [torch.Generator(device="cuda").manual_seed(seed + i)
                for i in range(N_IMG)]

    # the call's initial latent, recorded where generate draws it
    drawn = []
    draw = pl.batch_randn
    pl.batch_randn = lambda *a, **k: drawn.append(draw(*a, **k)) or drawn[-1]
    try:
        reset_counts()
        images = generate(ids, neg, guidance_scale=7.5, generator=gens(100))
        torch.cuda.synchronize()
        per_call = counts()
    finally:
        pl.batch_randn = draw
    rows_ok = all(torch.equal(drawn[0][i:i + 1], torch.randn(
        (1, *drawn[0].shape[1:]), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(100 + i)))
        for i in range(N_IMG))
    repeat = generate(ids, neg, guidance_scale=7.5, generator=gens(100))
    identical = torch.equal(images, repeat)
    times = []
    for i in range(3):
        before = fa.launches.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(ids, neg, guidance_scale=7.5, generator=gens(200 + 10 * i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if fa.launches.count - before != LAUNCHES_PER_GENERATE:
            raise AssertionError("launch count changed between calls")
    med = statistics.median(times)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bits, margins = decode_bits(decoder, images)
    acc = (bits.cpu() == msg.long()).float().mean().item()
    beside = (f"; phase 3's DDIM-25 {N_IMG / ddim_s:.4f} imgs/s, dpms_m / "
              f"DDIM time {med / ddim_s:.4f}" if ddim_s else "")
    print(f"[15] generate 8 x 512^2 dpms_m-25 CFG 7.5 bf16, message folded: "
          f"{N_IMG / med:.4f} imgs/s (median of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)} s){beside}; peak memory "
          f"{peak_gib:.2f} GiB above the {base / 2 ** 30:.2f} GiB resident; "
          f"launches a call {per_call}; images {tuple(images.shape)} finite "
          f"{bool(torch.isfinite(images).all())}; repeat call bit-identical "
          f"{identical}; row i of the B8 latent is generator i's B1 draw "
          f"{rows_ok}; decoded bit accuracy {acc:.4f} (random weights: "
          f"printed, not checked) | {smi}", flush=True)
    want = {"fwd": LAUNCHES_PER_GENERATE, "dq": 0, "dkv": 0, "inject": 0}
    if not (per_call == want and identical and rows_ok
            and tuple(images.shape) == (N_IMG, RES, RES, 3)
            and torch.isfinite(images).all()
            and torch.isfinite(margins).all()):
        raise AssertionError("the chain's generate failed a check")
    return med


def chain_tiny_card_vs_cpu() -> None:
    """Chain step 6: the tiny dpms_m slice on the card (kernels) against the
    CPU (plain versions), float32, the same weights and initial latents."""
    import numpy as np

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                          device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(seed=15)
    pipes["cuda"].load_state_from(pipes["cpu"])
    rng = np.random.default_rng(15)
    msg = torch.from_numpy(rng.integers(0, 2, cfg.watermark.msg_bits)
                           .astype(np.float32))
    z = rng.standard_normal((2, 16, 16, cfg.unet.in_channels),
                            dtype=np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    out = {}
    fa.launches.reset()
    for dev, pipe in pipes.items():
        pipe.fold_message(msg)
        gen = pipe.make_generate(num_steps=CHAIN_TINY_STEPS, sampler="dpms_m",
                                 height=32, width=32)
        out[dev] = gen(ids, neg, guidance_scale=7.5,
                       z=torch.from_numpy(z).to(dev)).cpu()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    print(f"[15] tiny dpms_m-{CHAIN_TINY_STEPS} slice card vs CPU: max|d "
          f"image| {err:.3e} (tol {TINY_IMAGE_TOL:g}), kernel launches "
          f"{fa.launches.count}", flush=True)
    if not (err <= TINY_IMAGE_TOL and fa.launches.count > 0):
        raise AssertionError("tiny dpms_m slice on the card disagrees with "
                             "the CPU")


def phase15(smi: str, ddim_s: float | None, tmp: str) -> tuple:
    """The publisher's chain at full width: stage 1 -> PPFT from its file ->
    the artifacts saved (under `tmp`, which phase 16 reads) -> a fresh
    pipeline loads them -> dpms_m generate -> decode; then the tiny dpms_m
    slice card vs CPU.  The counts are set to 0 before each stage and read
    after it.  Returns the PPFT output directory and the median dpms_m B8
    call in seconds."""
    s1_file, s1_encoder = chain_stage1(tmp)
    torch.cuda.empty_cache()
    out_dir, trained = chain_ppft(tmp, s1_file, s1_encoder)
    dpms_s = chain_generate(smi, out_dir, trained, ddim_s)
    del trained
    torch.cuda.empty_cache()
    chain_tiny_card_vs_cpu()
    return out_dir, dpms_s


# phase 16, the auditor's path: run_eval_base at the protocol's settings
# (dpms_m 25, CFG 7.5, 512^2, bf16, batch 4) on phase 15's artifacts, 8
# prompts x 2 seeds; the per-image path at one B4 batch of 4 messages
EVAL_PROMPTS, EVAL_SEEDS = 8, 2
EVAL_MSG_BITS = 48
NO_TRAINING = {"dq": 0, "dkv": 0, "inject": 0}


class RunnerParts:
    """Times the runner's parts by wrapping what `utils_eval` calls (each
    wrapper synchronizes the card before it stops its clock), counts the
    forward launches of each generate call, and keeps the device-quantized
    images.  `install()` / `remove()` put the wrappers in and take them
    out."""

    def __init__(self):
        from aqualora_torch.diffusion import pipeline as pl
        from aqualora_torch.eval import utils_eval as ue
        self.targets = [(ue, "images_to_uint8"), (ue, "save_png"),
                        (ue, "preprocess"), (ue, "decode_bits"),
                        (pl.StableDiffusionPipeline, "make_generate")]
        self.saved = {}
        self.reset()

    def reset(self):
        self.seconds = {"generate": 0.0, "quantize_fetch": 0.0,
                        "png_write": 0.0, "png_read_preprocess": 0.0,
                        "decode": 0.0}
        self.per_call, self.images = [], []

    def _timed(self, part, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds[part] += time.perf_counter() - t0
            return out
        return wrapper

    def install(self):
        self.saved = {(obj, name): getattr(obj, name)
                      for obj, name in self.targets}
        ue, pl_cls = self.targets[0][0], self.targets[-1][0]
        quantize = self._timed("quantize_fetch", self.saved[
            (ue, "images_to_uint8")])

        def keep(images):
            out = quantize(images)
            self.images.extend(out)
            return out

        make_generate = self.saved[(pl_cls, "make_generate")]

        def counted_make_generate(pipe, *a, **k):
            generate = self._timed("generate", make_generate(pipe, *a, **k))

            def counted(*ga, **gk):
                torch.cuda.synchronize()
                before = counts()
                out = generate(*ga, **gk)
                after = counts()
                self.per_call.append({c: after[c] - before[c] for c in after})
                return out
            return counted

        ue.images_to_uint8 = keep
        ue.save_png = self._timed("png_write", self.saved[(ue, "save_png")])
        ue.preprocess = self._timed("png_read_preprocess",
                                    self.saved[(ue, "preprocess")])
        ue.decode_bits = self._timed("decode",
                                     self.saved[(ue, "decode_bits")])
        pl_cls.make_generate = counted_make_generate

    def remove(self):
        for (obj, name), fn in self.saved.items():
            setattr(obj, name, fn)


def run_runner(argv, parts: RunnerParts, n_images: int) -> tuple:
    """One `run_eval_base.main(argv)` with the counts set to 0 before it
    and read after it, and the parts timed; -> (result, wall seconds,
    launches by shape, counts)."""
    from aqualora_torch.eval import run_eval_base
    from aqualora_torch.ops import flash_attention as fa
    parts.reset()
    parts.install()
    try:
        torch.cuda.synchronize()
        reset_counts()                          # counts start here
        t0 = time.perf_counter()
        result = run_eval_base.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, by_shape = counts(), dict(fa.launches.by_shape)
    finally:
        parts.remove()
    calls = n_images // PROTOCOL_IMAGES
    want_call = {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}
    if (len(parts.per_call) != calls
            or any(c != want_call for c in parts.per_call)
            or got != {"fwd": calls * LAUNCHES_PER_GENERATE, **NO_TRAINING}):
        raise AssertionError(f"runner launches {got}, per call "
                             f"{parts.per_call}; want {calls} calls of "
                             f"{want_call}")
    return result, wall, by_shape, got


def phase16(smi: str, out_dir: str, tmp: str,
            dpms_s: float | None) -> dict:
    """The auditor's path at full width on phase 15's artifacts, through
    the entry points a user calls: run_eval_base with --train_folder
    --hidinfo (the message folded in memory), then create_wm_lora's CLI
    and run_eval_base with --lora --msg_gt (the folded file); then
    simple_sample with one message per image in one B4 batch.  Returns the
    forward launches by serving shape of the first run."""
    import numpy as np

    from aqualora_torch.eval import image_io
    from aqualora_torch.eval import utils_eval as ue
    from aqualora_torch.eval.prompts import load_prompts
    from aqualora_torch.ops import flash_attention as fa
    from aqualora_torch.tools import create_wm_lora as cwl
    from aqualora_torch.train.ppft_train import MSGDECODER_FILE

    dec_path = str(Path(out_dir) / MSGDECODER_FILE)
    rng = np.random.default_rng(16)
    hidinfo = "".join(map(str, rng.integers(0, 2, EVAL_MSG_BITS)))
    n_images = EVAL_PROMPTS * EVAL_SEEDS
    common = ["--msgdecoder_path", dec_path, "--num_prompts",
              str(EVAL_PROMPTS), "--num_seeds", str(EVAL_SEEDS),
              "--batch_size", str(PROTOCOL_IMAGES), "--sampler", "dpms_m",
              "--steps", str(STEPS), "--cfg", "7.5", "--resolution",
              str(RES), "--msg_bits", str(EVAL_MSG_BITS), "--device", "cuda"]
    names = [f"{s}_{i}.png" for s in range(EVAL_SEEDS)
             for i in range(EVAL_PROMPTS)]
    parts = RunnerParts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # flow 1: the message folded in memory
    eval1 = Path(tmp) / "eval_one_step"
    res1, wall, by_shape, got = run_runner(
        ["--train_folder", out_dir, "--hidinfo", hidinfo,
         "--output_dir", str(eval1)] + common, parts, n_images)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    seconds, in_memory = dict(parts.seconds), list(parts.images)
    pngs = sorted(p.name for p in (eval1 / "images").glob("*.png"))
    on_disk = json.loads((eval1 / "eval_base.json").read_text())
    rest = wall - sum(seconds.values())
    print(f"[16] run_eval_base --train_folder --hidinfo: {n_images} images "
          f"({EVAL_PROMPTS} prompts x {EVAL_SEEDS} seeds) at 512^2 dpms_m-"
          f"{STEPS} CFG 7.5 bf16 B{PROTOCOL_IMAGES} in {wall:.4f} s = "
          f"{n_images / wall:.4f} images/s end to end"
          + (f" (phase 15's dpms_m B8 generate {N_IMG / dpms_s:.4f} imgs/s)"
             if dpms_s else "")
          + "; seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       seconds.items())
          + f", the rest (pipeline build, fold, prompts) {rest:.4f}; peak "
          f"memory {peak_gib:.2f} GiB above the {base / 2 ** 30:.2f} GiB "
          f"resident; launches {got}, each generate call "
          f"{parts.per_call[0]}; bit_accuracy {res1['bit_acc']:.4f} TPR "
          f"{res1['tpr']:.4f} at FPR {res1['fpr']:g} (random weights: "
          f"printed, not checked) | {smi}", flush=True)
    if not (pngs == sorted(names) and len(in_memory) == n_images
            and on_disk == res1 and res1["n_images"] == n_images
            and res1["message"] == hidinfo and res1["sampler"] == "dpms_m"
            and 0.0 <= res1["bit_acc"] <= 1.0 and 0.0 <= res1["tpr"] <= 1.0):
        raise AssertionError(f"the runner's outputs are not as written: "
                             f"{pngs}, {res1}, {on_disk}")
    # the PNG round trip is lossless: the files decode to the bits of the
    # same calls' device-quantized images
    png_arrays = [image_io.load_png(str(eval1 / "images" / n)) for n in names]
    same_pixels = all(np.array_equal(a, b)
                      for a, b in zip(png_arrays, in_memory))
    _, _, from_png = ue.simple_decode(EVAL_MSG_BITS, dec_path,
                                      [str(eval1 / "images" / n)
                                       for n in names], resolution=RES, device="cuda")
    _, _, from_memory = ue.simple_decode(EVAL_MSG_BITS, dec_path, in_memory,
                                         resolution=RES, device="cuda")
    print(f"[16] PNGs read back equal the device-quantized images: "
          f"{same_pixels}; bits from the PNGs equal the bits from memory: "
          f"{from_png == from_memory} ({len(set(from_png))} distinct "
          f"bitstrings)", flush=True)
    if not (same_pixels and from_png == from_memory):
        raise AssertionError("the PNG round trip lost information")

    # flow 2: create_wm_lora's CLI, then the folded file with --msg_gt
    t0 = time.perf_counter()
    written = cwl.main(["--train_folder", out_dir, "--msg_bits",
                        str(EVAL_MSG_BITS), "--hidinfo", hidinfo])
    fold_s = time.perf_counter() - t0
    eval2 = Path(tmp) / "eval_two_step"
    res2, wall2, _, _ = run_runner(
        ["--lora", str(Path(out_dir) / hidinfo /
                       "pytorch_lora_weights.safetensors"),
         "--msg_gt", hidinfo, "--output_dir", str(eval2)] + common,
        parts, n_images)
    same_images = all(np.array_equal(
        image_io.load_png(str(eval1 / "images" / n)),
        image_io.load_png(str(eval2 / "images" / n))) for n in names)
    same_result = all(res2[k] == res1[k] for k in
                      ("bit_acc", "tpr", "n_images", "message"))
    rest2 = wall2 - sum(parts.seconds.values())
    print(f"[16] create_wm_lora CLI {fold_s:.4f} s, then run_eval_base "
          f"--lora --msg_gt: {n_images / wall2:.4f} images/s ({wall2:.4f} "
          f"s; seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      parts.seconds.items())
          + f", the rest {rest2:.4f}); the same images as the one-step "
          f"flow: {same_images}; the same eval_base.json fields: "
          f"{same_result} | {smi}", flush=True)
    if not (written == hidinfo and same_images and same_result):
        raise AssertionError("the two flows disagree")

    # one message per image in one B4 batch, against each message folded
    msgs = ["".join(map(str, r)) for r in
            rng.integers(0, 2, (PROTOCOL_IMAGES, EVAL_MSG_BITS))]
    prompts = load_prompts(None, PROTOCOL_IMAGES)
    kw = dict(seeds=[0], batch_size=PROTOCOL_IMAGES, resolution=RES,
              num_inference_steps=STEPS, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    per_image = ue.simple_sample(None, "dpms_m", prompts, messages=msgs,
                                 train_folder=out_dir, **kw)
    torch.cuda.synchronize()
    got = counts()
    if got != {"fwd": LAUNCHES_PER_GENERATE, **NO_TRAINING}:
        raise AssertionError(f"per-image call launches {got}")
    pi_bits = ue.simple_decode(EVAL_MSG_BITS, dec_path, per_image,
                               resolution=RES, device="cuda")[2]
    for i, m in enumerate(msgs):
        _, folded = cwl.create_watermark_lora(out_dir, msg_bits=EVAL_MSG_BITS,
                                              hidinfo=m, save=False)
        f_img = ue.simple_sample(None, "dpms_m", prompts, lora=folded,
                                 **kw)[i]
        f_bits = ue.simple_decode(EVAL_MSG_BITS, dec_path, [f_img],
                                  resolution=RES, device="cuda")[2][0]
        d = np.abs(f_img.astype(np.int16) - per_image[i].astype(np.int16))
        agree = sum(a == b for a, b in zip(f_bits, pi_bits[i]))
        print(f"[16] per-image message {i} (one B4 call, {got['fwd']} "
              f"forward launches) against the same message folded: max|d "
              f"pixel| {int(d.max())}, mean {d.mean():.4f} levels; decoded "
              f"bits agree {agree}/{EVAL_MSG_BITS}; bits match the message "
              f"{sum(a == b for a, b in zip(pi_bits[i], m))}/"
              f"{EVAL_MSG_BITS} (random weights: printed)", flush=True)
        del folded
        torch.cuda.empty_cache()
    return {name: by_shape.get((h, tq, tk, d), 0)
            for name, h, tq, tk, d, _, _ in SHAPES}


# phase 17, the samplers: the tiny slice's steps (enough for each sampler's
# higher-order steps) and the full-width call's
TINY_SAMPLER_STEPS = 5


def phase17(smi: str) -> None:
    """Each of the twelve samplers: the tiny slice on the card (kernels)
    against the CPU (plain versions), float32, the same weights, initial
    latents and draws; then at full width (SD-1.5 512^2, B8, CFG 7.5, 25
    steps, bf16, a folded message), one timed call after a shared warm-up,
    beside DDIM-25's: forward launches = 32 per U-Net evaluation + 1."""
    import numpy as np

    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion import samplers as smp
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.tiny()
    pipes = {dev: StableDiffusionPipeline(cfg, dtype=torch.float32,
                                          device=dev)
             for dev in ("cpu", "cuda")}
    pipes["cpu"].init_params(seed=17)
    pipes["cuda"].load_state_from(pipes["cpu"])
    rng = np.random.default_rng(17)
    msg = torch.from_numpy(rng.integers(0, 2, cfg.watermark.msg_bits)
                           .astype(np.float32))
    z = rng.standard_normal((2, 16, 16, cfg.unet.in_channels),
                            dtype=np.float32)
    ids = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    neg = rng.integers(0, cfg.clip.vocab_size, (2, 77), dtype=np.int32)
    for pipe in pipes.values():
        pipe.fold_message(msg)
    draw = smp.batch_randn
    for name in sorted(smp.SAMPLERS):
        out = {}
        fa.launches.reset()
        for dev, pipe in pipes.items():
            # the stochastic samplers' draws: the same numbers on both sides
            cpu_gen = torch.Generator().manual_seed(170)
            smp.batch_randn = (lambda shape, generator, device,
                               dtype=torch.float32, g=cpu_gen:
                               torch.randn(shape, generator=g, dtype=dtype)
                               .to(device))
            try:
                gen = pipe.make_generate(num_steps=TINY_SAMPLER_STEPS,
                                         sampler=name, height=32, width=32)
                out[dev] = gen(ids, neg, guidance_scale=7.5,
                               z=torch.from_numpy(z).to(dev)).cpu()
            finally:
                smp.batch_randn = draw
        err = (out["cuda"] - out["cpu"]).abs().max().item()
        print(f"[17] tiny {name}-{TINY_SAMPLER_STEPS} slice card vs CPU: "
              f"max|d image| {err:.3e} (tol {TINY_IMAGE_TOL:g}), kernel "
              f"launches {fa.launches.count}", flush=True)
        if not (err <= TINY_IMAGE_TOL and fa.launches.count > 0):
            raise AssertionError(f"tiny {name} slice on the card disagrees "
                                 "with the CPU")
    del pipes

    cfg = PipelineConfig.sd15(lora_rank=320)
    pipe = StableDiffusionPipeline(cfg, dtype=torch.bfloat16, device="cuda")
    pipe.init_params(seed=0)
    pipe.fold_message(torch.bernoulli(
        torch.full((cfg.watermark.msg_bits,), 0.5),
        generator=torch.Generator().manual_seed(17)))
    tok = FallbackTokenizer(cfg.clip.vocab_size)
    ids, neg = tok(PROMPTS), tok([""] * N_IMG)

    def gens(seed):
        return [torch.Generator(device="cuda").manual_seed(seed + i)
                for i in range(N_IMG)]

    pipe.make_generate(STEPS, "ddim", RES, RES)(ids, neg, 7.5,
                                                generator=gens(0))
    per_unet = LAUNCHES_PER_GENERATE // STEPS            # 32
    ddim_s = None
    for name in ["ddim"] + sorted(set(smp.SAMPLERS) - {"ddim"}):
        generate = pipe.make_generate(STEPS, name, RES, RES)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        images = generate(ids, neg, 7.5, generator=gens(300))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        got = counts()
        evals = smp.unet_evaluations(name, STEPS)
        ddim_s = ddim_s or call_s
        print(f"[17] {name}-{STEPS} 8 x 512^2 CFG 7.5 bf16, message folded: "
              f"{evals} U-Net evaluations, {got['fwd']} forward launches, "
              f"{N_IMG / call_s:.4f} imgs/s (one call, {call_s:.4f} s; "
              f"DDIM-{STEPS} {N_IMG / ddim_s:.4f}); images finite "
              f"{bool(torch.isfinite(images).all())} | {smi}", flush=True)
        if not (got == {"fwd": per_unet * evals + 1, **NO_TRAINING}
                and tuple(images.shape) == (N_IMG, RES, RES, 3)
                and torch.isfinite(images).all()):
            raise AssertionError(f"{name} at full width: launches {got}, "
                                 f"images {tuple(images.shape)}")
    del pipe, images
    torch.cuda.empty_cache()


def kernels_line(rows, launches, bwd_rows, train_launches, inject_row,
                 inject_launches, s1_rows, s1_launches,
                 proto_launches) -> dict:
    kernels = []
    for name, *_ in SHAPES:
        kernels.append({
            "name": f"flash_attention_fwd/{name}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": launches[name], **rows[name]})
    # the auditor's path (phase 16's first run_eval_base) at the protocol's
    # batch
    for key, name, *_ in protocol_shapes():
        kernels.append({
            "name": f"flash_attention_fwd/{key}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": proto_launches[name], **rows[key]})
    for kern, line in (("dq", 239), ("dkv", 269)):
        for name, *_ in TRAIN_SHAPES:
            kernels.append({
                "name": f"flash_attention_bwd_{kern}/{name}", "route": "cuda",
                "source": "aqualora_torch/csrc/flash_bwd.cu",
                "replaces": f"aqualora_tpu/ops/flash_attention.py:{line}",
                "launches": train_launches[name], **bwd_rows[(kern, name)]})
    kernels.append({
        "name": "secret_inject/train_latent", "route": "cuda",
        "source": "aqualora_torch/csrc/secret_inject.cu",
        "replaces": "aqualora_tpu/ops/secret_inject.py:47",
        "launches": inject_launches, **inject_row})
    # stage 1: the d = 512 instances of each type at the stage-1 batch
    for kern, src, line in (("fwd", "flash_fwd", 147), ("dq", "flash_bwd", 239),
                            ("dkv", "flash_bwd", 269)):
        for tag in ("f32", "bf16"):
            name = ("flash_attention_fwd" if kern == "fwd"
                    else f"flash_attention_bwd_{kern}")
            kernels.append({
                "name": f"{name}/stage1_vae_mid_d512_{tag}", "route": "cuda",
                "source": f"aqualora_torch/csrc/{src}.cu",
                "replaces": f"aqualora_tpu/ops/flash_attention.py:{line}",
                "launches": s1_launches[tag][kern], **s1_rows[(kern, tag)]})
    # a device time the profiler did not measure is null, not NaN
    return {"kernels": [{k: None if isinstance(x, float) and math.isnan(x)
                         else x for k, x in kern.items()}
                        for kern in kernels]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers (default: all; "
                         "phase 0 always runs, and the kernels line needs "
                         "all of them)")
    args = ap.parse_args(argv)
    every = set(range(18))
    run_ = every if args.phases is None else \
        {0} | {int(x) for x in args.phases.split(",")}
    if 11 in run_:
        run_.add(3)          # phase 11 profiles phase 3's generate call
    if 16 in run_:
        run_.add(15)         # phase 16 reads phase 15's artifacts
    smi = phase0()
    rows, launches, med_s, serve = {}, {}, 0.0, None
    bwd_rows, inject_row, train_launches, inject_launches = {}, {}, {}, 0
    if 1 in run_:
        phase1()
    if 2 in run_:
        rows = phase2(smi)
    if 3 in run_:
        launches, med_s, serve = phase3(smi)
    if rows and launches:
        per_call = {key: sum(rows[n][key] * launches[n] for n in launches)
                    for key in ("ms", "library_ms", "bound_ms")}
        print(f"[3] flash kernel time per generate call (phase-2 kernel_ms x "
              f"launches): {per_call['ms']:.1f} ms = "
              f"{100 * per_call['ms'] / (med_s * 1e3):.1f}% of the "
              f"{med_s * 1e3:.1f} ms call; sdpa at the same launches "
              f"{per_call['library_ms']:.1f} ms; bound "
              f"{per_call['bound_ms']:.1f} ms | {smi}", flush=True)
    if 4 in run_:
        phase4()
    if 5 in run_:
        bwd_rows = phase5(smi)
    if 6 in run_:
        inject_row = phase6(smi)
    if 7 in run_:
        phase7()
    s1_rows, s1_launches, s1_kept = {}, {}, {}
    if 12 in run_:
        s1_rows = phase12(smi)
    if 13 in run_:
        phase13()
    if 14 in run_:
        s1_launches, s1_kept = phase14(smi)
    if 8 in run_:
        train_launches, inject_launches, ppft_kept = phase8(smi)
    proto_launches = {}
    if 15 in run_:
        with tempfile.TemporaryDirectory(prefix="aqualora_chain_") as tmp:
            out_dir, dpms_s = phase15(smi, med_s if 3 in run_ else None, tmp)
            if 16 in run_:
                proto_launches = phase16(smi, out_dir, tmp, dpms_s)
    if 17 in run_:
        phase17(smi)
    # the profiled phases: the short sessions first, then the profiles of
    # whole steps and of the generate call (see the docstring)
    if 6 in run_:
        phase6_profile(smi)
    if 9 in run_:
        phase9(smi, bwd_rows)
    if 10 in run_:
        phase10(smi, rows)
    if 12 in run_:
        phase12_profile(smi)
    if 8 in run_:
        profile_step(*ppft_kept, smi)
        del ppft_kept
        torch.cuda.empty_cache()
    if 14 in run_:
        phase14_profile(smi, s1_kept)
    if 11 in run_:
        phase11(smi, serve, med_s)
    if run_ == every:
        print(json.dumps(kernels_line(rows, launches, bwd_rows,
                                      train_launches, inject_row,
                                      inject_launches, s1_rows, s1_launches,
                                      proto_launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
