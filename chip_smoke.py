#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and hold its kernel against
its plain version.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  0. torch and CUDA versions, the card's name and power limit (nvidia-smi).
     Without a CUDA card the script stops here with an error.
  1. Build the flash-attention kernel from aqualora_torch/csrc.
  2. The kernel against `flash_attention_plain` on the card at every
     attention shape of the main path, float32 and bfloat16, O and lse
     (batch cut to 2).  Then, at the serving batch in bfloat16, the kernel's
     time, the plain version's, PyTorch's scaled_dot_product_attention's
     (a yardstick only: the port never calls it) and the H100 bound.
  3. The main path: SD-1.5 at full width with seeded random bfloat16
     weights and the rank-320 message LoRA, one random 48-bit message folded
     into the U-Net, 8 prompts at 512x512, DDIM-25, CFG 7.5, VAE decode and
     SecretDecoder (EfficientNet-B1) bits.  Every generate call must launch
     the kernel exactly 801 times.
  4. The tiny slice on the card (kernel path) against the same slice on the
     CPU (plain path), same weights and initial latents.
The line before the last names the card and its power limit; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
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
CHECK_BATCH = 2
# max abs error allowed against the plain version.  float32 O: both sides
# accumulate in float32 in different orders (~1e-6).  lse is float32 on both
# sides for either input type.
TOL_F32 = 1e-4
TOL_LSE = 1e-4
TINY_IMAGE_TOL = 2e-3


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


def tolerance_o(dtype: torch.dtype, o_ref: torch.Tensor) -> float:
    """bfloat16 O is rounded on both sides from float32 values that differ
    by the float32 limit, so an element may differ by one bf16 ulp at its own
    magnitude: at most 2^-7 * max|O_ref|, which scales with O (about
    Tk^-1/2 at randn inputs)."""
    if dtype == torch.float32:
        return TOL_F32
    return 2.0 ** -7 * o_ref.float().abs().max().item() + TOL_F32


def attention_bound(b, h, tq, tk, d, elem_bytes=2):
    """Least time on the card: operations over the bf16 peak, or the bytes of
    q, k, v read once and o (+ float32 lse) written once over HBM."""
    flops = 4.0 * b * h * tq * tk * d
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * elem_bytes \
        + 4 * b * h * tq
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def phase1():
    from aqualora_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.build(verbose=True)
    print(f"[1] built {fa.SOURCE.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase2(smi: str) -> dict:
    from aqualora_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, h, tq, tk, d, serve_b, _ in SHAPES:
        scale = d ** -0.5
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(CHECK_BATCH, h, t, d, device="cuda",
                                   generator=gen).to(dtype)
                       for t in (tq, tk, tk))
            o, lse = fa.flash_attention_fwd(q, k, v, scale)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_l = (lse - lse_ref).abs().max().item()
            tol_o = tolerance_o(dtype, o_ref)
            line = (f"[2] {name} B{CHECK_BATCH} H{h} Tq{tq} Tk{tk} d{d} "
                    f"{str(dtype)[6:]}: max|dO| {err_o:.3e} (tol {tol_o:.3e}, "
                    f"max|O| {o_ref.float().abs().max().item():.3e}) "
                    f"max|dlse| {err_l:.3e} (tol {TOL_LSE:g})")
            print(line, flush=True)
            if not (err_o <= tol_o and err_l <= TOL_LSE):
                raise AssertionError(f"kernel disagrees with plain: {line}")
            errs[dtype] = err_o
            del q, k, v, o, lse, o_ref, lse_ref
        q, k, v = (torch.randn(serve_b, h, t, d, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for t in (tq, tk, tk))
        kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale),
                           iters=3, warmup=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        bound_ms, bound_by = attention_bound(serve_b, h, tq, tk, d)
        print(f"[2] {name} B{serve_b} bf16: kernel_ms {kernel_ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms(sdpa) {library_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}) | {smi}", flush=True)
        rows[name] = {"max_abs_err": errs[torch.bfloat16], "ms": kernel_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase3(smi: str) -> tuple:
    from aqualora_torch.core.config import EfficientNetConfig, PipelineConfig
    from aqualora_torch.core.tokenizer import FallbackTokenizer
    from aqualora_torch.diffusion.pipeline import (StableDiffusionPipeline,
                                                   init_module_weights)
    from aqualora_torch.eval.utils_eval import decode_bits
    from aqualora_torch.models.watermark import SecretDecoder
    from aqualora_torch.ops import flash_attention as fa

    cfg = PipelineConfig.sd15(lora_rank=320)
    n_img, steps, res = 8, 25, 512
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
    prompts = ["a photograph of an astronaut riding a horse",
               "a watercolor of a lighthouse at dusk",
               "a bowl of ramen, studio lighting",
               "a red fox in fresh snow",
               "an isometric city block at night",
               "a portrait of an old fisherman",
               "a field of sunflowers under storm clouds",
               "a cat reading a newspaper"]
    ids, neg = tok(prompts), tok([""] * n_img)
    generate = pipe.make_generate(num_steps=steps, sampler="ddim",
                                  height=res, width=res)
    torch.cuda.synchronize()
    print(f"[3] SD-1.5 bf16 weights ready in {time.perf_counter() - t0:.1f} s "
          f"(rank-320 LoRA folded)", flush=True)

    def run(seed):
        return generate(ids, neg, guidance_scale=7.5,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(seed))

    torch.cuda.reset_peak_memory_stats()
    fa.launches.reset()                         # counts start here
    images = run(3)
    torch.cuda.synchronize()
    by_shape = dict(fa.launches.by_shape)
    total = fa.launches.count
    print(f"[3] kernel launches in one generate call: {total}", flush=True)
    if total != LAUNCHES_PER_GENERATE:
        raise AssertionError(f"{total} launches, want {LAUNCHES_PER_GENERATE}")
    launches = {}
    for name, h, tq, tk, d, _, want in SHAPES:
        got = by_shape.get((h, tq, tk, d), 0)
        if got != want:
            raise AssertionError(f"{name}: {got} launches, want {want}")
        launches[name] = got
    if tuple(images.shape) != (n_img, res, res, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise AssertionError("non-finite image values")
    if images.min() < -1 or images.max() > 1:
        raise AssertionError("images outside [-1, 1]")
    bits, margins = decode_bits(decoder, images)
    if tuple(bits.shape) != (n_img, cfg.watermark.msg_bits):
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
          f"{n_img / med:.4f} imgs/s (median of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)} s), peak memory "
          f"{peak_gib:.2f} GiB | {smi}", flush=True)
    del pipe, decoder, images
    torch.cuda.empty_cache()
    return launches, med


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


def main():
    smi = phase0()
    phase1()
    rows = phase2(smi)
    launches, med_s = phase3(smi)
    per_call = {key: sum(rows[n][key] * launches[n] for n in launches)
                for key in ("ms", "library_ms", "bound_ms")}
    print(f"[3] flash kernel time per generate call (phase-2 kernel_ms x "
          f"launches): {per_call['ms']:.1f} ms = "
          f"{100 * per_call['ms'] / (med_s * 1e3):.1f}% of the "
          f"{med_s * 1e3:.1f} ms call; sdpa at the same launches "
          f"{per_call['library_ms']:.1f} ms; bound "
          f"{per_call['bound_ms']:.1f} ms | {smi}", flush=True)
    phase4()
    kernels = []
    for name, *_ in SHAPES:
        kernels.append({
            "name": f"flash_attention_fwd/{name}", "route": "cuda",
            "source": "aqualora_torch/csrc/flash_fwd.cu",
            "replaces": "aqualora_tpu/ops/flash_attention.py:147",
            "launches": launches[name], **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
