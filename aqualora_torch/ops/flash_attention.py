"""Flash-attention forward: the Hopper CUDA kernel, its wrapper and its plain version.

`flash_attention_fwd(q, k, v, scale) -> (o, lse)` computes unmasked
softmax(q k^T * scale) v over [B, H, T, D] tensors, plus the float32 row
logsumexp `lse [B, H, Tq]` that a backward pass reads.  It replaces the TPU
kernel `_fwd_kernel` (`aqualora_tpu/ops/flash_attention.py:147`, launched by
`_flash_forward`).  The kernel itself is `aqualora_torch/csrc/flash_fwd.cu`.
On the H100 the self-attention shapes are bound by the tensor-core rate and
the 77-key cross-attention by the bytes of Q and O; this first kernel keeps
the [Tq, Tk] logits out of device memory but runs both products as float32
FMAs on the CUDA cores, so it sits far above the compute bound (its header
has the design, PERF.md the times).

Routing: a CPU tensor goes to `flash_attention_plain`; a CUDA tensor goes to
the kernel, which is built with nvcc on first use into
`aqualora_torch/_build/` and loaded with ctypes.  A failed build or launch
raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "flash_fwd.cu"
BUILD_DIR = _PKG / "_build"
MAX_HEAD_DIM = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Counts kernel launches: `count` in all, `by_shape[(H, Tq, Tk, D)]`
    per shape.  Only the wrapper's launch site adds to it."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.by_shape: collections.Counter = collections.Counter()


launches = LaunchCounter()
_lib = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain torch: float32 logits, softmax and
    products; O in the type of q, lse in float32 [B, H, Tq]."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    return o.to(q.dtype), lse


def _nvcc() -> str:
    """nvcc on PATH, else under the toolkit PyTorch finds (CUDA_HOME)."""
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the flash-attention kernel is "
                           "built from csrc/flash_fwd.cu with the CUDA toolkit")
    return path


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/flash_fwd.cu for sm_90a (once per source content) and
    load it.  With `verbose`, ptxas's register and spill report is printed."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"libflash_fwd_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.aqualora_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, T, D], got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"float32 or bfloat16")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} lies on {t.device}; want cpu or cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    b, h, tq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B, H, T, D]")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if min(b, h, tq, k.shape[2]) < 1:
        raise ValueError("empty attention input")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v and the row logsumexp, on [B, H, T, D]."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    lib = build()
    b, h, tq, d = q.shape
    tk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.aqualora_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, float(scale), _DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {err} "
                           f"at q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}")
    launches.count += 1
    launches.by_shape[(h, tq, tk, d)] += 1
    return o, lse
