"""Flash attention on Hopper: the CUDA kernels, their wrappers, their plain
versions and the autograd function that joins them.

`flash_attention(q, k, v, scale)` computes unmasked softmax(q k^T * scale) v
over [B, H, T, D] tensors and is differentiable: it is the counterpart of the
JAX package's `custom_vjp` (`aqualora_tpu/ops/flash_attention.py:367-384`).

- `flash_attention_fwd(q, k, v, scale) -> (o, lse)` runs the forward kernel
  (`csrc/flash_fwd.cu`, replacing the TPU's `_fwd_kernel`, `:147`) and gives
  the float32 row logsumexp `lse [B, H, Tq]` that the backward reads.
- `flash_attention_bwd(q, k, v, o, lse, do, scale) -> (dq, dk, dv)` runs the
  two backward kernels (`csrc/flash_bwd.cu`): `flash_attention_bwd_dq`
  replaces `_dq_kernel` (`:239`) and `flash_attention_bwd_dkv` replaces
  `_dkv_kernel` (`:269`), both recomputing P from `lse`.  delta = rowsum(dO
  o O) is a torch reduction (`attention_delta`), as the JAX package computes
  it outside Pallas (`:311`).
- `fwd_tile_rows(q)` says which tiling the bf16 forward picks for a CUDA
  query (it depends on the batch and the card's SM count), so that checks
  can name the instance they reach.

On the H100 the self-attention shapes are bound by the tensor-core rate and
the 77-key cross-attention by the bytes of Q, O (and dO).  The kernels keep
the [Tq, Tk] logits, P and dS out of device memory.  In bf16 the forward
and the backward run their products on tensor cores (mma.sync, fed by
cp.async; P rounded to bf16 only as a register operand).  In float32 the
d = 512 forward and backward (stage 1's VAE mid-block, its default type)
run TF32 tensor-core products split three ways (3xTF32), and the float32
instances at d <= 160 run float32 FMAs on the CUDA cores; both keep the
float32 limits (the sources' headers have the design, PERF.md the times).

Routing: a CPU tensor goes to the plain versions (`flash_attention_plain`,
`flash_attention_dq_plain`, `flash_attention_dkv_plain`); a CUDA tensor goes
to the kernels, which are
built with nvcc on first use (`ops/_build.py`).  A failed build or launch
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from aqualora_torch.ops import _build

MAX_HEAD_DIM = 512
MAX_BWD_HEAD_DIM = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


# launches per kernel, by (H, Tq, Tk, D)
launches = _build.LaunchCounter()          # forward
dq_launches = _build.LaunchCounter()       # backward, dQ
dkv_launches = _build.LaunchCounter()      # backward, dK/dV


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain torch: float32 logits, softmax and products; O
    in the type of q, lse in float32 [B, H, Tq]."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    return o.to(q.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o O), float32 [B, H, Tq]: what both backward
    kernels read beside lse (the JAX package's XLA reduction, `:311`)."""
    return (do.float() * o.float()).sum(-1)


def _p_ds(q, k, v, do, lse, delta, scale):
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    return qf, kf, dof, p, ds


def flash_attention_dq_plain(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """The dQ kernel's function in plain torch: P = exp(S*scale - L),
    dS = P o (dO V^T - delta), dQ = dS K * scale; float32, dQ in q's type."""
    _, kf, _, _, ds = _p_ds(q, k, v, do, lse, delta, scale)
    return (torch.matmul(ds, kf) * scale).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, scale
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain torch: dK = dS^T Q * scale,
    dV = P^T dO; float32, each in its input's type."""
    qf, _, dof, p, ds = _p_ds(q, k, v, do, lse, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward in plain torch, recomputing P from the saved lse:
    delta, then the two kernels' functions."""
    delta = attention_delta(o, do)
    return (flash_attention_dq_plain(q, k, v, do, lse, delta, scale),
            *flash_attention_dkv_plain(q, k, v, do, lse, delta, scale))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           max_d: int = MAX_HEAD_DIM) -> None:
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
    if not 1 <= d <= max_d:
        raise ValueError(f"head dim {d} outside 1..{max_d}")
    if min(b, h, tq, k.shape[2]) < 1:
        raise ValueError("empty attention input")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v and the row logsumexp, on [B, H, T, D].
    `scale` must be positive: the bf16 kernel takes the row max of the
    unscaled scores."""
    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    fn = _build.bind(_build.build("flash_fwd"), "aqualora_flash_fwd",
                     [_P] * 5 + [_I] * 5 + [ctypes.c_float, _I, _P])
    b, h, tq, d = q.shape
    tk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, tq, tk, d, float(scale),
                 _DTYPES[q.dtype], stream)
    _build.check_launch(err, f"flash_fwd at q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, {q.dtype}")
    launches.add(h, tq, tk, d)
    return o, lse


def fwd_tile_rows(q: torch.Tensor) -> int:
    """The query rows per block of the bf16 forward kernel that
    `flash_attention_fwd` launches for this CUDA query on its card: 128 or
    64 for wide tiles, 16 where the warps split the keys, 32 at d > 160.
    Which tiling a shape gets depends on the card's SM count; the kernel
    decides, this reads its decision."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or q.dim() != 4:
        raise ValueError(f"want a bf16 [B, H, T, D] CUDA query, got "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    fn = _build.bind(_build.build("flash_fwd"), "aqualora_flash_fwd_tc_rows",
                     [_I] * 4)
    b, h, tq, d = q.shape
    with torch.cuda.device(q.device):
        return fn(b, h, tq, d)


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v, MAX_BWD_HEAD_DIM)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, "
                             f"got {tuple(t.shape)} {t.dtype}")


def _launch_bwd(symbol, counter, q, k, v, do, lse, delta, outs, scale):
    fn = _build.bind(_build.build("flash_bwd"), symbol,
                     [_P] * (6 + len(outs)) + [_I] * 5
                     + [ctypes.c_float, _I, _P])
    b, h, tq, d = q.shape
    tk = k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), b, h, tq, tk, d,
                 float(scale), _DTYPES[q.dtype], stream)
    _build.check_launch(err, f"{symbol} at q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, {q.dtype}")
    counter.add(h, tq, tk, d)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """dQ from the forward's lse and `attention_delta`: the dQ kernel on a
    CUDA tensor, `flash_attention_dq_plain` on a CPU tensor."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, scale)
    dq = torch.empty_like(q)
    _launch_bwd("aqualora_flash_bwd_dq", dq_launches, q, k, v, do, lse,
                delta, (dq,), scale)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV): the dK/dV kernel on a CUDA tensor,
    `flash_attention_dkv_plain` on a CPU tensor."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("aqualora_flash_bwd_dkv", dkv_launches, q, k, v, do, lse,
                delta, (dk, dv), scale)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of softmax(q k^T * scale) v for the output gradient
    `do`, from the forward's `o` and `lse`, at head dims up to 512 (the
    VAE mid-block's d = 512, differentiated in stage 1, has kernels of its
    own)."""
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    delta = attention_delta(o, do)
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


class FlashAttention(torch.autograd.Function):
    """Forward kernel; backward kernels from the saved q, k, v, o, lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives through the transpose of merge_heads
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Differentiable softmax(q k^T * scale) v over [B, H, T, D].  With no
    input requiring grad this is the forward kernel's single launch."""
    return FlashAttention.apply(q, k, v, scale)
