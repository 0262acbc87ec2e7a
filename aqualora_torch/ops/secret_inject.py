"""Fused secret injection: the Hopper CUDA kernel, its wrapper and its plain
version.

`fused_secret_inject(latent, msg, dense_w, dense_b, conv_w, conv_b,
base_res)` adds the SecretEncoder's watermark of `msg` to an NCHW latent of
side 2 * base_res, in the latent's type:

    latent + conv3x3(nearest_x2(repeat_C(silu(msg W^T + b))))

It replaces the TPU kernel `_kernel` (`aqualora_tpu/ops/secret_inject.py:47`,
launched by `_pallas_inject`) and the XLA ops around it: on the card the
whole function is one launch of `csrc/secret_inject.cu`, which computes the
dense layer, SiLU, the nearest x2 upsample and the zero pad by index
arithmetic, and folds the channel repeat into the conv: conv(repeat(u), K) =
conv(u, sum over input channels of K), one single-channel 3x3 stencil per
output channel.  It reads every input in its own type (float32 or bfloat16)
and computes in float32.  The launch bounds it at the PPFT shape (B8 x 4 x
64 x 64); PERF.md has the times.

Weights use the torch layouts of `SecretEncoder`: `dense_w` [base^2, bits],
`conv_w` OIHW [C, C, 3, 3].  The backward recomputes `inject_plain` under
autograd, as the TPU's `_bwd` does with `_reference_inject` (stage 2 never
takes it: its injection is stop-gradient).

Routing: a CPU tensor goes to `inject_plain`, a CUDA tensor to the kernel
(built on first use, `ops/_build.py`).  A failed build or launch raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from aqualora_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)     # what the kernel reads

launches = _build.LaunchCounter()          # by (B, C, H, W)


def inject_plain(latent: torch.Tensor, msg: torch.Tensor,
                 dense_w: torch.Tensor, dense_b: torch.Tensor,
                 conv_w: torch.Tensor, conv_b: torch.Tensor,
                 base_res: int) -> torch.Tensor:
    """The counterpart of `_reference_inject` (NCHW): the SecretEncoder's
    encode without its final resize, added to the latent; float32
    arithmetic, the result in the latent's type."""
    h = F.silu(F.linear(msg.float(), dense_w.float(), dense_b.float()))
    b, c_in = h.shape[0], conv_w.shape[1]
    grid = h.reshape(b, 1, base_res, base_res).expand(b, c_in, base_res,
                                                      base_res)
    grid = F.interpolate(grid, scale_factor=2.0, mode="nearest")
    wm = F.conv2d(grid, conv_w.float(), conv_b.float(), padding=1)
    return (latent.float() + wm).to(latent.dtype)


def _check(latent, msg, dense_w, dense_b, conv_w, conv_b, base_res) -> None:
    if latent.dim() != 4 or latent.dtype not in _DTYPES:
        raise ValueError(f"latent must be float32 or bfloat16 [B, C, H, W], "
                         f"got {tuple(latent.shape)} {latent.dtype}")
    b, c, h, w = latent.shape
    if h != 2 * base_res or w != 2 * base_res:
        raise ValueError(f"latent side {h}x{w} is not 2 * base_res "
                         f"({base_res})")
    if msg.dim() != 2 or msg.shape[0] != b:
        raise ValueError(f"msg must be [B, bits], got {tuple(msg.shape)}")
    if (dense_w.shape != (base_res * base_res, msg.shape[1])
            or dense_b.shape != (base_res * base_res,)):
        raise ValueError(f"dense {tuple(dense_w.shape)} / "
                         f"{tuple(dense_b.shape)} do not fit msg "
                         f"{tuple(msg.shape)} and base_res {base_res}")
    if conv_w.shape[0] != c or conv_w.shape[2:] != (3, 3) \
            or conv_b.shape != (c,):
        raise ValueError(f"conv {tuple(conv_w.shape)} / {tuple(conv_b.shape)}"
                         f" do not fit {c} latent channels")
    for t in (msg, dense_w, dense_b, conv_w, conv_b):
        if t.device != latent.device:
            raise ValueError(f"devices differ: {t.device}, {latent.device}")


def _inject(latent, msg, dense_w, dense_b, conv_w, conv_b, base_res):
    _check(latent, msg, dense_w, dense_b, conv_w, conv_b, base_res)
    if latent.device.type == "cpu":
        return inject_plain(latent, msg, dense_w, dense_b, conv_w, conv_b,
                            base_res)
    ins = (latent, msg, dense_w, dense_b, conv_w, conv_b)
    for t in ins:
        if t.dtype not in _DTYPES:
            raise ValueError(f"the kernel takes float32 or bfloat16 inputs, "
                             f"got {t.dtype}")
    fn = _build.bind(_build.build("secret_inject"), "aqualora_secret_inject",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    # contiguous inputs (the trainer's) are taken as they are: no device op
    # but the launch
    ins = tuple(t.contiguous() for t in ins)
    b, c, h, w = latent.shape
    out = torch.empty_like(ins[0])
    dtypes = sum(1 << i for i, t in enumerate(ins)
                 if t.dtype == torch.bfloat16)
    with torch.cuda.device(latent.device):
        stream = torch.cuda.current_stream(latent.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), out.data_ptr(), b, c,
                 conv_w.shape[1], base_res, msg.shape[1], dtypes, stream)
    _build.check_launch(err, f"secret_inject at {tuple(latent.shape)} "
                             f"{latent.dtype}")
    launches.add(b, c, h, w)
    return out


class FusedSecretInject(torch.autograd.Function):
    """Forward: the kernel (plain on the CPU).  Backward: `inject_plain`
    recomputed under autograd."""

    @staticmethod
    def forward(ctx, latent, msg, dense_w, dense_b, conv_w, conv_b,
                base_res: int):
        ctx.save_for_backward(latent, msg, dense_w, dense_b, conv_w, conv_b)
        ctx.base_res = base_res
        return _inject(latent, msg, dense_w, dense_b, conv_w, conv_b,
                       base_res)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, want)]
            out = inject_plain(*leaves, ctx.base_res)
            wrt = [t for t, need in zip(leaves, want) if need]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if need else None for need in want), None)


def fused_secret_inject(latent: torch.Tensor, msg: torch.Tensor,
                        dense_w: torch.Tensor, dense_b: torch.Tensor,
                        conv_w: torch.Tensor, conv_b: torch.Tensor,
                        base_res: int = 32) -> torch.Tensor:
    """latent [B, C, 2*base_res, 2*base_res] + the watermark of msg."""
    return FusedSecretInject.apply(latent, msg, dense_w, dense_b, conv_w,
                                   conv_b, base_res)


def inject_from_params(params: Mapping[str, torch.Tensor],
                       latent: torch.Tensor, msg: torch.Tensor,
                       base_res: int = 32) -> torch.Tensor:
    """A SecretEncoder's parameters (its `state_dict()` keys) -> the fused
    injection."""
    return fused_secret_inject(latent, msg, params["secret_dense.weight"],
                               params["secret_dense.bias"],
                               params["conv_out.weight"],
                               params["conv_out.bias"], base_res)
