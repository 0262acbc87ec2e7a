"""int8 weights and dynamic int8 activations (w8a8) for serving: the Hopper
CUDA kernels, their wrappers, their plain versions and the conversions of
the U-Net and the VAE decoder.

The port of `aqualora_tpu/ops/quant.py`.  The scheme is the JAX package's:

  weights     : symmetric int8 per output channel, scale = max(absmax,
                1e-12) / 127 over every other axis, codes = clip(rint(w /
                scale), -127, 127) (rint rounds half to even), quantized
                once (`quantize_weight`, `quantize_unet_int8`,
                `quantize_vae_decoder_int8`);
  activations : the same rule, dynamically at every call, over C*H*W of
                each image for a convolution and over the last axis of each
                row for a dense layer (`quantize_activations`);
  product     : int8 x int8 summed exactly in int32, then
                ((float32(acc) * x_scale) * w_scale) in that order, cast to
                the activation's type, plus the bias in that type.

A module takes the int8 path when its weight is int8 with a sibling
`weight_scale` (dtype-driven, no flag), as JAX's modules branch on an int8
kernel (`module_int8_apply`, `:88`): `models/layers.Conv2d` (the resnet,
downsample and upsample convolutions), `models/lora.LoRALinear` and
`LoRAConv2d` (the transformer sites, whose LoRA delta is added on top).
Weight codes keep the torch layout OIHW ([out, in] for a dense layer), and
a convolution's codes are stored channels-last, O x kh x kw x I in memory,
which is the order the kernel reads; `weight_scale` is float32 [out] and
stays float32 through `module.to(dtype)`.

On the card:
- `csrc/int8_quant.cu` quantizes an NCHW float32 or bfloat16 activation in
  two launches (a partial absmax per chunk of each image, then scale,
  round, clip and the int8 store), writing the codes NHWC (channels-last),
  the layout the convolution reads, and the float32 scale of each image.
- `csrc/int8_conv.cu` is an implicit-GEMM convolution on the tensor cores
  (mma.sync m16n8k32 s8 x s8 -> s32; M = B*Ho*Wo, N = Cout, K = kh*kw*Cin)
  for 3x3 stride 1 or 2 with padding 1 and 1x1, with the epilogue above
  fused; a dense layer is its 1x1 case over [rows, in, 1, 1] (one scale a
  row).
Neither replaces a TPU kernel: JAX's int8 product is
`lax.conv_general_dilated` / `dot_general` on int8 operands outside any
Pallas kernel (`:68-69,79-83`), and torch has no int8 convolution on CUDA.
What bounds them on this card, and the times: the sources' headers and
PERF.md.

Routing: a CPU tensor goes to the plain versions (`quantize_activations_plain`,
`conv_codes_plain`: the accumulator as a float64 convolution of the codes,
exact since |acc| <= 127^2 * 9 * 2560 < 2^53); a CUDA tensor goes to the
kernels, built with nvcc on first use (`ops/_build.py`).  A failed build or
launch raises; nothing falls back.  The int8 path is forward-only: it runs
without autograd, as the serving, teacher and stage-3 generation passes that
use it do.

`int8_attention(q, k, v, scale)` is the attention of JAX's
`AQUALORA_ATTN_IMPL=int8` serving experiment (`:107-146`), selected through
`ops/attention.py`: both products of softmax(q k^T * scale) v run on int8
codes, Q (pre-scaled) and K per token over D, the softmax P per query row
over Tk, V per channel over Tk.  On the card `csrc/int8_attention.cu` keeps
the [Tq, Tk] scores and P on chip (a first launch quantizes Q, K and V, the
second runs both products on the int8 tensor cores); on the CPU
`int8_attention_plain` follows JAX's op order.  It is forward-only, as
JAX's custom VJP is: the backward raises.  It replaces no TPU kernel (JAX
computes it in XLA ops).
"""

from __future__ import annotations

import copy
import ctypes
import itertools
from typing import List, Optional, Set, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from aqualora_torch.ops import _build

SCALE_FLOOR = 1e-12
# elements of one image a block of the quantizer's first launch reduces
QUANT_CHUNK = 8192
_ACT_DTYPES = (torch.float32, torch.bfloat16)

quant_launches = _build.LaunchCounter()   # by (groups, C, HW)
conv_launches = _build.LaunchCounter()    # by (B, Cin, H, W, Cout, k, stride)
attention_launches = _build.LaunchCounter()   # by (B, H, Tq, Tk, D)
ATTENTION_MAX_HEAD_DIM = 512

# The sites JAX quantizes (`aqualora_tpu/ops/quant.py:157-160`), by their
# flax names: the last component of the port's module path, with a list
# index joined to its parent's name (`to_out.0` -> to_out_0, `ff.net.2` ->
# net_2; GEGLU's `ff.net.0.proj` -> proj).  Dense sites need a 2-D weight,
# conv sites a 4-D one: a site of the wrong rank stays float, as in JAX.
DENSE_SITES = frozenset({"to_q", "to_k", "to_v", "to_out_0", "proj", "net_2"})
CONV_SITES = frozenset({"conv1", "conv2", "conv_shortcut", "conv", "proj_in",
                        "proj_out"})
MODES = ("conv", "dense", "all", "vae")
# the runners' --int8 choices (bare --int8 is conv)
MODE_CHOICES = ("conv", "dense", "all", "vae", "conv+vae", "dense+vae",
                "all+vae")


# -- the quantizer -----------------------------------------------------------
def _scale(absmax: torch.Tensor) -> torch.Tensor:
    # divided by a tensor: on CUDA, torch divides by a Python scalar as a
    # product with its reciprocal, which is not the division as written
    return torch.clamp_min(absmax, SCALE_FLOOR) / torch.full_like(absmax,
                                                                   127.0)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight [out, ...] -> (int8 codes of its shape, float32 scale [out]):
    symmetric per output channel, the absmax over every other axis
    (`quantize_kernel_int8`, `:37`, on the HWIO / [in, out] transpose).  A
    4-D weight's codes come back channels-last (O x kh x kw x I in memory),
    the order the convolution kernel reads."""
    wf = w.detach().float()
    scale = _scale(wf.abs().amax(dim=tuple(range(1, wf.dim()))))
    q = _codes(wf, scale.reshape(-1, *([1] * (wf.dim() - 1))))
    if q.dim() == 4:
        q = q.contiguous(memory_format=torch.channels_last)
    return q, scale


@torch.no_grad()
def quantize_activations_plain(x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [G, ...] -> (int8 codes of its shape, float32 scale [G]): one scale
    per leading index over all the rest (`_quantize_activations`, `:54`: an
    image's C*H*W for a convolution, a row for a dense layer)."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=tuple(range(1, xf.dim()))))
    return _codes(xf, scale.reshape(-1, *([1] * (xf.dim() - 1)))), scale


def _nhwc_strides(t: torch.Tensor) -> bool:
    """t [N, C, H, W] lies in memory as N x H x W x C (size-1 dims aside)."""
    n, c, h, w = t.shape
    want = (h * w * c, 1, w * c, c)
    return all(size == 1 or got == exp
               for size, got, exp in zip(t.shape, t.stride(), want))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t if _nhwc_strides(t) else t.contiguous(
        memory_format=torch.channels_last)


def _quantize_kernel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dtype not in _ACT_DTYPES:
        raise ValueError(f"the int8 quantizer takes float32 or bfloat16, got "
                         f"{x.dtype}")
    x = x.contiguous()
    g, c = x.shape[0], x.shape[1]
    hw = x[0, 0].numel()
    n = c * hw
    chunks = -(-n // QUANT_CHUNK)
    fn = _build.bind(_build.build("int8_quant"), "aqualora_int8_quant",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    partial = torch.empty(g * chunks, dtype=torch.float32, device=x.device)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device,
                        memory_format=torch.channels_last)
    scale = torch.empty(g, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), partial.data_ptr(), codes.data_ptr(),
                 scale.data_ptr(), int(x.dtype == torch.bfloat16), g, c, hw,
                 chunks, QUANT_CHUNK, stream)
    _build.check_launch(err, f"int8_quant at {tuple(x.shape)} {x.dtype}")
    quant_launches.add(g, c, hw)
    return codes, scale


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C, H, W] (float32 or bfloat16) -> (int8 codes [B, C, H, W]
    channels-last, float32 scale [B]), one scale per image.  The plain
    version on the CPU, `csrc/int8_quant.cu` on the card."""
    if x.dim() != 4:
        raise ValueError(f"quantize_activations takes [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        codes, scale = quantize_activations_plain(x)
        return codes.contiguous(memory_format=torch.channels_last), scale
    with torch.no_grad():
        return _quantize_kernel(x)


# -- the product -------------------------------------------------------------
def _out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def _epilogue(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
              bias: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """((float32(acc) * xs) * ws) -> out_dtype, + bias in out_dtype
    (`quant.py:84-85`, `models/layers.py:62-69`)."""
    y = (acc.float() * xs.reshape(-1, 1, 1, 1)) * ws.reshape(1, -1, 1, 1)
    y = y.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype).reshape(1, -1, 1, 1)
    return y


@torch.no_grad()
def conv_codes_plain(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                     ws: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     stride: int = 1, padding: int = 0,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the convolution kernel: int8 codes xq [B, Cin,
    H, W] (scale xs [B]) and wq [Cout, Cin, kh, kw] (scale ws [Cout]) ->
    [B, Cout, Ho, Wo] in out_dtype.  The accumulator is a float64
    convolution of the codes, exact (every partial sum is an integer below
    2^53) in any order of summation, then int32."""
    acc = F.conv2d(xq.double(), wq.double(), None, stride, padding)
    return _epilogue(acc.to(torch.int32), xs, ws, bias, out_dtype)


def _conv_kernel(xq, xs, wq, ws, bias, stride, padding, out_dtype):
    b, cin, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    if out_dtype not in _ACT_DTYPES:
        raise ValueError(f"int8_conv writes float32 or bfloat16, got "
                         f"{out_dtype}")
    if kh != kw or (kh, stride, padding) not in ((3, 1, 1), (3, 2, 1),
                                                 (1, 1, 0)):
        raise ValueError(f"int8_conv takes 3x3 stride 1 or 2 with padding 1 "
                         f"and 1x1 stride 1 without; got {kh}x{kw} stride "
                         f"{stride} padding {padding}")
    ho, wo = _out_size(h, kh, stride, padding), _out_size(w, kw, stride,
                                                          padding)
    xq, wq = _channels_last(xq), _channels_last(wq)
    xs = xs.float().contiguous()
    ws = ws.float().contiguous()
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    for t in (xs, wq, ws) + ((bias,) if bias is not None else ()):
        if t.device != xq.device:
            raise ValueError(f"devices differ: {t.device}, {xq.device}")
    if xs.shape != (b,) or ws.shape != (cout,) or (
            bias is not None and bias.shape != (cout,)):
        raise ValueError(f"scales {tuple(xs.shape)} / {tuple(ws.shape)} or "
                         f"bias do not fit B {b}, Cout {cout}")
    fn = _build.bind(_build.build("int8_conv"), "aqualora_int8_conv",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    out = torch.empty(b, cout, ho, wo, dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                 0 if bias is None else bias.data_ptr(), out.data_ptr(), b,
                 h, w, cin, cout, kh, stride, padding,
                 int(out_dtype == torch.bfloat16), stream)
    _build.check_launch(err, f"int8_conv at {tuple(xq.shape)} -> "
                             f"{tuple(out.shape)}")
    conv_launches.add(b, cin, h, w, cout, kh, stride)
    return out


def conv_codes(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
               ws: torch.Tensor, bias: Optional[torch.Tensor] = None,
               stride: int = 1, padding: int = 0,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 product of activation codes and weight codes with the
    epilogue: `conv_codes_plain` on the CPU, `csrc/int8_conv.cu` on the
    card."""
    for t in (xq, wq):
        if t.dtype != torch.int8 or t.dim() != 4:
            raise ValueError(f"int8 codes [N, C, H, W] expected, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if xq.shape[1] != wq.shape[1]:
        raise ValueError(f"Cin {xq.shape[1]} != the weight's {wq.shape[1]}")
    if xq.device.type == "cpu":
        return conv_codes_plain(xq, xs, wq, ws, bias, stride, padding,
                                out_dtype)
    with torch.no_grad():
        return _conv_kernel(xq, xs, wq, ws, bias, stride, padding, out_dtype)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              padding: int = 0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NCHW convolution with an int8 OIHW weight and per-image activation
    quantization (`int8_conv`, `:74`), plus the bias: [B, Cout, Ho, Wo] in
    out_dtype (x's type by default)."""
    xq, xs = quantize_activations(x)
    return conv_codes(xq, xs, wq, ws, bias, stride, padding,
                      out_dtype or x.dtype)


def int8_dense(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., in] times an int8 [out, in] weight with per-row activation
    quantization (`int8_dense`, `:65`), plus the bias: [..., out] in
    out_dtype (x's type by default).  The 1x1 case of `int8_conv` over
    [rows, in, 1, 1]: one image a row."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = int8_conv(x.reshape(-1, k, 1, 1), wq.reshape(*wq.shape, 1, 1), ws,
                  bias, out_dtype=out_dtype)
    return y.reshape(*lead, wq.shape[0])


# -- the pieces of int8_dense that tensor parallelism splits -----------------
# 127^2 * 1024 < 2^24: a sum of 1024 products of two codes is an integer that
# float32 holds exactly
ACC_EXACT_K = 1024


def quantize_rows_at(x: torch.Tensor, absmax: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, k] (float32 or bfloat16) and a per-row absmax [rows] at
    least each row's own -> (int8 codes [rows, k], float32 scale [rows]):
    the codes `int8_dense` gives these features of a wider row whose absmax
    is `absmax` (a row-parallel site's, whose rows are split across
    ranks).  The quantizer takes its scale from a row's absmax, so each row
    is given one more feature holding `absmax` (a value of x's type, since
    it is one of the wider row's), whose code is dropped after: no code of
    x changes."""
    aug = torch.cat([x, absmax.to(x.dtype)[:, None]], dim=1)
    codes, scale = quantize_activations(aug.reshape(*aug.shape, 1, 1))
    return codes.reshape(aug.shape)[:, :-1].contiguous(), scale


def dense_accumulator(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 codes xq [rows, k] times int8 codes wq [out, k] -> the exact
    int32 sums [rows, out], before any scale: `int8_dense`'s accumulator,
    which a row-parallel site sums across ranks.  The convolution at unit
    scales writes float32, which holds the sum exactly over at most
    ACC_EXACT_K features: k is taken in such chunks (one launch each on
    the card), their sums added in int32."""
    rows, out = xq.shape[0], wq.shape[0]
    ones_x = torch.ones(rows, device=xq.device)
    ones_w = torch.ones(out, device=wq.device)
    acc = None
    for k0 in range(0, xq.shape[1], ACC_EXACT_K):
        part = conv_codes(
            xq[:, k0:k0 + ACC_EXACT_K].contiguous()[:, :, None, None],
            ones_x,
            wq[:, k0:k0 + ACC_EXACT_K].contiguous()[:, :, None, None],
            ones_w, out_dtype=torch.float32)
        part = part.reshape(rows, out).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def dense_epilogue(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> torch.Tensor:
    """`int8_dense`'s epilogue on an int32 accumulator [rows, out]:
    ((float32(acc) * xs) * ws) -> out_dtype, + bias in out_dtype, as the
    kernel computes it."""
    return _epilogue(acc[:, :, None, None], xs, ws, bias,
                     out_dtype).reshape(acc.shape)


# -- int8 attention ----------------------------------------------------------
def _row_codes(x: torch.Tensor, dim: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of float32 `x` with one scale per slice along
    `dim` (`_quantize_activations` over one axis, the scale kept as a
    broadcast dimension)."""
    scale = _scale(x.abs().amax(dim=dim, keepdim=True))
    return _codes(x, scale), scale


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [..., M, K] times int8 b [..., K, N], summed exactly: a float64
    product of the codes (every partial sum is an integer below 127^2 * K <
    2^53), then int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


@torch.no_grad()
def int8_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """JAX's `int8_attention` (`aqualora_tpu/ops/quant.py:124-135`) op for
    op on [B, H, T, D]: qf = float32(q) * scale; Q and K codes per token
    over D; S = float32(int32 Qq Kq^T) * qs * ks^T; P = softmax(S) (exp(S -
    max) over its row sum); P codes per query row over Tk; V codes per
    channel over Tk; O = float32(int32 Pq Vq) * ps * vs in q's type.  Every
    scale is max(absmax, 1e-12) / 127 and every code clip(round(x /
    scale), -127, 127), rounding half to even."""
    qq, qs = _row_codes(q.float() * scale, -1)
    kq, ks = _row_codes(k.float(), -1)
    s = _int_product(qq, kq.transpose(-1, -2)).float() * qs \
        * ks.transpose(-1, -2)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pq, ps = _row_codes(p, -1)
    vq, vs = _row_codes(v.float(), -2)
    return (_int_product(pq, vq).float() * ps * vs).to(q.dtype)


def _attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.shape != (b, h, tk, d) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not fit q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in _ACT_DTYPES:
        raise ValueError(f"int8_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if not 1 <= d <= ATTENTION_MAX_HEAD_DIM or min(b, h, tq, tk) < 1:
        raise ValueError(f"int8_attention takes 1 <= D <= "
                         f"{ATTENTION_MAX_HEAD_DIM} and non-empty B, H, T; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh = b * h
    dp = -(-d // 32) * 32            # QK^T's depth, padded with zero codes
    tkp = -(-tk // 64) * 64          # PV's depth, padded with zero codes
    lib = _build.build("int8_attention")
    # V's channels, padded with zero rows: the kernel's own count
    dv = _build.bind(lib, "aqualora_int8_attention_v_rows", [ctypes.c_int])(d)
    fn = _build.bind(lib, "aqualora_int8_attention",
                     [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_void_p])
    dev = q.device
    empty = lambda *shape, dtype=torch.int8: torch.empty(
        shape, dtype=dtype, device=dev)
    qq, qs = empty(bh, tq, dp), empty(bh, tq, dtype=torch.float32)
    kq, ks = empty(bh, tk, dp), empty(bh, tk, dtype=torch.float32)
    vq, vs = empty(bh, dv, tkp), empty(bh, d, dtype=torch.float32)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 qq.data_ptr(), qs.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                 vq.data_ptr(), vs.data_ptr(), bh, tq, tk, d,
                 int(q.dtype == torch.bfloat16), float(scale), stream)
    _build.check_launch(err, f"int8_attention at q {tuple(q.shape)} k "
                             f"{tuple(k.shape)} {q.dtype}")
    attention_launches.add(b, h, tq, tk, d)
    return out


class Int8Attention(torch.autograd.Function):
    """The int8 attention forward; its backward raises, as JAX's custom VJP
    does (`:142-146`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            return int8_attention_plain(q, k, v, scale)
        return _attention_kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "int8_attention is a forward-only serving path (dynamic int8 "
            "rounding has about zero true gradient); use "
            "AQUALORA_ATTN_IMPL=auto, flash or xla for training")


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, T, D] with both products in
    dynamic int8 (float32 or bfloat16 in, q's type out): the plain version
    on the CPU, `csrc/int8_attention.cu` on the card.  Forward-only."""
    return Int8Attention.apply(q, k, v, float(scale))


# -- the conversions ---------------------------------------------------------
def jax_site(name: str) -> str:
    """The flax name of the site at module path `name`: its last component,
    a list index joined to its parent (`attn1.to_out.0` -> to_out_0)."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-1].isdigit():
        return f"{parts[-2]}_{parts[-1]}"
    return parts[-1]


def _selected(name: str, weight: torch.Tensor, include_convs: bool,
              include_dense: bool) -> bool:
    """JAX's rule (`quantize_unet_params_int8`, `:163-191`): name and rank."""
    if "lora" in name.split("."):
        return False
    site = jax_site(name)
    return ((include_dense and weight.dim() == 2 and site in DENSE_SITES)
            or (include_convs and weight.dim() == 4 and site in CONV_SITES))


def int8_sites(module: nn.Module, include_convs: bool = True,
               include_dense: bool = True) -> List[Tuple[str, nn.Module]]:
    """(path, layer) of every layer of `module` that JAX's rule quantizes."""
    out = []
    for name, m in module.named_modules():
        w = getattr(m, "weight", None)
        if isinstance(w, torch.Tensor) and name and _selected(
                name, w, include_convs, include_dense):
            if not isinstance(m, Int8Site):
                raise TypeError(f"{name} ({type(m).__name__}) is an int8 "
                                "site but not an int8-aware layer")
            out.append((name, m))
    return out


@torch.no_grad()
def quantize_layer_(m: nn.Module) -> None:
    """Replace an int8-aware layer's float weight by its int8 codes and add
    the float32 `weight_scale`, in place (frozen parameters)."""
    if m.weight.dtype == torch.int8:
        return
    q, scale = quantize_weight(m.weight)
    m.weight = nn.Parameter(q, requires_grad=False)
    m.weight_scale = nn.Parameter(scale, requires_grad=False)


def quantize_unet_int8(unet: nn.Module, include_convs: bool = True,
                       include_dense: bool = True) -> List[str]:
    """Quantize the U-Net's sites in place (`quantize_unet_params_int8`):
    the resnet, resample and proj_in/proj_out convolutions
    (`include_convs`; 96 in SD-1.5 and SD-2.1) and the attention and
    feed-forward dense layers (`include_dense`; 160).  LoRA pairs, conv_in,
    conv_out and the time-embedding MLPs stay float.  Returns the weight
    keys quantized."""
    sites = int8_sites(unet, include_convs, include_dense)
    for _, m in sites:
        quantize_layer_(m)
    return [f"{name}.weight" for name, _ in sites]


def quantize_vae_decoder_int8(vae: nn.Module) -> List[str]:
    """Quantize the VAE decoder's resnet and upsample convolutions in place
    (`quantize_vae_decoder_params_int8`, `:194-211`; 33 in SD-1.5); the
    encoder, the decoder's conv_in / conv_out, the 1x1 quant convs and the
    mid-block attention stay float.  Returns the weight keys quantized."""
    sites = [(f"decoder.{name}", m) for name, m in
             int8_sites(vae.decoder, include_convs=True, include_dense=False)]
    for _, m in sites:
        quantize_layer_(m)
    return [f"{name}.weight" for name, _ in sites]


def quantized_copy(unet: nn.Module, include_convs: bool = True,
                   include_dense: bool = False) -> nn.Module:
    """A twin of `unet` whose chosen sites hold int8 codes and which shares
    every other tensor with it (no copy): the PPFT teacher under
    `--teacher_int8`, quantized once at setup from the frozen base
    weights."""
    memo = {id(t): t for t in itertools.chain(unet.parameters(),
                                              unet.buffers())}
    twin = copy.deepcopy(unet, memo)
    quantize_unet_int8(twin, include_convs, include_dense)
    return twin


def parse_mode(int8) -> Set[str]:
    """simple_sample's `int8`: False / None (off), True (conv) or a mode
    string conv|dense|all[+vae]|vae -> its tokens; ValueError on anything
    else (`aqualora_tpu/eval/utils_eval.py:260-266`)."""
    if not int8:
        return set()
    tokens = {"conv"} if int8 is True else set(str(int8).split("+"))
    if not tokens <= set(MODES):
        raise ValueError(f"int8 mode {int8!r}; want conv|dense|all[+vae]|vae")
    return tokens


def mode_layers(tokens: Set[str], unet: nn.Module, vae: nn.Module
                ) -> List[Tuple[str, nn.Module]]:
    """(key prefix, layer) of every layer an int8 mode's tokens quantize:
    `unet.*` under conv / dense / all, `vae.decoder.*` under vae."""
    out = []
    if tokens & {"conv", "dense", "all"}:
        out += [(f"unet.{name}", m) for name, m in int8_sites(
            unet, include_convs=bool(tokens & {"conv", "all"}),
            include_dense=bool(tokens & {"dense", "all"}))]
    if "vae" in tokens:
        out += [(f"vae.decoder.{name}", m) for name, m in int8_sites(
            vae.decoder, include_convs=True, include_dense=False)]
    return out


def apply_mode(tokens: Set[str], unet: nn.Module, vae: nn.Module
               ) -> List[str]:
    """Quantize a pipeline's U-Net and VAE decoder for an int8 mode's
    tokens (after any fold); returns the weight keys quantized."""
    layers = mode_layers(tokens, unet, vae)
    for _, m in layers:
        quantize_layer_(m)
    return [f"{name}.weight" for name, _ in layers]


class Int8Site(nn.Module):
    """A layer that takes the int8 path when its `weight` is int8 with a
    sibling `weight_scale`.  `weight_scale` stays float32 when the module is
    cast (`module.to(torch.bfloat16)`), as JAX keeps `kernel_scale`
    float32."""

    def _apply(self, fn, recurse=True):
        scale = self._parameters.get("weight_scale")
        saved = None if scale is None else scale.data
        out = super()._apply(fn, recurse)
        if saved is not None and self.weight_scale.dtype != torch.float32:
            self.weight_scale.data = saved.to(self.weight_scale.device)
        return out
