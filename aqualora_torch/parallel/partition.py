"""Tensor parallelism for the U-Net: JAX's Megatron partition specs on the
port's diffusers names, applied by `ParallelStyle`s of the port's own.

The port of `aqualora_tpu/parallel/partition.py`.  On the torch layout
(`Linear.weight` is [out, in]) the specs are JAX's transposed:

  to_q/to_k/to_v.weight   [out, in]   -> ("model", None)   (column)
  to_out.0.weight         [out, in]   -> (None, "model")   (row)
  ff.net.0.proj.weight    [2*mid, in] -> ("model", None)   (column, GEGLU)
  ff.net.2.weight         [out, mid]  -> (None, "model")   (row)
  LoRA, convolutions, norms, biases    -> ()  replicated

JAX's GSPMD inserts the collectives from the specs alone; here
`shard_params` hands `parallelize_module` one style per sharded site, and
the styles keep this rank's rows or columns as plain tensors and run the
site with Megatron's conjugate collectives.  The stock `ColwiseParallel`
and `RowwiseParallel` do not fit, for three reasons the port handles:

- GEGLU: `GEGLU.forward` splits `proj`'s output in two halves, hidden and
  gate.  A plain column shard would give rank 0 the whole hidden half and
  rank 1 the whole gate half, so `ff.net.0.proj` is sharded half by half:
  each rank holds the matching hidden and gate columns;
- heads: `Attention.forward` splits `self.heads` heads of a width taken
  from q, so each rank runs heads / tp local heads of the full head width;
- LoRA on a sharded site stays replicated, as JAX keeps it.  At a column
  site the whole delta is computed from the replicated input and this
  rank's columns of it are added (each half's, for GEGLU); at a row site
  the input arrives sharded, so it is all-gathered for the LoRA branch.
  Either way the rank-R product, its kohya dropout masks (`SiteDraws`)
  and its diagonal act on the same elements as in the unsharded step, and
  every replicated tensor (LoRA, mapper, the residual stream) gets its
  whole gradient on every rank: no gradient needs reducing over `model`.

An int8 site (`ops/quant.py`: int8 codes in `weight`, float32
`weight_scale`) is sharded as JAX shards it, the codes as the weight and
the scale with them where it is per output (a column site's rows of both)
and whole where it is not (a row site's).  At a row site the product is
split along its input features, and `int8_dense` quantizes each row with
one scale from the absmax of the whole row: the site takes the local
absmax and max-reduces it over the model group (the reduction GSPMD
inserts in JAX) before it quantizes its columns at that scale
(`quant.quantize_rows_at`), sums the exact int32 accumulators over the
group (`quant.dense_accumulator`), and only then applies the scales and
the bias (`quant.dense_epilogue`), so each rank's output is the unsharded
site's bit for bit.  The int8 path is forward-only, as the unsharded one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor.parallel import ParallelStyle

from aqualora_torch.core.sharding import MODEL_AXIS
from aqualora_torch.ops import quant

Spec = Tuple[Optional[str], ...]
COLUMN: Spec = (MODEL_AXIS, None)
ROW: Spec = (None, MODEL_AXIS)
REPLICATED: Spec = ()

_COL = {"to_q", "to_k", "to_v"}


def _spec_for(name: str) -> Spec:
    """The spec of one U-Net parameter by its dotted diffusers name, JAX's
    `_spec_for` rule for rule."""
    path = name.split(".")
    if "lora" in path or path[-1] != "weight" or len(path) < 2:
        return REPLICATED
    parent = path[-2]
    if parent in _COL:
        return COLUMN
    if path[-3:-1] == ["to_out", "0"]:
        return ROW
    if path[-4:-1] == ["net", "0", "proj"]:
        return COLUMN
    if path[-3:-1] == ["net", "2"]:
        return ROW
    return REPLICATED


def unet_partition_specs(module: nn.Module) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of `module`."""
    return {name: _spec_for(name) for name, _ in module.named_parameters()}


# ---------------------------------------------------------------------------
# Megatron's conjugate collectives over the model group
# ---------------------------------------------------------------------------

def _pieces(x: torch.Tensor, tp: int, chunks: int) -> torch.Tensor:
    """The last axis of `x` as [..., chunks, tp, width]."""
    return x.reshape(*x.shape[:-1], chunks, tp, x.shape[-1] // (chunks * tp))


def _take(x: torch.Tensor, rank: int, tp: int, chunks: int) -> torch.Tensor:
    """Rank `rank`'s columns of each of `chunks` equal parts of the last
    axis."""
    p = _pieces(x, tp, chunks)[..., rank, :]
    return p.reshape(*x.shape[:-1], -1).contiguous()


def _all_gather_last(x: torch.Tensor, group, tp: int,
                     chunks: int) -> torch.Tensor:
    """The inverse of `_take` over the group: every rank's columns back in
    place."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp)]
    dist.all_gather(parts, x, group=group)
    w = x.shape[-1] // chunks
    stacked = torch.stack([p.reshape(*x.shape[:-1], chunks, w)
                           for p in parts], dim=-2)
    return stacked.reshape(*x.shape[:-1], chunks * tp * w)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's columns forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, rank, tp, chunks):
        ctx.args = (group, tp, chunks)
        return _take(x, rank, tp, chunks)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, *ctx.args), None, None, None, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather forward, this rank's columns backward."""

    @staticmethod
    def forward(ctx, x, group, rank, tp):
        ctx.args = (rank, tp)
        return _all_gather_last(x, group, tp, 1)

    @staticmethod
    def backward(ctx, g):
        rank, tp = ctx.args
        return _take(g, rank, tp, 1), None, None, None


# ---------------------------------------------------------------------------
# the styles
# ---------------------------------------------------------------------------

def _int8(m: nn.Module) -> bool:
    return m.weight.dtype == torch.int8


def row_absmax(x: torch.Tensor, group) -> torch.Tensor:
    """Each row of x [rows, k_local]'s absmax over all the input features:
    the local absmax, max-reduced over the model group (float32: exact for
    a float32 or bfloat16 x)."""
    a = x.detach().abs().amax(dim=-1).float()
    dist.all_reduce(a, op=dist.ReduceOp.MAX, group=group)
    return a


class _TPSite:
    """What a sharded `LoRALinear` runs instead of its own forward."""

    def __init__(self, group, rank: int, tp: int, chunks: int = 1):
        self.group, self.rank, self.tp, self.chunks = group, rank, tp, chunks


class _ColumnSite(_TPSite):
    def __call__(self, m, x, scale):
        bias = (None if m.bias is None else
                _take(m.bias, self.rank, self.tp, self.chunks))
        xin = _CopyToModel.apply(x, self.group)
        if _int8(m):
            y = quant.int8_dense(xin, m.weight, m.weight_scale, bias)
        else:
            y = F.linear(xin, m.weight.to(x.dtype), bias)
        if m.lora is not None and scale is not None:
            y = y + _ScatterToModel.apply(m._delta(x, scale), self.group,
                                          self.rank, self.tp, self.chunks)
        return y


class _RowSite(_TPSite):
    def __call__(self, m, x, scale):
        if _int8(m):
            y = self._int8_product(m, x)
        else:
            y = _ReduceFromModel.apply(F.linear(x, m.weight.to(x.dtype)),
                                       self.group)
            if m.bias is not None:
                y = y + m.bias.to(y.dtype)
        if m.lora is not None and scale is not None:
            full = _GatherFromModel.apply(x, self.group, self.rank, self.tp)
            y = y + m._delta(full, scale)
        return y

    @torch.no_grad()
    def _int8_product(self, m, x):
        lead, k = x.shape[:-1], x.shape[-1]
        rows = x.reshape(-1, k)
        xq, xs = quant.quantize_rows_at(rows, row_absmax(rows, self.group))
        acc = quant.dense_accumulator(xq, m.weight)
        dist.all_reduce(acc, group=self.group)        # int32: exact
        y = quant.dense_epilogue(acc, xs, m.weight_scale, m.bias, x.dtype)
        return y.reshape(*lead, -1)


def _check_site(module: nn.Module) -> None:
    from aqualora_torch.models.lora import LoRALinear

    if not isinstance(module, LoRALinear):
        raise TypeError(f"tensor parallelism shards LoRALinear sites, not "
                        f"{type(module).__name__}")


class LoRAColwiseParallel(ParallelStyle):
    """Column parallelism of a `LoRALinear`: this rank keeps its rows of
    the weight ([out, in]; int8 codes with their `weight_scale`), of each
    of `chunks` equal parts (2 for GEGLU's hidden and gate); the LoRA stays
    whole."""

    def __init__(self, chunks: int = 1):
        super().__init__()
        self.chunks = chunks

    def _apply(self, module: nn.Module, device_mesh) -> nn.Module:
        _check_site(module)
        tp, rank = device_mesh.size(), device_mesh.get_local_rank()
        w = module.weight.detach()
        if w.shape[0] % (self.chunks * tp):
            raise ValueError(f"{w.shape[0]} output features do not split "
                             f"into {self.chunks} x {tp}")
        local = _take(w.t(), rank, tp, self.chunks).t().contiguous()
        module.weight = nn.Parameter(local, requires_grad=False)
        if _int8(module):          # the scale is per output: its rows too
            module.weight_scale = nn.Parameter(_take(
                module.weight_scale.detach(), rank, tp, self.chunks),
                requires_grad=False)
        module.tp_site = _ColumnSite(device_mesh.get_group(), rank, tp,
                                     self.chunks)
        return module


class LoRARowwiseParallel(ParallelStyle):
    """Row parallelism of a `LoRALinear`: this rank keeps its columns of
    the weight (int8 codes too); the bias, an int8 site's `weight_scale`
    and the LoRA stay whole."""

    def _apply(self, module: nn.Module, device_mesh) -> nn.Module:
        _check_site(module)
        tp, rank = device_mesh.size(), device_mesh.get_local_rank()
        w = module.weight.detach()
        if w.shape[1] % tp:
            raise ValueError(f"{w.shape[1]} input features do not split "
                             f"into {tp}")
        module.weight = nn.Parameter(_take(w, rank, tp, 1),
                                     requires_grad=False)
        module.tp_site = _RowSite(device_mesh.get_group(), rank, tp)
        return module


def shard_params(mesh, module: nn.Module, specs: Dict[str, Spec]
                 ) -> nn.Module:
    """Shard `module`'s sites over the model axis of `mesh` by `specs`
    (`unet_partition_specs`) through `parallelize_module`, and give each
    attention its local heads.  A mesh whose model axis is 1 changes
    nothing."""
    from torch.distributed.tensor.parallel import parallelize_module

    from aqualora_torch.models.layers import Attention

    sub = mesh[MODEL_AXIS] if mesh.ndim > 1 else mesh
    tp = sub.size()
    if tp == 1:
        return module
    plan = {}
    for name, spec in specs.items():
        if spec == REPLICATED:
            continue
        site = name.rsplit(".", 1)[0]
        plan[site] = (LoRAColwiseParallel(2 if site.endswith("net.0.proj")
                                          else 1)
                      if spec == COLUMN else LoRARowwiseParallel())
    sharded = set(plan)
    for name, m in module.named_modules():
        if isinstance(m, Attention) and f"{name}.to_q" in sharded:
            if m.heads % tp:
                raise ValueError(f"{name}: {m.heads} heads over {tp} ranks")
            m.heads //= tp
    parallelize_module(module, sub, plan)
    return module
