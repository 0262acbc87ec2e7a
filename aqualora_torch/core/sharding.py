"""Process groups, meshes and data parallelism, over `torch.distributed`.

The port of `aqualora_tpu/core/sharding.py`.  The reference's only
parallelism is accelerate's DDP over NCCL (`train/ppft_train.py:479-484`);
the JAX package shards the batch over the `data` axis of a
`jax.sharding.Mesh` and lets GSPMD insert the collectives.  Here every
process of a `torchrun` launch is one rank:

- `init_distributed(device)` reads `RANK`, `WORLD_SIZE` and `LOCAL_RANK` as
  `torchrun` sets them and builds the default group: NCCL on
  `cuda:LOCAL_RANK`, gloo on the CPU.  Without them it returns a world of 1
  and builds no group, so a plain `python -m ...` run is what it was;
- `make_mesh(data, model)` is an `init_device_mesh` over the world shaped
  (data, model) with JAX's axis names;
- the batch is sharded by `shard_batch`, each rank taking its contiguous
  slice of the global batch (JAX's `P("data")` order), and the trainables'
  gradients are averaged by `average_gradients` (one coalesced all-reduce)
  before the optimizer, where JAX's GSPMD emits the all-reduce;
- `fsdp_spec` is JAX's ZeRO/FSDP rule letter for letter, as a placement:
  `shard_frozen` shards a frozen tower with FSDP2's `fully_shard` by it,
  and the trainers' `--fsdp` shards the optimizer moments ZeRO-1 style
  (`zero_optimizer`).

A JAX device can sit idle when the batch does not fill the mesh
(`make_data_mesh` takes the largest device count dividing the batch); a
`torchrun` process cannot, so `make_data_mesh` refuses a world size that
does not divide the global batch, rather than hang in a collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
FSDP_MIN_BYTES = 2 ** 14


@dataclasses.dataclass(frozen=True)
class World:
    """This process's rank, the world size and its device."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")


def init_distributed(device: str | torch.device = "cuda",
                     backend: Optional[str] = None) -> World:
    """The default process group of a `torchrun` launch on `device`'s type:
    NCCL on `cuda:LOCAL_RANK` (taken modulo the visible cards, so that two
    ranks can share one card under `backend="gloo"`), gloo on the CPU.
    Without `RANK` and `WORLD_SIZE` in the environment, a world of 1 on
    `device` and no group.  A group that exists already is reused."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(),
                     _rank_device(device))
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return World(0, 1, device)
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        device_id=device if device.type == "cuda" and backend in (
            None, "nccl") else None)
    return World(dist.get_rank(), dist.get_world_size(), device)


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def world() -> World:
    """The current world (of 1 without a group); the device is the CPU's
    or the current card's."""
    if dist.is_available() and dist.is_initialized():
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
        return World(dist.get_rank(), dist.get_world_size(), dev)
    return World()


def is_main_process() -> bool:
    """Rank-0 guard, `accelerator.is_main_process`."""
    return world().rank == 0


def say(*args, **kwargs) -> None:
    """`print` on the main process only."""
    if is_main_process():
        print(*args, **kwargs)


def data_axis_size(global_batch: int, n_devices: int) -> int:
    """JAX's `make_data_mesh` rule as a function of the device count: the
    largest count up to `n_devices` that divides the batch (not the gcd:
    a batch of 6 on 8 devices uses 6)."""
    global_batch = max(1, global_batch)
    return max(d for d in range(1, min(global_batch, n_devices) + 1)
               if global_batch % d == 0)


def check_world_divides(global_batch: int, n: int) -> None:
    """Every rank must take an equal slice of the global batch."""
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the {n} "
            f"data-parallel ranks: JAX would use {data_axis_size(global_batch, n)} "
            "of its devices and leave the rest idle, but a torchrun process "
            "cannot idle; launch a world size that divides the batch")


def setup_world(device: str | torch.device, global_batch: int,
                fsdp: bool = False, force_fsdp: bool = False
                ) -> Tuple[World, Optional[dist.ProcessGroup], bool]:
    """A trainer's world: `init_distributed(device)`, the refusal of a
    world size that does not divide `global_batch`, and -> (world, the
    data-parallel group or None, whether `--fsdp` takes effect: at a world
    size above 1, as in JAX, or at any size with `force_fsdp`)."""
    w = init_distributed(device)
    check_world_divides(global_batch, w.size)
    return w, data_group(), force_fsdp or (fsdp and w.size > 1)


def make_mesh(data: Optional[int] = None, model: int = 1):
    """A (data, model) `DeviceMesh` over the world, JAX's axis names;
    pure data parallelism by default.  Needs the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    w = world()
    if data is None:
        data = w.size // model
    if data * model != w.size:
        raise ValueError(f"mesh {data}x{model} != {w.size} ranks")
    return init_device_mesh(w.device.type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def make_data_mesh(global_batch: int):
    """The pure data-parallel mesh over every rank; a ValueError naming
    both numbers when the world size does not divide the batch."""
    check_world_divides(global_batch, world().size)
    return make_mesh()


def data_mesh_or_none(global_batch: int):
    """`make_data_mesh`, or None in a world of 1 (no group, nothing to
    shard)."""
    if world().size == 1:
        return None
    return make_data_mesh(global_batch)


def local_batch_size(global_batch: int, n: int) -> int:
    """This rank's share of the global batch over `n` data ranks."""
    check_world_divides(global_batch, n)
    return global_batch // n


def batch_slice(global_batch: int, rank: int, n: int) -> slice:
    """The rows of the global batch that data rank `rank` of `n` takes."""
    b = local_batch_size(global_batch, n)
    return slice(rank * b, (rank + 1) * b)


def shard_batch(batch: Any, rank: int, n: int) -> Any:
    """This rank's contiguous slice of every leaf of a global batch
    (arrays, tensors and lists on their leading axis, through tuples and
    dicts; None stays None)."""
    if n == 1 or batch is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, n) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, rank, n) for v in batch)
    return batch[batch_slice(len(batch), rank, n)]


def world_group() -> Optional[dist.ProcessGroup]:
    """The default group, when one was built (a `torchrun` world of 1
    too); None otherwise."""
    return dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() else None


def data_group(mesh=None) -> Optional[dist.ProcessGroup]:
    """The group that averages gradients: the mesh's data axis, or the
    whole world without a mesh; None without a process group."""
    if mesh is not None:
        return mesh[DATA_AXIS].get_group()
    return world_group()


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# the gradient all-reduce
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommStats:
    """What `average_gradients` moved: calls, bytes reduced and, when
    `timed` (the caller's choice: it synchronises the device around each
    all-reduce), the milliseconds they took."""

    timed: bool = False
    calls: int = 0
    bytes: int = 0
    ms: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.ms = 0, 0, 0.0


comm_stats = CommStats()


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor],
                      group: Optional[dist.ProcessGroup]) -> None:
    """Average the parameters' `.grad` over `group` in one coalesced
    all-reduce (a flat buffer per dtype) divided by the group's size; a
    parameter without a gradient enters as zeros and keeps None (every rank
    runs the same graph, so the same parameters have none).  Nothing to do
    without a group; a group of 1 (a `torchrun` world of 1) reduces all
    the same, which leaves the values as they are."""
    if group is None:
        return
    n = group_size(group)
    params = list(params)
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps])
        if comm_stats.timed:
            _sync(flat)
            t0 = time.perf_counter()
        dist.all_reduce(flat, group=group)
        if comm_stats.timed:
            _sync(flat)
            comm_stats.ms += 1e3 * (time.perf_counter() - t0)
        comm_stats.calls += 1
        comm_stats.bytes += flat.numel() * flat.element_size()
        flat.div_(n)
        offset = 0
        for p in ps:
            k = p.numel()
            if p.grad is not None:
                p.grad.copy_(flat[offset:offset + k].view_as(p))
            offset += k


class _SumOver(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the gradients too: a
    quantity summed over the ranks feeds every rank's loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(t: torch.Tensor, group: Optional[dist.ProcessGroup]
             ) -> torch.Tensor:
    """The sum of `t` over `group`, differentiable (see `_SumOver`)."""
    return _SumOver.apply(t, group)


def mean_over(t: torch.Tensor, group: Optional[dist.ProcessGroup]
              ) -> torch.Tensor:
    """The mean of a scalar metric over `group` (the global value of a
    mean over equal slices); `t` itself without a group."""
    if group is None:
        return t
    out = t.detach().float().clone()
    dist.all_reduce(out, group=group)
    return out / group_size(group)


# ---------------------------------------------------------------------------
# ZeRO-1 / weight-FSDP
# ---------------------------------------------------------------------------

def fsdp_spec(shape: Sequence[int], itemsize: int, n: int):
    """JAX's `fsdp_spec` for one leaf of `shape` and element size over `n`
    ranks, as a placement: `Shard(d)` on the largest dimension divisible by
    n; `Replicate()` for a leaf under FSDP_MIN_BYTES, a leaf with no
    divisible dimension, or n = 1."""
    from torch.distributed.tensor import Replicate, Shard

    shape = tuple(shape)
    if n <= 1 or int(np.prod(shape, dtype=np.int64)) * max(itemsize, 1) \
            < FSDP_MIN_BYTES:
        return Replicate()
    divisible = [d for d in range(len(shape)) if shape[d] % n == 0]
    if not divisible:
        return Replicate()
    return Shard(max(divisible, key=lambda d: shape[d]))


def shard_frozen(module: nn.Module, mesh, blocks: Sequence[nn.Module] = (),
                 root: bool = True,
                 keep: Iterable[nn.Parameter] = ()) -> nn.Module:
    """Shard a frozen tower over the data axis of `mesh` with FSDP2's
    `fully_shard`, each parameter by `fsdp_spec` (the ones it replicates,
    and `keep`, stay plain and whole on every rank).  Each of `blocks` is
    one group, all-gathered at its own forward and freed after; the rest
    is the root's group (with `root`), gathered for the module's forward.
    The parameters have no gradient, so nothing is reduced.  On a mesh of
    one rank (`--fsdp` forced in a world of 1) JAX's rule would replicate
    everything; there each leaf of `min_size` bytes or more is "sharded"
    whole over the one rank on its largest dimension, so that FSDP's
    gathers and frees run as they would across ranks."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    sub = mesh[DATA_AXIS] if mesh.ndim > 1 else mesh
    n = sub.size()

    def placement(p):
        if n > 1:
            return fsdp_spec(p.shape, p.element_size(), n)
        if p.numel() * p.element_size() < FSDP_MIN_BYTES or not p.dim():
            return fsdp_spec((), 1, 1)
        return Shard(max(range(p.dim()), key=lambda d: p.shape[d]))

    kept = {p for p in keep}
    kept.update(p for p in module.parameters()
                if not isinstance(placement(p), Shard))

    for b in blocks:
        fully_shard(b, mesh=sub, shard_placement_fn=placement,
                    ignored_params=kept & set(b.parameters()))
    if root:
        fully_shard(module, mesh=sub, shard_placement_fn=placement,
                    ignored_params=kept & set(module.parameters()))
    return module


@contextlib.contextmanager
def gathered(module: nn.Module):
    """`module`'s parameters whole inside the context when FSDP shards them
    (for code that reads them outside the module's forward, as the fused
    injection reads the SecretEncoder's)."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(module, FSDPModule):
        yield module
        return
    module.unshard()
    try:
        yield module
    finally:
        module.reshard()


def local_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes this rank holds of `tensors` (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def zero_optimizer(param_groups: List[dict], optimizer_class, group,
                   **defaults):
    """ZeRO-1: `ZeroRedundancyOptimizer` over `optimizer_class` (AdamW or
    the port's 8-bit AdamW): each rank keeps the moments of its share of
    the parameters, steps them and broadcasts them to the others."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(param_groups, optimizer_class,
                                   process_group=group, **defaults)


def optimizer_state(optimizer) -> dict:
    """The optimizer's whole state, for a checkpoint: a collective for a
    ZeRO optimizer (consolidated on rank 0, which alone writes; every rank
    must call it, or the save hangs), the plain state dict otherwise."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer.consolidate_state_dict(to=0)
        return optimizer.state_dict() if is_main_process() else {}
    return optimizer.state_dict()


def save_checkpoint(ckpt, step: int, state_fn) -> None:
    """A collective checkpoint save: every rank builds `state_fn()` (the
    ZeRO moments are consolidated on rank 0 inside it), rank 0 writes it
    to `ckpt` at `step`, and the ranks meet after the write."""
    state = state_fn()
    if is_main_process():
        ckpt.save(step, state)
    barrier()


def barrier() -> None:
    if world().size > 1:
        dist.barrier()


def mesh_shape(mesh) -> Tuple[int, int]:
    """(data, model) of a mesh, (1, 1) for None."""
    if mesh is None:
        return 1, 1
    return mesh[DATA_AXIS].size(), mesh[MODEL_AXIS].size()
