"""The golden gate, run_parity, the demo and a tensor-parallel int8 U-Net on
two ranks, for checks against one process.

`ranks_worker` is a spawned rank (`parallel/dryrun.Spawned`, gloo on the
CPU) that runs each case once on the inputs of a spec file and has rank 0
save what each gave:

- `golden_gate.main`, `run_parity.main` and `run_demo.main` on the spec's
  argv (`gate`, `parity`, `demo`: their results, and the bytes of the
  PNGs and JSON files they wrote under `<root>/<case>`);
- the refusal of a world that does not divide the batch, by each of the
  three, before any file is written (`refusals`, `refused_files`);
- the tiny U-Net with int8 sites (`unet_int8`: {mode: the output with the
  U-Net sharded over a model axis of 2 by `parallel/partition.py`}), and
  the same with the row sites' absmax left unreduced (`unet_int8_local`).

A spawned child imports its target's module, so this helper of
`test_torch_port_ranks.py` imports nothing of JAX (the test does).
"""

from __future__ import annotations

import glob
import os

import torch
import torch.distributed as dist

from aqualora_torch.parallel.dryrun import init_worker


def written(root: str) -> dict:
    """{path under `root`: bytes} of every PNG and JSON file below it."""
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                                      recursive=True))
            if p.endswith((".png", ".json"))}


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def tp_int8_unet(spec: dict, mode: str, mesh=None):
    """The tiny U-Net with `mode`'s int8 sites loaded from the spec's
    state, sharded over `mesh`'s model axis when one is given; -> its
    output on the spec's inputs."""
    from aqualora_torch.core.config import PipelineConfig
    from aqualora_torch.models.unet import UNet2DConditionModel
    from aqualora_torch.ops import quant
    from aqualora_torch.parallel import partition

    unet = UNet2DConditionModel(PipelineConfig.tiny().unet)
    quant.quantize_unet_int8(unet, mode != "dense", True)
    unet.load_state_dict(spec["int8_states"][mode], strict=True)
    if mesh is not None:
        partition.shard_params(mesh, unet,
                               partition.unet_partition_specs(unet))
    with torch.no_grad():
        return unet(*spec["unet_inputs"]).numpy()


def run_cases(spec: dict) -> dict:
    """Every case of the module docstring on this rank; -> the results
    (the same on every rank)."""
    from aqualora_torch import run_demo
    from aqualora_torch.core import sharding
    from aqualora_torch.parallel import partition
    from aqualora_torch.tools import golden_gate, run_parity

    root = spec["root"]
    out = {}
    for case, fn in (("gate", golden_gate.main), ("parity", run_parity.main),
                     ("demo", run_demo.main)):
        where = os.path.join(root, case)
        out[case] = fn(spec[f"{case}_argv"] + [
            "--out" if case != "demo" else "--output_dir", where])
        sharding.barrier()
        out[f"{case}_files"] = written(where)

    refused = os.path.join(root, "refused")
    out["refusals"] = [
        _refusal(lambda: fn(argv + ["--out" if fn is not run_demo.main
                                    else "--output_dir", refused]))
        for fn, argv in ((golden_gate.main, spec["gate_refused_argv"]),
                         (run_parity.main, spec["parity_refused_argv"]),
                         (run_demo.main, spec["demo_refused_argv"]))]
    out["refused_files"] = sorted(written(refused)) if os.path.isdir(
        refused) else []

    mesh = sharding.make_mesh(1, 2)
    out["unet_int8"] = {mode: tp_int8_unet(spec, mode, mesh)
                        for mode in spec["int8_states"]}
    real = partition.row_absmax
    partition.row_absmax = lambda x, group: x.detach().abs().amax(
        dim=-1).float()
    try:
        out["unet_int8_local"] = tp_int8_unet(spec, "dense", mesh)
    finally:
        partition.row_absmax = real
    return out


def ranks_worker(rank: int, n: int, rendezvous: str, spec_path: str,
                 out_path: str) -> None:
    """A spawned rank of `run_cases` over gloo; rank 0 saves the results
    to `out_path`."""
    init_worker(rank, n, rendezvous, "cpu")
    try:
        result = run_cases(torch.load(spec_path, weights_only=False))
        if rank == 0:
            torch.save(result, out_path)
    finally:
        dist.destroy_process_group()
