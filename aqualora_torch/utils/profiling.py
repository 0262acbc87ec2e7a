"""Tracing and step timing (the port of `aqualora_tpu/utils/profiling.py`).

Usage:
    with trace("/tmp/trace"):          # Chrome-trace JSON of host + device
        step(...)

    timer = StepTimer()
    for batch in data:
        with timer:
            out = timer.observe(step(batch))
        print(timer.summary())

`trace` is a `torch.profiler` session (the CUDA activity too when the host
has a card) whose events are written with `export_chrome_trace`: no
TensorBoard import.  `device_memory_stats` reads the CUDA caching
allocator's counters under JAX's names.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler session around a block; on exit the trace goes to
    `logdir/trace_<pid>_<ns>.json` (open it in Perfetto or
    chrome://tracing).  Yields the `torch.profiler.profile` object, whose
    `key_averages()` sums the events.  Events accumulate over the session
    (`acc_events`, where this torch has it) instead of being cleared at the
    end of each profiler cycle."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = ({"acc_events": True}
              if "acc_events" in inspect.signature(profile).parameters
              else {})
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, **kwargs)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range inside a trace (a `record_function` event; on a host
    with a CUDA card also an NVTX range)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in `result` (nested lists, tuples
    and dicts)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*map(_cuda_devices, result))
    return set()


class StepTimer:
    """Wall-clock step timing with percentile summary; waits for the
    device of the observed result."""

    def __init__(self, warmup: int = 1):
        self.times = []
        self.warmup = warmup
        self._t0: Optional[float] = None
        self._result = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def observe(self, result):
        """Register the step output so exit can wait for its device(s)."""
        self._result = result
        return result

    def __exit__(self, *exc):
        if self._result is not None:
            for device in _cuda_devices(self._result):
                torch.cuda.synchronize(device)
            self._result = None
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def steady(self):
        return self.times[self.warmup:] if len(self.times) > self.warmup \
            else self.times

    def summary(self) -> str:
        t = np.asarray(self.steady)
        if not len(t):
            return "no steps"
        return (f"steps={len(t)} mean={t.mean()*1e3:.1f}ms "
                f"p50={np.percentile(t,50)*1e3:.1f}ms "
                f"p95={np.percentile(t,95)*1e3:.1f}ms")


def device_memory_stats(device: str | torch.device = "cuda") -> dict:
    """Device memory in use and its peak, by device, under JAX's keys
    (`bytes_in_use`, `peak_bytes_in_use`): one entry per visible CUDA
    device, from the caching allocator's counters (`torch.cuda.
    memory_stats`; a device it has not used yet has none, so None).  The
    CPU has no such counters: one entry, None, as for a JAX CPU device.
    Asking for CUDA on a host without a card raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return {"cpu": None}
    if kind != "cuda":
        raise ValueError(f"no memory statistics for {kind} devices")
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats('cuda'): this host has no "
                           "CUDA device")
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak")}
    return out
