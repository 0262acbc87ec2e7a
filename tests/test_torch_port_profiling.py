"""The port's profiling module (`aqualora_torch/utils/profiling.py`) against
the JAX package's (`aqualora_tpu/utils/profiling.py`): StepTimer's summary
letter for letter, a CPU trace written as Chrome-trace JSON with its
`annotate` range, the memory statistics' keys.  JAX is imported inside the
tests that compare with it, so the `cuda` case runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_profiling.py
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aqualora_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = [0.5, 0.0123, 0.0456, 0.0789, 0.1011, 0.0042]


@pytest.mark.parametrize("warmup", [0, 1, 3, 10])
def test_step_timer_summary_equals_jax(warmup):
    from aqualora_tpu.utils import profiling as jprof

    ours, theirs = profiling.StepTimer(warmup), jprof.StepTimer(warmup)
    ours.times, theirs.times = list(TIMES), list(TIMES)
    assert ours.summary() == theirs.summary()
    assert ours.steady == theirs.steady
    empty = profiling.StepTimer(), jprof.StepTimer()
    assert empty[0].summary() == empty[1].summary() == "no steps"


def test_step_timer_times_steps_on_cpu():
    t = profiling.StepTimer(warmup=1)
    for _ in range(3):
        with t:
            t.observe({"out": [torch.ones(8, 8) * 2]})
    s = t.summary()
    assert "steps=2" in s and "p50=" in s and len(t.times) == 3


def test_cpu_trace_holds_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("test-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    region = [e for e in events if e.get("name") == "test-region"]
    assert region and region[0]["dur"] > 0
    assert any(e.key == "test-region" for e in prof.key_averages())


def test_memory_stats_on_cpu_and_refused_cuda():
    from aqualora_tpu.utils import profiling as jprof

    assert profiling.device_memory_stats("cpu") == {"cpu": None}
    # a JAX CPU device has no statistics either
    assert all(v is None for v in jprof.device_memory_stats().values())
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_stats()


# On the card, in a process of its own: a short profiler session after
# another session in the same process has recorded no device events
# (PERF.md section 7), and the card tests open several before this one.
TRACE_ON_CUDA = """
import glob, json, sys, torch
from aqualora_torch.ops import flash_attention as fa
from aqualora_torch.utils import profiling
q = torch.randn(2, 8, 1024, 80, device="cuda", dtype=torch.bfloat16)
with profiling.trace(sys.argv[1]):
    with profiling.annotate("flash"):
        fa.flash_attention_fwd(q, q, q, 80 ** -0.5)
    torch.cuda.synchronize()
events = json.load(open(glob.glob(sys.argv[1] + "/*.json")[0]))["traceEvents"]
print(json.dumps([e["name"] for e in events
                  if e.get("cat") == "kernel" or e.get("name") == "flash"]))
"""


@pytest.mark.cuda
def test_trace_and_memory_stats_on_cuda(tmp_path):
    """On the card: a trace holds the flash forward kernel's device events
    and the annotated range, the timer waits for the device, and the
    memory statistics count a tensor's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from aqualora_torch.ops import flash_attention as fa

    proc = subprocess.run([sys.executable, "-c", TRACE_ON_CUDA,
                           str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "flash" in names
    assert any("flash_fwd" in n for n in names), names[:10]
    q = torch.randn(2, 8, 1024, 80, device="cuda", dtype=torch.bfloat16)
    timer = profiling.StepTimer(warmup=0)
    with timer:
        timer.observe(fa.flash_attention_fwd(q, q, q, 80 ** -0.5))
    stats = profiling.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    now = stats[f"cuda:{torch.cuda.current_device()}"]
    assert now["peak_bytes_in_use"] >= now["bytes_in_use"] >= q.nbytes
    assert np.isfinite(timer.times[0])
