#!/usr/bin/env python3
"""Time two versions of the port's JPEG decoder on one host, in turns.

    python3 scripts/torch_jpeg_decode_ab.py PARENT.cpp CHANGE.cpp [FOLDER]

builds each `jpeg_decode.cpp` with the flags `aqualora_torch/ops/_build.py`
gives host code (g++ -O3, no FMA contraction) into a temporary directory,
and times each library's `decode_batch` (decode and the float32 resize to
512^2) on the JPEG files directly under FOLDER (default: the realistic
fixtures, tests/torch_port_images/realistic), 8 copies of each file, on
one thread and on the host's, in the order PARENT, CHANGE, CHANGE, PARENT,
three rounds.  It prints one JSON line: each version's images/s per
thread count (the median of its 6 runs, and every run), the files, and the
host's CPU count.  A file either version refuses is left out and named;
the two versions' outputs on the rest are compared bit for bit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

RES = 512
COPIES = 8
ROUNDS = 3


def build(source: str, out: str) -> ctypes.CDLL:
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    "-pthread", "-ffp-contract=off", "-o", out, source],
                   check=True)
    lib = ctypes.CDLL(out)
    lib.decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int]
    lib.decode_batch.restype = ctypes.c_int
    return lib


def run(lib: ctypes.CDLL, paths: list, threads: int) -> tuple:
    """-> (seconds, the batch) of one decode_batch call."""
    names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    out = np.empty((len(paths), RES, RES, 3), np.float32)
    status = np.zeros(len(paths), np.int32)
    err = ctypes.create_string_buffer(512)
    t0 = time.perf_counter()
    fails = lib.decode_batch(names, len(paths), RES, out.ctypes.data,
                             threads, status.ctypes.data, err, 512)
    seconds = time.perf_counter() - t0
    if fails:
        raise RuntimeError(err.value.decode(errors="replace"))
    return seconds, out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = argv[2] if len(argv) > 2 else os.path.join(
        root, "tests", "torch_port_images", "realistic")
    files = sorted(f for f in os.listdir(folder) if f.endswith(".jpg"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"parent": build(argv[0], os.path.join(tmp, "parent.so")),
                "change": build(argv[1], os.path.join(tmp, "change.so"))}
        refused = []
        for f in list(files):
            for lib in libs.values():
                try:
                    run(lib, [os.path.join(folder, f)], 1)
                except RuntimeError:
                    refused.append(f)
                    files.remove(f)
                    break
        paths = []
        for i in range(COPIES):
            for f in files:
                paths.append(os.path.join(tmp, f"{i}_{f}"))
                shutil.copy(os.path.join(folder, f), paths[-1])
        first = {k: run(lib, paths[:len(files)], 0)[1]     # warm, and the
                 for k, lib in libs.items()}                # same bits
        same = bool(np.array_equal(first["parent"], first["change"]))
        runs = {(k, t): [] for k in libs for t in (1, 0)}
        for _ in range(ROUNDS):
            for k in ("parent", "change", "change", "parent"):
                for t in (1, 0):
                    runs[k, t].append(len(paths) / run(libs[k], paths, t)[0])
    res = {"images": len(paths), "files": files, "refused": refused,
           "same_bits": same,
           "cpus": os.cpu_count(), "usable": len(os.sched_getaffinity(0))}
    for (k, t), rates in runs.items():
        key = f"{k}_{'one_thread' if t == 1 else 'host_threads'}"
        res[key] = statistics.median(rates)
        res[key + "_runs"] = [round(r, 2) for r in rates]
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
