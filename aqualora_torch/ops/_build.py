"""Build the `csrc/*.cu` and `csrc/*.cpp` sources and load them with ctypes.

Every hand-written kernel of the port has a plain C interface and is built
the same way: `nvcc -gencode arch=compute_90a,code=sm_90a -shared` into
`aqualora_torch/_build/lib<name>_<hash>.so`, where the hash is of the
source's content and of the csrc headers it includes (`#include "x.cuh"`),
so an edited source or header is rebuilt and an unchanged one is loaded as
it is.  Host code (`csrc/<name>.cpp`, the JPEG decoder) takes the same
route with `g++ -O3 -shared -fPIC -std=c++17 -pthread` and no flag that
lets the compiler change float results (no -ffast-math, no -march, FMA
contraction off), so it gives the same bits on every x86-64 or ARM host.
A library is built on first use, never at import; `build_all` starts one
compiler per source at once.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_loaded: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts one kernel's launches: `count` in all, `by_shape[key]` per
    shape.  Only the wrapper's launch site adds to it."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.by_shape: collections.Counter = collections.Counter()

    def add(self, *shape: int) -> None:
        self.count += 1
        self.by_shape[shape] += 1


def nvcc() -> str:
    """nvcc on PATH, else under the toolkit PyTorch finds (CUDA_HOME)."""
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels are built from "
                           "aqualora_torch/csrc with the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source(name: str) -> Path:
    """csrc/<name>.cu, else csrc/<name>.cpp (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def compile_command(name: str, output: str) -> List[str]:
    """nvcc for a .cu source, g++ for a .cpp one."""
    src = source(name)
    if src.suffix == ".cpp":
        return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                "-ffp-contract=off", "-o", output, str(src)]
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", output, str(src)]


def source_files(name: str) -> List[Path]:
    """csrc/<name>.cu (or .cpp) and every csrc header it includes with
    quotes, directly or through another header, each once."""
    files, todo = [], [source(name)]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc for inc in
                 _LOCAL_INCLUDE.findall(path.read_text())]
    return files


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu (or .cpp) is built: named by the content hash
    of the source and of the csrc headers it includes."""
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str], verbose: bool = False
              ) -> Dict[str, float]:
    """Compile every csrc source of `names` not built yet, one compiler
    each, all started together, and load them.  Returns each build's
    seconds from the common start to its end (0.0 for a library already
    built).  With `verbose`, ptxas's register and spill report is
    printed."""
    names = [n for n in names if n not in _loaded]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = tempfile.TemporaryFile(mode="w+")
        cmd = compile_command(name, tmp)
        running[name] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT),
                         log, tmp, so)
    failed = []
    while running:
        for name in list(running):
            proc, log, tmp, so = running[name]
            if proc.poll() is None:
                continue
            del running[name]
            seconds[name] = time.perf_counter() - t0
            log.seek(0)
            out = log.read()
            log.close()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{proc.args[0]} failed on {source(name).name} "
                              f"({proc.returncode}):\n{out}")
                continue
            if verbose:
                print(out, end="")
            os.replace(tmp, so)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return seconds


def build(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (or .cpp), built first if need
    be."""
    if name not in _loaded:
        build_all([name])
    return _loaded[name]


def bind(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `symbol` with its argument types; it returns the
    cudaError_t of its launch as an int."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise if a launch's cudaError_t is not cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")
