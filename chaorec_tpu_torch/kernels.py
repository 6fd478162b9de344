"""Build and load the port's CUDA C++ kernels (nvcc by hand, bound with ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` next to this file, at first use, for Hopper
(``sm_90a``). The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. The library is written to a
temporary name and renamed into place, so processes that build at once do
not read a half-written file.

Nothing here runs at import: the machine without a card has no ``nvcc``.
A failed build raises ``KernelBuildError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    pass


@dataclass(frozen=True)
class Built:
    """One kernel library: where it is, and what its build cost and said."""

    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build of the same source was found
    log: str  # nvcc's output, including ptxas's register and spill counts


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(f"nvcc not found on PATH or under {cuda_home}/bin")


@functools.cache
def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return Built(name, lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"{' '.join(cmd)} failed:\n{log}")
    os.replace(tmp, lib)
    return Built(name, lib, seconds, log)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name).path))


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA card ``index``: the kernels size their grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count
