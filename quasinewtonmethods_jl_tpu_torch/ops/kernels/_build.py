"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``quasinewtonmethods_jl_tpu_torch/csrc`` compile into one
shared library with a plain C interface, built for Hopper (``sm_90a``) at
first use into ``quasinewtonmethods_jl_tpu_torch/_build/`` (git-ignored).
The file name carries a hash of the sources and the flags, so an edited
source builds anew and an unchanged one loads the earlier build. No PyTorch
header is compiled, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["KernelLibrary", "load_library", "BUILD_DIR", "SOURCES"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("bfgs_update.cu",)
# No --use_fast_math / -ftz: the kernels' NaN and inf semantics are part of
# their contract. -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelLibrary(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was loaded
    log: str  # nvcc's output (ptxas resource usage); "" when loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises with nvcc's
    stderr when the build fails."""
    sources = [CSRC_DIR / name for name in SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libqnm_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        log = proc.stdout + proc.stderr
    return KernelLibrary(ctypes.CDLL(str(so)), so, seconds, log)
