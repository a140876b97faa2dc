"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``quasinewtonmethods_jl_tpu_torch/csrc`` compile into one
shared library with a plain C interface, built for Hopper (``sm_90a``) at
first use into ``quasinewtonmethods_jl_tpu_torch/_build/`` (git-ignored).
Each source compiles to an object in its own nvcc process, all started
together, and one more nvcc links them. The file name carries a hash of
the sources, the shared headers and the flags, so an edited file builds
anew and an unchanged tree loads the earlier build. No PyTorch header is
compiled, which keeps a build to seconds.

`load_generated` builds the sources the port generates at run time (B3's
objectives from a trace, ops/kernels/objective_codegen.py) the same way:
one library per source, named by a hash of its text, the headers and the
flags, all missing ones compiled in parallel, cached on disk and in the
process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["KernelLibrary", "load_library", "load_generated", "check_launch", "BUILD_DIR",
           "SOURCES", "HEADERS"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("bfgs_update.cu", "bfgs_blocked.cu", "resident_solve.cu")
HEADERS = ("bfgs_common.cuh", "resident_linalg.cuh", "resident_objectives.cuh",
           "resident_solve.cuh")
# No --use_fast_math / -ftz: the kernels' NaN and inf semantics are part of
# their contract. -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# -fmad=false: these kernels are held to plain versions made of separate
# tensor ops, so each product and sum rounds on its own, as there.
SOURCE_FLAGS = {
    "bfgs_blocked.cu": ("-fmad=false",),
    "resident_solve.cu": ("-fmad=false",),
}


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


def _digest() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in (*SOURCES, *HEADERS):
        digest.update(name.encode())
        digest.update((CSRC_DIR / name).read_bytes())
    return digest.hexdigest()[:16]


def _compile(so: Path) -> str:
    """Compile every source in parallel, link them into ``so``; returns
    nvcc's output. Raises with nvcc's stderr when a step fails."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / f"{name}.o"
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c",
                   "-o", str(obj), str(CSRC_DIR / name)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objects.append(str(obj))
        logs, failed = [], []
        for name, proc in procs:  # wait for every compiler before raising
            out, err = proc.communicate()
            logs.append(f"== {name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name} with exit code {proc.returncode}:\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        part = Path(tmp) / so.name
        link = subprocess.run([nvcc, "-shared", "-o", str(part), *objects],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code {link.returncode}:\n{link.stderr}")
        os.replace(part, so)  # atomic: a concurrent build never sees half a file
    return "".join(logs)


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises with nvcc's
    stderr when the build fails."""
    so = BUILD_DIR / f"libqnm_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        log = _compile(so)
        seconds = time.perf_counter() - t0
    cdll = ctypes.CDLL(str(so))
    cdll.qnm_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.qnm_cuda_error_string.restype = ctypes.c_char_p
    return KernelLibrary(cdll, so, seconds, log)


# The generated sources' flags: those of resident_solve.cu, whose kernel
# they instantiate, and its headers.
GENERATED_FLAGS = (*NVCC_FLAGS, *SOURCE_FLAGS["resident_solve.cu"])
_GENERATED: dict = {}


@functools.lru_cache(maxsize=None)
def _header_bytes() -> tuple:
    """csrc's headers, read once per process (as the kernel library is
    loaded once)."""
    return tuple((name, (CSRC_DIR / name).read_bytes()) for name in HEADERS)


def _generated_digest(source: str) -> str:
    digest = hashlib.sha256(" ".join(GENERATED_FLAGS).encode())
    for name, text in _header_bytes():
        digest.update(name.encode())
        digest.update(text)
    digest.update(source.encode())
    return digest.hexdigest()[:16]


def load_generated(*sources: str) -> list:
    """Build (where needed) and load one library per generated CUDA
    ``source`` (a translation unit that includes csrc's headers and defines
    a plain C interface, with ``qnm_cuda_error_string`` among it); returns
    their `KernelLibrary`s in order. The missing ones compile in parallel,
    one nvcc each, into ``BUILD_DIR`` (the source beside its library).
    Raises RuntimeError with nvcc's stderr when a build fails."""
    keys = [_generated_digest(s) for s in sources]
    todo = {k: s for k, s in zip(keys, sources)
            if k not in _GENERATED and not (BUILD_DIR / f"libqnm_traced_{k}.so").exists()}
    logs, seconds = {}, {}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            procs = []
            for key, source in todo.items():
                cu = BUILD_DIR / f"traced_{key}.cu"
                if not cu.exists():
                    part = Path(tmp) / cu.name
                    part.write_text(source)
                    os.replace(part, cu)
                lib = Path(tmp) / f"libqnm_traced_{key}.so"
                cmd = [nvcc, *GENERATED_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(lib),
                       str(cu)]
                procs.append((key, lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            failed = []
            for key, lib, proc in procs:  # wait for every compiler before raising
                out, err = proc.communicate()
                logs[key] = f"== traced_{key}.cu\n{out}{err}"
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on traced_{key}.cu with exit code "
                                  f"{proc.returncode}:\n{err}")
                else:
                    os.replace(lib, BUILD_DIR / lib.name)
            if failed:
                raise RuntimeError("\n".join(failed))
        elapsed = time.perf_counter() - t0
        seconds = dict.fromkeys(todo, elapsed)
    out = []
    for key in keys:
        if key not in _GENERATED:
            so = BUILD_DIR / f"libqnm_traced_{key}.so"
            cdll = ctypes.CDLL(str(so))
            cdll.qnm_cuda_error_string.argtypes = [ctypes.c_int]
            cdll.qnm_cuda_error_string.restype = ctypes.c_char_p
            _GENERATED[key] = KernelLibrary(cdll, so, seconds.get(key, 0.0), logs.get(key, ""))
        out.append(_GENERATED[key])
    return out


def check_launch(err: int, kernel: str, lib: ctypes.CDLL = None) -> None:
    """Raise RuntimeError when a launcher returned a CUDA error (its
    ``cudaGetLastError()`` after the launch; 0 means launched); ``lib``:
    the library whose ``qnm_cuda_error_string`` names it (the kernel
    library's by default)."""
    if err != 0:
        lib = lib if lib is not None else load_library().cdll
        message = lib.qnm_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {message}")
