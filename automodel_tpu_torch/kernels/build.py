"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each source compiles on its own (one nvcc process per file, all started together)
into a shared library with a plain C interface. Libraries land in
``automodel_tpu_torch/_build/``, named by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads at once. Nothing here runs at
import: the first call to :func:`library` builds, later calls reuse the handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["SOURCES", "build_all", "check", "library", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# source name -> {C function: argtypes}; every function returns a cudaError_t
SOURCES: dict[str, dict[str, list]] = {
    "flash_attention.cu": {
        "flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _F, _I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) of the last build
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(source: str) -> str:
    src = os.path.join(_PKG, "csrc", source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}-{digest}.so")


def build_all() -> float:
    """Compile every source that has no current library; returns the seconds taken."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for source in SOURCES:
        out = _lib_path(source)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_PKG, "csrc", source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for source, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[source] = log
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    path = _lib_path(source)
    if not os.path.exists(path):
        build_all()
    lib = ctypes.CDLL(path)
    for name, argtypes in SOURCES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIBS[source] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
