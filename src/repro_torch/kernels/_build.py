"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles at first use, with ``nvcc`` for ``sm_90a``, into a
shared library with a plain C interface under ``build/repro_torch/`` at
the repository root, named by a hash of the source and the flags (a
changed source builds anew). The library is loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, and each C entry point
returns ``cudaGetLastError()`` after its launch. ``build_all`` starts
one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

from repro_torch import compat

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(_I)
_FP = ctypes.POINTER(ctypes.c_float)
# name -> (source file, C signature of the entry point of the same name):
# the grid, source and output pointers, the int geometry, the tap offsets
# and weights, the stream.
KERNELS = {
    "stencil2d_revolving": (
        "stencil2d_revolving.cu",
        [_P, _P, _P] + [_I] * 10 + [_IP, _IP, _FP, _P]),
    "stencil3d_stream": (
        "stencil3d_stream.cu",
        [_P, _P, _P] + [_I] * 11 + [_IP, _IP, _IP, _FP, _P]),
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _library_path(name: str) -> pathlib.Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path] | None:
    """Start ``nvcc`` for ``name`` unless its library is built."""
    lib = _library_path(name)
    if lib.exists():
        return None
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on the card's host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path) -> str:
    log, _ = proc.communicate()
    lib = _library_path(name)
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel library that is missing, all ``nvcc`` runs in
    parallel. Returns each built kernel's compiler log (``-Xptxas -v``
    lists registers and shared memory)."""
    started = {name: job for name in KERNELS
               if (job := _start(name)) is not None}
    logs, errors = {}, []
    for name, job in started.items():     # wait for every nvcc first
        try:
            logs[name] = _finish(name, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name in _LOADED:
        return _LOADED[name]
    job = _start(name)
    if job is not None:
        _finish(name, *job)
    lib = ctypes.CDLL(str(_library_path(name)))
    fn = getattr(lib, name)
    fn.argtypes = KERNELS[name][1]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _LOADED[name] = lib
    return lib


def error_string(code: int) -> str:
    """``cudaGetErrorString`` for ``code``, through a loaded library."""
    for lib in _LOADED.values():
        return lib.repro_cuda_error_string(code).decode()
    return "unknown"
