"""Build and load the package's CUDA kernels.

The sources under ``bigkrls_tpu_torch/csrc/*.cu`` expose a plain C
interface; they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``bigkrls_tpu_torch/_build/`` and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The library is built at first
use and keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. A failed build raises with
``nvcc``'s own error output.
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

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# seconds the last build took (0.0 when the library was already built)
last_build_seconds = 0.0
# ptxas register / shared-memory report of the last build
last_build_log = ""


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                       "build the bigkrls_tpu_torch CUDA kernels")


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if no library for their hash exists; return
    the library's path."""
    global last_build_seconds, last_build_log
    srcs = _sources()
    lib = BUILD_DIR / f"libbigkrls_kernels_{_digest(srcs)}.so"
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    last_build_seconds = time.perf_counter() - t0
    last_build_log = proc.stdout + proc.stderr
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every C function's signature set."""
    lib = ctypes.CDLL(str(build()))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gauss_tile_f32.argtypes = [p, p, p, p, i64, i64, i64, ctypes.c_float,
                                   p, ctypes.c_int, p]
    lib.gauss_tile_f32.restype = ctypes.c_int
    return lib
