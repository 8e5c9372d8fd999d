"""Build and load the package's CUDA kernels.

The sources under ``bigkrls_tpu_torch/csrc/*.cu`` (and the headers
``*.cuh`` they share) expose a plain C interface. Each is compiled by its
own ``nvcc`` for ``sm_90a``, all started together, and the objects are
linked into one shared library under ``bigkrls_tpu_torch/_build/``, which
is loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library is built at first use and keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused. A
failed build raises with ``nvcc``'s own error output.
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

from ..utils import progress

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for s in [*srcs, *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; return their combined output or
    raise with the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the sources if no library for their hash exists; return
    the library's path. Each source is compiled by its own ``nvcc``, all
    started together, and the objects are linked into one library."""
    global last_build_seconds, last_build_log
    srcs = _sources()
    lib = BUILD_DIR / f"libbigkrls_kernels_{_digest(srcs)}.so"
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = log
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every C function's signature set.
    Loading it is a ``library`` span (host time) with the counter
    ``built``: 1 where ``nvcc`` ran, 0 where the library was on disk."""
    with progress.span("library", device=None) as s:
        lib = ctypes.CDLL(str(build()))
        s.count("built", int(last_build_seconds > 0))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gauss_tile_f32.argtypes = [p, p, i64, i64, i64, p, ctypes.c_float,
                                   p, *[ctypes.c_int] * 4, p]
    lib.gauss_tile_f32.restype = ctypes.c_int
    lib.kernel_matmul_f32.argtypes = [p, p, i64, p, p, p, i64, i64, i64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_int, ctypes.c_int, p]
    lib.kernel_matmul_f32.restype = ctypes.c_int
    lib.kernel_matmul_cross_f32.argtypes = [p, i64, p, i64, p, i64, p, p, p,
                                            i64, i64, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int, p]
    lib.kernel_matmul_cross_f32.restype = ctypes.c_int
    return lib
