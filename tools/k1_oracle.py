"""Build and call the frozen first design of the Gaussian tile kernel.

``tools/gauss_kernel_first.cu`` is the kernel ``bigkrls_tpu_torch`` shipped
before its redesign, kept unchanged as a test oracle: the redesigned kernel
must reproduce it bit for bit, and the two are timed side by side. This
module compiles it with the package's ``nvcc`` and flags into the package's
(ignored) build directory and binds it with ``ctypes``. ``chip_smoke.py``
and ``tools/time_gauss_tile.py`` use it; nothing in the package does.

    build = start_build()        # nvcc runs beside whatever comes next
    old = load(build)            # old(A, B, sigma, symmetric_diag) -> K
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bigkrls_tpu_torch.ops import _build  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "gauss_kernel_first.cu"


def start_build():
    """Start ``nvcc`` on the frozen source; returns (process, library path)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"libgauss_kernel_first.{os.getpid()}.so"
    cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-I", str(_build.SRC_DIR),
           "-shared", "-o", str(lib), str(SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load(build):
    """Wait for the build and return ``old(A, B, sigma, symmetric_diag)``,
    the frozen kernel with ``gauss_tile``'s calling convention (f32
    contiguous CUDA tensors; no checks: callers pass what ``gauss_tile``
    took)."""
    proc, path = build
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{out}")
    lib = ctypes.CDLL(str(path))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gauss_tile_first_f32.argtypes = [p, p, p, p, i64, i64, i64,
                                         ctypes.c_float, p, ctypes.c_int, p]
    lib.gauss_tile_first_f32.restype = ctypes.c_int

    def old(A, B, sigma, symmetric_diag):
        m, pp = A.shape
        n = B.shape[0]
        K = torch.empty((m, n), dtype=torch.float32, device=A.device)
        same = A.data_ptr() == B.data_ptr() and m == n
        ra = torch.empty((m,), dtype=torch.float32, device=A.device)
        rb = ra if same else torch.empty((n,), dtype=torch.float32,
                                         device=A.device)
        with torch.cuda.device(A.device):
            err = lib.gauss_tile_first_f32(
                A.data_ptr(), B.data_ptr(), ra.data_ptr(), rb.data_ptr(), m,
                n, pp, float(sigma), K.data_ptr(), int(bool(symmetric_diag)),
                torch.cuda.current_stream(A.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"frozen gauss_tile: CUDA error {err}")
        return K

    return old
