"""Warm-up for production shapes, ported from ``bigkrls_tpu/warmup.py``.

The JAX package warms XLA's compile cache. Here the one-off costs of a
first fit are building the CUDA kernel library (``nvcc``, cached on disk
under ``ops/_build.BUILD_DIR`` and keyed by a hash of the sources), the
cuBLAS / cuSOLVER handles of the process and the kernels' tile plans.
``enable_compile_cache`` builds the library; ``warmup`` runs the real fit
twice on synthetic data of the production shape and reports the first
(cold) and the second (warm) time.

    python -m bigkrls_tpu_torch warmup --shapes 3106x67,50000x20

or::

    from bigkrls_tpu_torch.warmup import enable_compile_cache, warmup
    enable_compile_cache()          # builds the kernel library
    report = warmup(3106, 67)      # {"first_s": ..., "steady_s": ...,
                                    #  "compile_overhead_s": ...}
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Where the CUDA kernel library is built and cached: ``cache_dir``,
    else ``ops/_build.BUILD_DIR``. Builds the library now when a CUDA
    device is present; returns the directory."""
    from .ops import _build
    if cache_dir is not None:
        _build.BUILD_DIR = Path(cache_dir)
    if torch.cuda.is_available():
        _build.library()
    return str(_build.BUILD_DIR)


def warmup(n: int, p: int, *, binary_cols: int = 0, seed: int = 0,
           repeat: bool = True, noisy: bool = False, log=print,
           **fit_kwargs) -> dict:
    """Run the fit on synthetic data of shape (n, p) and report the
    wall-clock split between the first and a steady-state fit.

    ``fit_kwargs`` go to :func:`bigkrls_tpu_torch.fit` (``device``,
    ``dtype``, ``neig``, ``eigtrunc``, ``streaming``, ``derivative`` …);
    ``binary_cols`` makes the trailing columns binary so the
    first-difference path runs too. With ``repeat`` the fit runs twice and
    ``compile_overhead_s`` is the first time less the second; the phases of
    each are in ``first_timings`` / ``steady_timings``."""
    from .model import fit

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    for j in range(max(0, min(binary_cols, p))):
        X[:, p - 1 - j] = (X[:, p - 1 - j] > 0).astype(float)
    y = X @ rng.normal(size=p) + rng.normal(size=n)

    kwargs = dict(fit_kwargs)
    kwargs.setdefault("noisy", noisy)
    t0 = time.perf_counter()
    m1 = fit(y, X, **kwargs)
    first = time.perf_counter() - t0
    out = {"n": n, "p": p, "device": str(kwargs.get("device", "cuda")),
           "first_s": round(first, 3), "first_timings": m1.timings}
    if repeat:
        t0 = time.perf_counter()
        m2 = fit(y, X, **kwargs)
        steady = time.perf_counter() - t0
        out["steady_s"] = round(steady, 3)
        out["steady_timings"] = m2.timings
        out["compile_overhead_s"] = round(first - steady, 3)
    if noisy:
        log(f"warmup {n}x{p}: first={first:.2f}s"
            + (f" steady={out['steady_s']:.2f}s compile_overhead="
               f"{out['compile_overhead_s']:.2f}s" if repeat else ""))
    return out
