"""Golden-section search for the ridge penalty λ over exact LOO error.

Port of ``bigkrls_tpu/lambda_search.py``. The bound heuristics are the
reference's ``bLambdaSearch`` (``R/bigKRLS_Rcpp_functions.R:5-82``), run
in host numpy as exact integer bisections over its unit-step loops:

* ``tol`` defaults to ``1e-3 · N``;
* upper bound: the largest U in {N, N−1, …} with Σ λₖ/(λₖ+U) ≥ 1;
* lower bound: L = eps + 0.05k, the smallest k with Σ λₖ/(λₖ+L) ≤ q,
  q = 1-based argmin |λₖ − λ₁/1000|.

Both consume the FULL eigenvalue list; the LOO evaluations use the
truncated system. The search runs as the JAX package runs it: on the
device in the fit's dtype (``ops.solve.golden_search_device``, one host
read per chunk of steps), or, with ``device_loop=False`` or ``noisy``, as
the host loop in python floats (``ops.solve.golden_section``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .ops.solve import (golden_search_device, golden_section,
                        golden_solve, loo_solver, solve_precompute)
from .types import Eigensystem
from .utils import progress

_EPS = 2.220446049250313e-16  # R's .Machine$double.eps


def _sum_filter(values: np.ndarray, lam: float) -> float:
    return float(np.sum(values / (values + lam)))


def _upper_bound(values: np.ndarray, n: int) -> float:
    """Largest U in {n, n-1, ...} with Σ λₖ/(λₖ+U) ≥ 1 (reference :19-21),
    by bisection over the monotone step count."""
    def cond(k: int) -> bool:
        return _sum_filter(values, float(n - k)) >= 1.0

    if cond(0):
        return float(n)
    lo, hi = 1, 1
    while hi < n and not cond(hi):
        lo = hi + 1
        hi = min(2 * hi, n)
    while lo < hi:
        mid = (lo + hi) // 2
        if cond(mid):
            hi = mid
        else:
            lo = mid + 1
    return float(n - lo)


def _lower_bound(values: np.ndarray) -> float:
    """Reference :26-34: L = eps + 0.05·k, smallest k with
    Σ λₖ/(λₖ+L) ≤ q, q = 1-based argmin |λₖ − λ₁/1000|."""
    q = int(np.argmin(np.abs(values - values.max() / 1000.0))) + 1
    if _sum_filter(values, _EPS) <= q:
        return _EPS
    hi = 1
    while _sum_filter(values, _EPS + 0.05 * hi) > q:
        hi *= 2
    lo = max(1, hi // 2)
    while lo < hi:
        mid = (lo + hi) // 2
        if _sum_filter(values, _EPS + 0.05 * mid) <= q:
            hi = mid
        else:
            lo = mid + 1
    return _EPS + 0.05 * lo


def _resolve_bounds(eig: Eigensystem, n: int, L, U, tol):
    """Default the bounds (over the FULL value list) and the tolerance;
    returns ``(L, U, tol)`` as floats."""
    progress.count("host_reads")
    values_full = eig.values_full.detach().cpu().double().numpy()
    if tol is None:
        tol = 1e-3 * n
    if U is None:
        U = _upper_bound(values_full, n)
    if L is None:
        L = _lower_bound(values_full)
    return float(L), float(U), float(tol)


def lambda_search_solve(eig: Eigensystem, y_std, L: Optional[float] = None,
                        U: Optional[float] = None,
                        tol: Optional[float] = None):
    """Bounds + golden search + the final spectral solve, on the device
    like the JAX package's ``ops/adaptive._golden_solve``; returns ``(lam,
    Le, coeffs)`` with ``Le``/``coeffs`` on the device and ``lam`` the
    number the coefficients were solved at (a float32 number in float32).
    """
    L, U, tol = _resolve_bounds(eig, int(y_std.shape[0]), L, U, tol)
    lam, Le, coeffs, _ = golden_solve(eig.vectors, eig.values, y_std, L, U,
                                      tol)
    progress.count("host_reads")
    return float(lam), Le, coeffs


def lambda_search(eig: Eigensystem, y_std, L: Optional[float] = None,
                  U: Optional[float] = None, tol: Optional[float] = None,
                  noisy: bool = False, device_loop: bool = True,
                  log: Callable[[str], None] = print) -> float:
    """Golden-section search; returns λ*. Matches ``bLambdaSearch(L, U,
    y, Eigenobject, tol, noisy)``; ``noisy`` logs every bracket in the
    reference's format.

    As in the JAX package, ``device_loop`` without ``noisy`` runs the
    search on the device in the fit's dtype
    (``ops/solve.golden_search_device``); ``device_loop=False`` or
    ``noisy`` run the host loop in python floats, one LOO read per step
    (``ops/solve.golden_section``)."""
    L, U, tol = _resolve_bounds(eig, int(y_std.shape[0]), L, U, tol)
    Qty, Q2 = solve_precompute(eig.vectors, y_std)
    if device_loop and not noisy:
        lam, _, _ = golden_search_device(eig.vectors, eig.values, Qty, Q2,
                                         L, U, tol)
        return float(lam)
    loo = loo_solver(eig.vectors, eig.values, Qty, Q2)
    lam, _ = golden_section(lambda x: float(loo(x)[0]), L, U, tol,
                            log=log if noisy else None)
    if noisy:
        log(f"lambda = {lam:.5f}")
    return float(lam)
