"""Spectral-filter solver: coefficients and leave-one-out loss.

Port of ``bigkrls_tpu/ops/solve.py``. For K = Q Λ Qᵀ (truncated) and a
batch of ridge penalties λ:

    c        = Q ((Qᵀy) / (Λ+λ))
    G⁻¹ᵢᵢ    = Σₖ Q²ᵢₖ / (λₖ+λ)
    Le       = Σᵢ (cᵢ/G⁻¹ᵢᵢ)²

with ``Qᵀy`` and ``Q∘Q`` precomputed once. Q may be row-sharded over a
mesh (``parallel/sharded.py``): Qᵀy is then reduced over its shards once,
G⁻¹ᵢᵢ and cᵢ stay on their shard, and each LOO loss is the sum of one
partial per shard, in a fixed order, so that every process of a mesh
that spans processes compares the same numbers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.sharded import (ShardedTensor, gram, mesh_of, place,
                                replicate, rows_map, rows_reduce)
from ..types import Eigensystem

GOLD = 0.381966          # R's golden-section constant (bLambdaSearch)
GOLDEN_MAX_ITERS = 10_000


def golden_section(loo: Callable[[float], float], L: float, U: float,
                   tol: float,
                   log: Optional[Callable[[str], None]] = None):
    """The reference's golden-section loop (``bLambdaSearch``,
    ``R/bigKRLS_Rcpp_functions.R:38-77``): R's 0.381966, the
    ``|S1−S2| > tol`` test, at most 10 000 iterations, and the final
    ``X1 if S1 < S2 else X2``. ``loo(λ)`` returns the LOO loss as a
    python float — on a GPU that is one scalar read per iteration.
    ``log`` receives the reference-formatted bracket after every step.
    Returns ``(λ*, iterations)``."""
    def show():
        if log is not None:
            log(f"L: {L:.3f} X1: {X1:.3f} X2: {X2:.3f} U: {U:.3f} "
                f"S1: {S1:.3f} S2: {S2:.3f}")

    X1 = L + GOLD * (U - L)
    X2 = U - GOLD * (U - L)
    S1, S2 = loo(X1), loo(X2)
    show()
    it = 0
    while abs(S1 - S2) > tol and it < GOLDEN_MAX_ITERS:
        if S1 < S2:
            U, X2 = X2, X1
            X1 = L + GOLD * (U - L)
            S2, S1 = S1, loo(X1)
        else:
            L, X1 = X1, X2
            X2 = U - GOLD * (U - L)
            S1, S2 = S2, loo(X2)
        it += 1
        show()
    return (X1 if S1 < S2 else X2), it


def _rows_like(vectors, y_std):
    """y laid out as the rows of a row-sharded Q (a tensor otherwise)."""
    if isinstance(vectors, ShardedTensor) and \
            not isinstance(y_std, ShardedTensor):
        return place(y_std, vectors.mesh, "row")
    return y_std


def solve_precompute(vectors, y_std):
    """The two reusable objects for batched λ solves: (Qᵀy, Q∘Q)."""
    return (gram(vectors, _rows_like(vectors, y_std)),
            rows_map(lambda q: q * q, vectors))


def spectral_solve_batch(vectors, values, Qty, Q2, lambdas):
    """Coefficients (N, B), Ĝ⁻¹ diagonals (N, B) and LOO losses (B,)."""
    lambdas = torch.atleast_1d(torch.as_tensor(lambdas, dtype=values.dtype,
                                               device=values.device))
    filt = 1.0 / (values[:, None] + lambdas[None, :])
    coeffs = rows_map(lambda q, f: q @ f, vectors, Qty[:, None] * filt)
    ginv_diag = rows_map(lambda q2, f: q2 @ f, Q2, filt)
    loo = rows_reduce(lambda c, g: torch.sum((c / g) ** 2, dim=0), coeffs,
                      ginv_diag)
    return coeffs, ginv_diag, loo


def loo_loss_batch(vectors, values, Qty, Q2, lambdas):
    """LOO error losses only (ref ``bLooLoss``)."""
    return spectral_solve_batch(vectors, values, Qty, Q2, lambdas)[2]


def golden_solve(vectors, values, y_std, L: float, U: float, tol: float,
                 mask=None, log: Optional[Callable[[str], None]] = None):
    """Golden-section λ search + the final spectral solve on one basis:
    the port of ``ops/adaptive._golden_solve`` and of the search loops
    inside ``ops/fused.postkernel_device`` and ``_adaptive_fused``.
    ``mask`` (0/1 per eigenpair) zeroes the filter at k ≥ lastkeeper, the
    JAX programs' truncation without dynamic shapes. Returns ``(lam, Le,
    coeffs, iters)`` with ``Le`` and ``coeffs`` on the device (``coeffs``
    row-sharded like a row-sharded Q). Across processes λ* is process 0's,
    broadcast."""
    Qty, Q2 = solve_precompute(vectors, y_std)

    def loo_c(lam):
        filt = 1.0 / (values + lam)
        if mask is not None:
            filt = mask * filt
        coeffs = rows_map(lambda q, f: q @ f, vectors, Qty * filt)
        loo = rows_reduce(lambda c, q2, f: torch.sum((c / (q2 @ f)) ** 2),
                          coeffs, Q2, filt)
        return loo, coeffs

    lam, it = golden_section(lambda x: float(loo_c(x)[0]), L, U, tol,
                             log=log)
    (lam_t,) = replicate(mesh_of(vectors),
                         torch.tensor([lam], dtype=torch.float64))
    Le, coeffs = loo_c(float(lam_t[0]))
    return float(lam_t[0]), Le, coeffs, it


def solve_for_c(eig: Eigensystem, y_std, lambda_):
    """Single-λ solve: (Le, coeffs), like ``bSolveForc``."""
    Qty, Q2 = solve_precompute(eig.vectors, y_std)
    coeffs, _, loo = spectral_solve_batch(eig.vectors, eig.values, Qty, Q2,
                                          [float(lambda_)])
    return loo[0], rows_map(lambda c: c[:, 0], coeffs)
