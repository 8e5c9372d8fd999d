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

The golden-section λ search over that loss runs as the JAX package's
device loops do (:func:`golden_search_device`, in the fit's dtype, one
host read per chunk of steps), or as its host loop
(:func:`golden_section`, python floats, one read per step).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.sharded import (ShardedTensor, gram, mesh_of, place,
                                replicate, rows_map, rows_reduce)
from ..types import Eigensystem
from ..utils.progress import count

GOLD = 0.381966          # R's golden-section constant (bLambdaSearch)
GOLDEN_MAX_ITERS = 10_000
# golden-section steps the device loop runs between two host reads of its
# stopping flag; a step after the stop changes no bit of the state, so the
# result does not depend on it
GOLDEN_CHUNK = 8


def golden_section(loo: Callable[[float], float], L: float, U: float,
                   tol: float,
                   log: Optional[Callable[[str], None]] = None):
    """The reference's golden-section loop (``bLambdaSearch``,
    ``R/bigKRLS_Rcpp_functions.R:38-77``) on the host, in python floats:
    R's 0.381966, the ``|S1−S2| > tol`` test, at most 10 000 iterations,
    and the final ``X1 if S1 < S2 else X2``. ``loo(λ)`` returns the LOO
    loss as a python float — on a GPU that is one scalar read per
    iteration. ``log`` receives the reference-formatted bracket after
    every step. Returns ``(λ*, iterations)``. This is the JAX package's
    ``lambda_search(device_loop=False)`` and noisy loop; the solves run
    :func:`golden_search_device`."""
    def show():
        if log is not None:
            log(_bracket_line(L, U, X1, X2, S1, S2))

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


def _bracket_line(L, U, X1, X2, S1, S2) -> str:
    return (f"L: {L:.3f} X1: {X1:.3f} X2: {X2:.3f} U: {U:.3f} "
            f"S1: {S1:.3f} S2: {S2:.3f}")


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


def loo_solver(vectors, values, Qty, Q2, mask=None):
    """λ ↦ (LOO loss, coefficients) on one basis, the expressions of the
    JAX loops' ``loo_c``: ``mask`` (0/1 per eigenpair) zeroes the filter
    at k ≥ lastkeeper, the JAX programs' truncation without dynamic
    shapes. The loss of a row-sharded Q is one partial per shard, summed
    in shard order."""
    def loo_c(lam):
        filt = 1.0 / (values + lam) if mask is None else \
            mask / (values + lam)
        coeffs = rows_map(lambda q, f: q @ f, vectors, Qty * filt)
        loo = rows_reduce(lambda c, q2, f: torch.sum((c / (q2 @ f)) ** 2),
                          coeffs, Q2, filt)
        return loo, coeffs
    return loo_c


def _scalar(x, dt, dev):
    """``x`` as a 0-d tensor of ``dt`` on ``dev``; a python number by a
    fill, which needs no host-to-device copy (and no synchronisation)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dt)
    return torch.full((), float(x), dtype=dt, device=dev)


def _running(v, it, tol):
    """The JAX loops' ``cond``: |S1−S2| > tol ∧ it < 10 000."""
    return ((v[4] - v[5]).abs() > tol) & (it < GOLDEN_MAX_ITERS)


# a step's gathers, as positions in (L, U, X1, X2, S1, S2, λ, S): the
# far ends (X2, X1) of the two candidate points; the state after JAX's
# left branch (S1 < S2: L, X2, λ, X1, S, S1) and after its right (X1, U,
# X2, λ, S2, S); the state kept once the loop stops
_STEP_INDEX = torch.tensor([3, 2, 0, 3, 6, 2, 7, 4, 2, 1, 3, 6, 5, 7,
                            0, 1, 2, 3, 4, 5])


def _step_index(dev):
    """``_STEP_INDEX`` on ``dev`` as (ends, left, right, kept): one copy
    that the host does not wait for."""
    idx = _STEP_INDEX.to(dev, non_blocking=True)
    return idx[:2], idx[2:8], idx[8:14], idx[14:]


def golden_chunk(state, loo, gold, tol, index, brackets=None):
    """``GOLDEN_CHUNK`` golden-section steps on the device, with no host
    read. ``state = (v, it, running)``: ``v`` holds (L, U, X1, X2, S1,
    S2) in the fit's dtype, ``it`` int32, ``running`` the JAX ``cond``;
    ``index`` is :func:`_step_index`'s. One step is the JAX ``cond(S1 <
    S2, left, right)`` without a branch: both candidate points at once,
    (L, U) + g·((X2, X1) − (L, U)), which is JAX's L + g·(X2 − L) and,
    with both signs flipped (exact in IEEE arithmetic), its U − g·(U −
    X1); one LOO evaluation at the one taken; the next state gathered
    from the old, λ and its loss, and kept once the loop stops.
    ``brackets`` (a list) receives ``v`` after every step."""
    v, it, running = state
    ends, left, right, kept = index
    for _ in range(GOLDEN_CHUNK):
        go = v[4] < v[5]
        near = v[:2]
        cand = near + gold * (v.index_select(0, ends) - near)
        lam = torch.where(go, cand[0], cand[1])
        S = loo(lam)[0]
        ext = torch.cat((v, lam.view(1), S.view(1)))
        v = ext.index_select(0, torch.where(
            running, torch.where(go, left, right), kept))
        it = it + running
        running = _running(v, it, tol)
        if brackets is not None:
            brackets.append(v)
    return v, it, running


def golden_search_device(vectors, values, Qty, Q2, L, U, tol, mask=None,
                         log: Optional[Callable[[str], None]] = None,
                         progress: Optional[Callable[[int], None]] = None):
    """The JAX package's golden-section ``while_loop``
    (``lambda_search._golden_search_device``, and the loops of
    ``ops/adaptive._golden_solve``, ``_adaptive_fused`` and
    ``ops/fused.postkernel_device``) in the fit's dtype on the fit's
    device: chunks of :func:`golden_chunk` with one host read of the
    iteration count and the stopping flag after each, so the result
    equals the JAX loop's whatever ``GOLDEN_CHUNK`` is. ``L``, ``U``,
    ``tol``: device scalars or python numbers, taken in ``values``'
    dtype. ``log`` receives the reference-formatted brackets (read with
    the chunk's flag); ``progress(iterations)`` is called after every
    chunk. Returns ``(λ*, iterations, chunks)``, λ* a 0-d tensor of the
    fit's dtype; across processes, process 0's."""
    dt, dev = values.dtype, values.device
    L, U, tol = (_scalar(x, dt, dev) for x in (L, U, tol))
    gold = _scalar(GOLD, dt, dev)
    loo = loo_solver(vectors, values, Qty, Q2, mask)
    X1 = L + gold * (U - L)
    X2 = U - gold * (U - L)
    v = torch.stack([L, U, X1, X2, loo(X1)[0], loo(X2)[0]])
    it = torch.zeros((), dtype=torch.int32, device=dev)
    state = (v, it, _running(v, it, tol))
    index = _step_index(dev)
    brackets = [v] if log is not None else None
    iters = chunks = 0
    while True:
        state = golden_chunk(state, loo, gold, tol, index, brackets)
        v, it, running = state
        head = torch.stack([it.to(dt), running.to(dt)])
        if brackets is not None:
            head = torch.cat([head, torch.stack(brackets).reshape(-1)])
        count("host_reads")
        read = head.tolist()
        chunks += 1
        last, iters, stop = iters, int(read[0]), read[1] == 0.0
        if brackets is not None:
            # the first chunk's list starts with the initial bracket
            shown = iters - last + (chunks == 1)
            for i in range(shown):
                log(_bracket_line(*read[2 + 6 * i:8 + 6 * i]))
            brackets = []
        if progress is not None:
            progress(iters)
        if stop:
            break
    (lam,) = replicate(mesh_of(vectors), torch.where(v[4] < v[5], v[2],
                                                     v[3]))
    return lam, iters, chunks


def golden_solve(vectors, values, y_std, L, U, tol, mask=None,
                 log: Optional[Callable[[str], None]] = None,
                 progress: Optional[Callable[[int], None]] = None):
    """Golden-section λ search + the final spectral solve on one basis,
    on the device: the port of ``ops/adaptive._golden_solve`` and of the
    search and solve inside ``ops/fused.postkernel_device`` and
    ``_adaptive_fused`` (:func:`golden_search_device`; ``mask`` as in
    :func:`loo_solver`). Returns ``(lam, Le, coeffs, iters)`` with
    ``lam`` and ``Le`` 0-d tensors of the fit's dtype and ``coeffs`` on
    the device (row-sharded like a row-sharded Q): the coefficients are
    solved at the very λ* reported."""
    Qty, Q2 = solve_precompute(vectors, y_std)
    lam, it, _ = golden_search_device(vectors, values, Qty, Q2, L, U, tol,
                                      mask=mask, log=log, progress=progress)
    Le, coeffs = loo_solver(vectors, values, Qty, Q2, mask)(lam)
    return lam, Le, coeffs, it


def solve_for_c(eig: Eigensystem, y_std, lambda_):
    """Single-λ solve: (Le, coeffs), like ``bSolveForc``."""
    Qty, Q2 = solve_precompute(eig.vectors, y_std)
    coeffs, _, loo = spectral_solve_batch(eig.vectors, eig.values, Qty, Q2,
                                          [float(lambda_)])
    return loo[0], rows_map(lambda c: c[:, 0], coeffs)
