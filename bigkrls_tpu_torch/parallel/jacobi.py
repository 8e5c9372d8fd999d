"""Full-spectrum symmetric eigensolver by two-sided block Jacobi, ported
from ``bigkrls_tpu/parallel/jacobi.py`` (its docstring derives the
method).

A is split into nb×nb blocks of size b. A *round* pairs all nb blocks
disjointly (a tournament schedule covers every pair in nb−1 rounds, one
*sweep*); each pair's 2b×2b problem [[Aii, Aij], [Aji, Ajj]] is
diagonalized and its eigenvector matrix applied to block rows and columns
i and j. A round's rotations are block-diagonal under the pair
permutation, so they apply as batched stripe GEMMs, O(N²b) per round.
Sweeps repeat until off(A) ≤ tol·‖A‖_F. N that the blocking does not
divide is zero-padded; the pad's eigenpairs are exactly (0, eᵢ) and are
dropped by row support.

Under a mesh the JAX package's hybrid split applies: the pair problems of
a round are solved on the mesh's first shard as one batched
``torch.linalg.eigh`` (in float64, see ``PAIR_DTYPE``), and the stripe
GEMMs (the O(N²b) work) are split over the mesh's shards by pair, each
shard's share on its own device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sharded import Mesh, bounds, dense


# the dtype the 2b×2b pair problems are solved in, whatever A's: every
# round applies U as a similarity transform, so U's departure from
# orthogonality enters the eigenvalues once per round. On an H100 a
# batched float32 eigh of 256×256 problems returned max|UᵀU − I| = 1e-4
# and the eigenvalues of a 1024×1024 kernel drifted 1e-4 of λ₁ from
# eigh's; solved in float64 and rounded, 8e-7 (tools/time_jacobi.py).
# None solves them in A's dtype.
PAIR_DTYPE = torch.float64


def round_robin_schedule(nb: int) -> np.ndarray:
    """Tournament schedule: (nb−1) rounds × (nb/2) disjoint pairs covering
    every unordered block pair exactly once. ``nb`` must be even."""
    assert nb % 2 == 0
    players = list(range(nb))
    rounds = []
    for _ in range(nb - 1):
        pairs = [(players[i], players[nb - 1 - i]) for i in range(nb // 2)]
        rounds.append([(min(a, b), max(a, b)) for a, b in pairs])
        # rotate all but the first
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int32)


def _blocking(n: int, target_b: int = 128):
    """(b, nb, n_pad): even block count with blocks ≈ ``target_b``."""
    nb = 2 * max(1, round(n / (2.0 * target_b)))
    b = -(-n // nb)          # ceil
    return b, nb, b * nb


def _extract_pairs(A, rows, b: int):
    """The (m, 2b, 2b) diagonal pair problems [[Aii,Aij],[Aji,Ajj]] for
    the block permutation ``rows``, symmetrized."""
    nb = A.shape[0] // b
    Ar = A.reshape(nb, b, nb, b)
    i, j = rows[0::2], rows[1::2]
    top = torch.cat([Ar[i, :, i, :], Ar[i, :, j, :]], dim=2)
    bot = torch.cat([Ar[j, :, i, :], Ar[j, :, j, :]], dim=2)
    M = torch.cat([top, bot], dim=1)
    return 0.5 * (M + M.transpose(1, 2))


def _apply_round(A, Q, U, rows, b: int, chunks):
    """One round's rotations ``U`` (m, 2b, 2b) as stripe GEMMs: UᵀA over
    row stripes, (·)U over column stripes and the eigenvector accumulation
    QU, each split into ``chunks`` of pairs ``(lo, hi, device)``, every
    chunk computed on its device. Returns (A, Q, off(A))."""
    n = A.shape[0]
    nb = n // b
    m = nb // 2
    inv = torch.argsort(rows)
    home = A.device

    def by_chunks(fn):
        return torch.cat([fn(lo, hi, dev).to(home)
                          for lo, hi, dev in chunks], dim=0)

    Ap = A.reshape(nb, b, nb, b)[rows][:, :, rows].reshape(m, 2 * b,
                                                           m, 2 * b)
    A2 = by_chunks(lambda lo, hi, dev: torch.einsum(
        "tuv,tusw->tvsw", U[lo:hi].to(dev), Ap[lo:hi].to(dev)))
    A3 = by_chunks(lambda lo, hi, dev: torch.einsum(
        "tvsw,swx->sxtv", A2[:, :, lo:hi].to(dev), U[lo:hi].to(dev)))
    A3 = A3.permute(2, 3, 0, 1)
    A = A3.reshape(nb, b, nb, b)[inv][:, :, inv].reshape(n, n)
    A = 0.5 * (A + A.T)
    Qp = Q.reshape(n, nb, b)[:, rows].reshape(n, m, 2 * b)
    Q2 = by_chunks(lambda lo, hi, dev: torch.einsum(
        "nsw,swx->snx", Qp[:, lo:hi].to(dev), U[lo:hi].to(dev)))
    Q = Q2.permute(1, 0, 2).reshape(n, nb, b)[:, inv].reshape(n, n)
    off = torch.sqrt(torch.sum((A - torch.diag(torch.diag(A))) ** 2))
    return A, Q, off


def _sweep(A, Q, schedule, b: int, chunks):
    """One sweep: per round, the batched eigh of the pair problems (on A's
    device) and the stripe updates."""
    off = None
    for r in range(schedule.shape[0]):
        rows = torch.as_tensor(schedule[r].reshape(-1), dtype=torch.int64,
                               device=A.device)
        M = _extract_pairs(A, rows, b)
        U = torch.linalg.eigh(M.to(PAIR_DTYPE or M.dtype))[1].to(A.dtype)
        A, Q, off = _apply_round(A, Q, U, rows, b, chunks)
    return A, Q, off


def block_jacobi_eigh(A, mesh: Optional[Mesh] = None,
                      target_block: int = 128, tol: Optional[float] = None,
                      max_sweeps: int = 30):
    """Full symmetric eigendecomposition by cyclic block Jacobi; returns
    ``(values, vectors)`` with values **ascending**, like ``eigh``.

    ``A`` is a tensor or a sharded tensor (gathered onto the mesh's first
    shard, where the pair problems are solved). ``mesh`` splits every
    round's stripe GEMMs over its shards. ``tol``: off-diagonal Frobenius
    mass relative to ‖A‖_F at which to stop, default 50·eps of the dtype.
    Raises ``RuntimeError`` when ``max_sweeps`` do not converge (callers
    may fall back to a dense ``eigh``, never silently)."""
    A = dense(A)
    n = int(A.shape[0])
    dt = A.dtype
    if tol is None:
        tol = 50.0 * float(torch.finfo(dt).eps)
    b, nb, n_pad = _blocking(n, target_block)
    if nb < 2:
        return torch.linalg.eigh(A)
    schedule = round_robin_schedule(nb)
    m = nb // 2
    if mesh is None:
        chunks = [(0, m, A.device)]
    else:
        devs = list(mesh.devices.flat)
        chunks = [(lo, hi, devs[s]) for s, (lo, hi)
                  in enumerate(bounds(m, min(m, len(devs)))) if hi > lo]

    if n_pad != n:
        A = torch.nn.functional.pad(A, (0, n_pad - n, 0, n_pad - n))
    Q = torch.eye(n_pad, dtype=dt, device=A.device)
    normA = float(torch.sqrt(torch.sum(A * A)))
    off = np.inf
    for _ in range(max_sweeps):
        A, Q, off_d = _sweep(A, Q, schedule, b, chunks)
        off = float(off_d)
        if off <= tol * max(normA, 1e-300):
            break
    else:
        raise RuntimeError(
            f"block Jacobi did not converge in {max_sweeps} sweeps "
            f"(off={off:.3e}, tol={tol * normA:.3e})")

    vals = torch.diag(A)
    if n_pad != n:
        # the pad's eigenvectors live in the pad coordinates only, so the
        # top-n columns by row support over the first n rows are the true
        # ones
        support = torch.sum(Q[:n, :] ** 2, dim=0)
        keep = torch.sort(torch.argsort(support)[n_pad - n:]).values
        vals = vals[keep]
        Q = Q[:n, keep]
        Q = Q / torch.linalg.norm(Q, dim=0, keepdim=True)
    order = torch.argsort(vals)
    return vals[order], Q[:, order]
