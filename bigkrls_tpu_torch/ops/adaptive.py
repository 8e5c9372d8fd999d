"""Adaptive-truncation eigensolver for the default dense fit.

Port of ``bigkrls_tpu/ops/adaptive.py`` (see its docstring for the
method). At N > 3000 the reference truncates at ``0.001·λ₁`` but still
computes every eigenpair. This route computes only ~lastkeeper of them by
block-Krylov iteration, reconstructs the tail's share of the λ-search
bounds and Neffective from the exact deflated moments tr(Rʲ), j = 1..5,
R = K − Q̂Λ̂Q̂ᵀ, via a 3-point Gauss quadrature, and verifies a posteriori
that the truncation was captured (else it grows k, or declines and the
caller runs the dense path).

``_adaptive_fused`` keeps the JAX program's arithmetic: the mask form of
lastkeeper, the working-precision quadrature and bound bisections. The
host then checks capture and the bounds in f64 numpy, exactly as the JAX
``postkernel_adaptive`` does, and re-solves once with the exact bounds if
they differ. ``adaptive_eigensystem`` is the stand-alone eigensolver of
the same protocol (head pairs, f64 bounds and tail quadrature, no solve);
like the other iterative solvers it takes an optional start block, since
torch cannot reproduce the JAX package's ``PRNGKey`` draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.sharded import (ShardedTensor, block_product, commit,
                                fetch_region, fetch_rows, inner, map_blocks,
                                mesh_of, move, replicate, rows_map, trace)
from ..types import Eigensystem
from ..utils import progress
from .eig import (_NAN_EIG_MSG, _krylov_geometry, _subspace_iteration,
                  lastkeeper_from_values)
from .fused import _bisect
from .solve import golden_solve

_EPS = 2.220446049250313e-16  # R's .Machine$double.eps


# ---------------------------------------------------------------------------
# host (f64 numpy) side — verbatim from the JAX package
# ---------------------------------------------------------------------------

def tail_quadrature(moments: np.ndarray, npts: int):
    """Gauss-quadrature atoms/weights from power-sum moments
    m₀..m_{2npts−1} of a nonnegative measure (Hankel → Jacobi). Returns
    ``(theta, w)``, or ``None`` when the scaled Hankel matrix is not
    positive definite or an atom comes out negative."""
    m = np.asarray(moments, dtype=np.float64)
    m0 = float(m[0])
    if m0 <= 0.0 or m[1] <= 0.0:
        return np.zeros(0), np.zeros(0)
    if npts == 1:
        return np.array([m[1] / m0]), np.array([m0])
    s = m[1] / m0
    ms = np.array([m[j] / (m0 * s ** j) for j in range(2 * npts)])
    H = np.array([[ms[i + j] for j in range(npts)] for i in range(npts)])
    H1 = np.array([[ms[i + j + 1] for j in range(npts)] for i in range(npts)])
    try:
        C = np.linalg.cholesky(H)
    except np.linalg.LinAlgError:
        return None
    Ci = np.linalg.inv(C)
    J = Ci @ H1 @ Ci.T
    J = 0.5 * (J + J.T)
    theta, V = np.linalg.eigh(J)
    if theta[0] < -1e-10:
        return None
    w = m0 * (V[0, :] ** 2)
    return np.maximum(theta, 0.0) * s, w


def _tail_atoms(tail_moments: np.ndarray, max_npts: int = 3):
    """Best valid quadrature, degrading 3 → 2 → 1 points as needed."""
    for npts in range(max_npts, 0, -1):
        out = tail_quadrature(tail_moments[: 2 * npts], npts)
        if out is not None:
            return out
    return np.zeros(0), np.zeros(0)


def _wsum(head: np.ndarray, theta: np.ndarray, w: np.ndarray,
          c: float) -> float:
    """Σ λ/(λ+c) over the completed spectrum (head exactly, tail via the
    atoms); degenerate atoms are masked so c = 0 cannot give 0/0."""
    denom = theta + c
    tail = np.where((w > 0) & (denom > 0),
                    w * theta / np.where(denom > 0, denom, 1.0), 0.0)
    return float(np.sum(head / (head + c)) + np.sum(tail))


def _upper_bound_completed(head, theta, w, n: int) -> float:
    """Reference U loop on the completed spectrum: largest
    U ∈ {n, n−1, …} with Σ λ/(λ+U) ≥ 1."""
    if _wsum(head, theta, w, float(n)) >= 1.0:
        return float(n)
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        if _wsum(head, theta, w, float(n - mid)) >= 1.0:
            hi = mid
        else:
            lo = mid + 1
    return float(n - lo)


def _lower_bound_completed(head, theta, w) -> float:
    """Reference L loop on the completed spectrum: smallest
    L = eps + 0.05k with Σ λ/(λ+L) ≤ q, q taken over the head (the
    capture check guarantees the head crosses λ₁/1000)."""
    q = int(np.argmin(np.abs(head - head[0] / 1000.0))) + 1
    if _wsum(head, theta, w, _EPS) <= q:
        return _EPS
    hi = 1
    while _wsum(head, theta, w, _EPS + 0.05 * hi) > q:
        hi *= 2
    lo = max(1, hi // 2)
    while lo < hi:
        mid = (lo + hi) // 2
        if _wsum(head, theta, w, _EPS + 0.05 * mid) <= q:
            hi = mid
        else:
            lo = mid + 1
    return _EPS + 0.05 * lo


def _round64(x: float) -> int:
    return int(math.ceil(x / 64.0)) * 64


def _extrapolate_khat(vals: np.ndarray, thresh: float) -> Optional[int]:
    """Log-linear decay extrapolation of where the spectrum crosses
    ``thresh``; None when the head is too flat to say."""
    k = vals.shape[0]
    i0 = k // 2
    seg = vals[i0:]
    if np.any(seg <= 0):
        return k
    idx = np.arange(i0, k, dtype=np.float64)
    logs = np.log(seg)
    slope = np.polyfit(idx, logs, 1)[0]
    if slope >= -1e-12:
        return None
    return int(math.ceil(k + (math.log(thresh) - logs[-1]) / slope))


def _capture_plan(vals_np: np.ndarray, eigtrunc: float, k: int, kcap: int,
                  n: Optional[int] = None, margin: int = 8,
                  noisy: bool = False,
                  log: Callable[[str], None] = print):
    """A-posteriori capture decision: ``("ok", lastkeeper)``,
    ``("grow", knext)`` or ``("fallback", None)``. Capture must reach past
    both eigtrunc·λ₁ and λ₁/1000 (the λ-search q index)."""
    n = vals_np.shape[0] if n is None else n
    cap_trunc = min(eigtrunc, 1e-3)
    cap_thresh = cap_trunc * vals_np[0]
    k_capture = lastkeeper_from_values(vals_np, cap_trunc)
    lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
    if vals_np[k - 1] < cap_thresh and k_capture <= k - margin:
        return "ok", lastkeeper
    khat = _extrapolate_khat(vals_np, cap_thresh)
    if khat is None or khat > kcap:
        if noisy:
            log(f"  adaptive eig: spectrum too flat (needs "
                f"~{khat if khat else '>' + str(kcap)} of {n} pairs); "
                "falling back to exact dense eigh")
        return "fallback", None
    knext = min(_round64(max(1.25 * khat + margin, 1.5 * k)), kcap)
    if knext <= k:
        if noisy:
            log("  adaptive eig: cannot grow past the dense-crossover "
                "width; falling back to exact dense eigh")
        return "fallback", None
    if noisy:
        log(f"  adaptive eig: truncation not captured at k={k}, "
            f"growing to k={knext}")
    return "grow", knext


@dataclasses.dataclass
class AdaptiveEig:
    """A truncated eigensystem plus the moment-completed spectrum
    functionals the λ search and Neffective need from the tail."""

    eig: Eigensystem
    L: float
    U: float
    k: int
    tail_theta: np.ndarray
    tail_w: np.ndarray

    def neffective(self, lam: float, n: int) -> float:
        """N − Σ λ/(λ+λ*) over the completed spectrum."""
        progress.count("host_reads")
        head = self.eig.values_full.detach().cpu().double().numpy()
        return float(n) - _wsum(head, self.tail_theta, self.tail_w, lam)


# ---------------------------------------------------------------------------
# device (working-precision) side — the JAX program's arithmetic
# ---------------------------------------------------------------------------

def _deflated_moments(K, vals, vecs):
    """m₁..m₅ = tr(Rʲ) of the deflated residual R = K − Q̂Λ̂Q̂ᵀ: two N×N
    products (R², R³ = R²·R) and Frobenius inner products. For a
    block-sharded K, R is formed block by block and the products are
    block products (:func:`_deflated_moments_sharded`), timed as the span
    ``moments`` from an event of its own (the Krylov basis before it is
    its parent's work)."""
    if isinstance(K, ShardedTensor):
        with progress.span("moments", mark=True):
            return _deflated_moments_sharded(K, vals, vecs)
    R = K - (vecs * vals[None, :]) @ vecs.T
    R = 0.5 * (R + R.T)
    R2 = R @ R
    R3 = R2 @ R
    return torch.stack([torch.trace(R), torch.sum(R * R), torch.trace(R3),
                        torch.sum(R2 * R2), torch.sum(R2 * R3)])


def _deflated_moments_sharded(K, vals, vecs):
    """:func:`_deflated_moments` on a block-sharded K: block (i, j) of R is
    K_ij − (Q̂_i Λ̂) Q̂_jᵀ on that block's shard (the row slabs of a
    row-sharded Q̂ fetched from the shards that hold them), symmetrized
    against the transposed region (fetched alike), and R², R³ are block
    products. Only Q̂'s slabs and R's blocks move, never a whole. A card
    holds at most 7 blocks of its own size at once (K, R, R², and the
    block product's accumulator, partial and two fetched operands):
    R0 and the transposed regions are dropped once R is formed."""
    QL = rows_map(lambda v, lam: v * lam[None, :], vecs, vals)
    keys = K.keys()
    if isinstance(vecs, ShardedTensor):
        ql = fetch_rows(QL, [(K.owner(k), *K.row_bounds[k[0]])
                             for k in keys])
        qc = fetch_rows(vecs, [(K.owner(k), *K.col_bounds[k[1]])
                               for k in keys])
    else:
        ql = {r: QL[r[0]:r[1]] for r in K.row_bounds}
        qc = {c: vecs[c[0]:c[1]] for c in K.col_bounds}

    def deflate(i, j, blk, rows, cols):
        return blk - (move(ql[rows], blk.device)
                      @ move(qc[cols], blk.device).T)

    R0 = map_blocks(K, deflate)
    tr = fetch_region(R0, [(R0.owner(k), c0, c1, r0, r1)
                           for k in keys
                           for r0, r1, c0, c1 in [R0.key_bounds(k)]])

    def symmetrize(i, j, blk, rows, cols):
        t = move(tr[(cols[0], cols[1], rows[0], rows[1])], blk.device)
        s = blk + t.T
        del t
        return s.mul_(0.5)

    R = map_blocks(R0, symmetrize)
    del R0, tr
    R2 = block_product(R, R)
    R3 = block_product(R2, R)
    return torch.stack([trace(R), inner(R, R), trace(R3), inner(R2, R2),
                        inner(R2, R3)])


def _krylov_moments(K, k: int, iters: int, extra: Optional[int] = None,
                    start=None, seed: int = 0):
    """Top-k block-Krylov eigenpairs of K (vectors negated, as in the
    reference) plus the deflated-residual moments m₁..m₅. ``start`` is
    the (n, q) start block of ``_subspace_iteration``."""
    vals, vecs = _subspace_iteration(K, k, iters, extra, start=start,
                                     seed=seed)
    moments = _deflated_moments(K, vals, vecs)
    # the host's capture and bound checks read these on every process
    vals, moments = replicate(mesh_of(K, vecs), vals, moments)
    return vals, rows_map(torch.neg, vecs), moments

def _hankel(ms, npts: int, offset: int):
    idx = torch.arange(npts, device=ms.device)
    return ms[idx[:, None] + idx[None, :] + offset]


def _quad_device(m, npts: int):
    """One candidate ``npts``-point quadrature from device moments
    m[0..5]; (theta, w, valid) padded to 3 atoms, ``valid`` False where
    the host version returns None."""
    dt, dev = m.dtype, m.device
    zeros = torch.zeros((3 - npts,), dtype=dt, device=dev)
    if npts == 1:
        return (torch.cat([(m[1] / m[0])[None], zeros]),
                torch.cat([m[0][None], zeros]),
                torch.ones((), dtype=torch.bool, device=dev))
    s = m[1] / m[0]
    ms = m[: 2 * npts] / (m[0] * s ** torch.arange(2 * npts, dtype=dt,
                                                   device=dev))
    H = _hankel(ms, npts, 0)
    H1 = _hankel(ms, npts, 1)
    eye = torch.eye(npts, dtype=dt, device=dev)
    C, info = torch.linalg.cholesky_ex(H)
    chol_ok = (info == 0) & torch.isfinite(C).all()
    Cs = torch.where(chol_ok, C, eye)
    Ci = torch.linalg.solve_triangular(Cs, eye, upper=False)
    J = Ci @ H1 @ Ci.T
    # scaled moments past the dtype's range (a tail of near-zero moments in
    # f32) make J non-finite; torch's eigh raises on that where JAX's
    # returns NaN, so such a candidate is marked invalid before the eigh
    J_ok = torch.isfinite(J).all()
    progress.count("host_reads")    # eigh checks its info on the host
    theta_s, V = torch.linalg.eigh(torch.where(J_ok, 0.5 * (J + J.T), eye))
    valid = (chol_ok & J_ok & (theta_s[0] >= -1e-10)
             & torch.isfinite(theta_s).all())
    theta = torch.clamp_min(theta_s, 0.0) * s
    w = m[0] * V[0, :] ** 2
    return torch.cat([theta, zeros]), torch.cat([w, zeros]), valid


def _tail_atoms_device(moments, m0: float):
    """Best valid quadrature, 3 → 2 → 1 points, selected with ``where``."""
    m = torch.cat([torch.full((1,), m0, dtype=moments.dtype,
                              device=moments.device),
                   torch.clamp_min(moments, 0.0)])
    t3, w3, v3 = _quad_device(m, 3)
    t2, w2, v2 = _quad_device(m, 2)
    t1, w1, v1 = _quad_device(m, 1)
    zero = torch.zeros_like(t3)
    theta = torch.where(v3, t3, torch.where(v2, t2, torch.where(v1, t1,
                                                                zero)))
    w = torch.where(v3, w3, torch.where(v2, w2, torch.where(v1, w1, zero)))
    base = (m[0] > 0) & (m[1] > 0)
    return torch.where(base, theta, zero), torch.where(base, w, zero)


def _wsum_device(values, theta, w, c):
    """Σ λ/(λ+c) over the completed spectrum; pad atoms masked."""
    denom = theta + c
    tail = torch.where((w > 0) & (denom > 0),
                       w * theta / torch.where(denom > 0, denom,
                                               torch.ones_like(denom)),
                       torch.zeros_like(denom))
    return torch.sum(values / (values + c)) + torch.sum(tail)


def _upper_bound_completed_device(values, theta, w, n: int):
    dt, dev = values.dtype, values.device

    def cond_k(k):
        return _wsum_device(values, theta, w, n - k.to(dt)) >= 1.0

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lo = _bisect(cond_k, zero, zero + n, max(1, (n + 1).bit_length()))
    return n - lo.to(dt)


def _lower_bound_completed_device(values, theta, w):
    dt, dev = values.dtype, values.device
    q = (torch.argmin(torch.abs(values - values[0] / 1000.0)) + 1).to(dt)

    def cond_k(k):
        return _wsum_device(values, theta, w, _EPS + 0.05 * k.to(dt)) <= q

    total = _wsum_device(values, theta, w, torch.zeros((), dtype=dt,
                                                       device=dev))
    k_hi = torch.clamp_max(torch.ceil((total * values[0] / q) / 0.05) + 1.0,
                           2.0 ** 31 - 1).to(torch.int64)
    lo = _bisect(cond_k, torch.zeros((), dtype=torch.int64, device=dev),
                 k_hi, 48)
    return _EPS + 0.05 * lo.to(dt)


def _adaptive_fused(K, y_std, k: int, iters: int, eigtrunc: float,
                    tol: float, extra: Optional[int] = None):
    """The adaptive post-kernel region: block-Krylov top-k, deflated tail
    moments, the device quadrature, completed-spectrum bounds, golden
    search and solve, with lastkeeper as a mask. Returns the JAX
    program's 13 outputs, every one on the device (``it`` a host int):
    the golden search reads only its chunks' stopping flags, and the
    caller fetches the rest in one copy."""
    n = K.shape[0]
    dt = y_std.dtype
    with progress.span("krylov"):
        vals, vecs, moments = _krylov_moments(K, k, iters, extra)

    with progress.span("bounds"):
        keep = vals >= eigtrunc * vals[0]
        idx = torch.arange(k, device=K.device)
        lastkeeper = torch.clamp_min(
            torch.max(torch.where(keep, idx, -1)) + 1, 1)
        mask = (idx < lastkeeper).to(dt)

        theta, w = _tail_atoms_device(moments, float(n - k))
        L = _lower_bound_completed_device(vals, theta, w)
        U = _upper_bound_completed_device(vals, theta, w, n)

    with progress.span("lambda_search"):
        lam, Le, coeffs, it = golden_solve(vecs, vals, y_std, L, U, tol,
                                           mask=mask)
        spectrum = mask / (vals + lam) ** 2
    return (vals, vecs, moments, lastkeeper, theta, w, L, U, lam, Le, coeffs,
            spectrum, it)


def postkernel_adaptive(K, y_std, eigtrunc: float, tol: float,
                        iters: Optional[int] = None, noisy: bool = False,
                        mesh=None, log: Callable[[str], None] = print):
    """The adaptive post-kernel fit. Returns ``(AdaptiveEig, lam, Le,
    coeffs, spectrum)`` (``spectrum`` the vcov filter ``1/(λ+λ*)²``, σ̂²
    applied by the caller), or ``None`` when the dense path is the right
    call.

    Depth defaults: f64 ``iters=5`` with the default oversampling; f32
    ``iters=3`` with +8 (the JAX package's values). The capture check
    grows k at most twice; the device bounds are accepted only if they
    match the f64 host bounds, else golden+solve re-runs once with the
    exact ones.

    ``mesh``: K is block-sharded over it (``parallel/sharded.py``); the
    Krylov basis is row-sharded over axis "i", its products and the
    deflated moments are block products, the small Ritz and quadrature
    steps run on the mesh's first shard (computed once and broadcast
    across processes), the golden search reduces one LOO partial per
    shard, and the eigenbasis and coefficients come back row-sharded."""
    n = int(K.shape[0])
    if K.dtype == torch.float64:
        iters = 5 if iters is None else iters
        extra = None
    else:
        iters = 3 if iters is None else iters
        extra = 8
    kcap = (int(n * 0.25) // 64) * 64
    if kcap < 64:
        if noisy:
            log("  adaptive eig: N too small to truncate profitably; "
                "using exact dense eigh")
        return None
    k = min(_round64(max(64, n / 16.0)), kcap)

    for _attempt in range(3):
        (vals, vecs, moments, lk_d, _theta_d, _w_d, L_d, U_d, lam_d, Le_d,
         coeffs_d, spectrum_d, _it) = _adaptive_fused(
            K, y_std, k, iters, eigtrunc, tol, extra)
        with progress.span("check"):
            # one copy for every number the host checks (the JAX caller's
            # one round trip): values, moments, L, U, λ*, Le, lastkeeper
            host = torch.cat([vals, moments, torch.stack(
                [L_d, U_d, lam_d, Le_d, lk_d.to(vals.dtype)])]).double()
            progress.count("host_reads")
            host = host.detach().cpu().numpy()
            vals_np, m_np = host[:k], host[k:k + 5]
            L_dev, U_dev, lam, Le, lk = host[k + 5:].tolist()
            if np.any(np.isnan(vals_np)):
                raise ValueError(_NAN_EIG_MSG)
            plan, aux = _capture_plan(vals_np, eigtrunc, k, kcap, n=n,
                                      noisy=noisy, log=log)
            if plan == "ok":
                lastkeeper = aux
                # exact f64 bounds from the same values/moments (the
                # oracle)
                tail_m = np.concatenate([[float(n - k)],
                                         np.maximum(m_np, 0.0)])
                theta, w = _tail_atoms(tail_m)
                L = _lower_bound_completed(vals_np, theta, w)
                U = _upper_bound_completed(vals_np, theta, w, n)
                break
        if plan == "fallback":
            return None
        k = aux
    else:
        if noisy:
            log("  adaptive eig: truncation not captured after 3 attempts; "
                "falling back to exact dense eigh")
        return None

    if noisy:
        log(f"  adaptive eig: computed {k} of {n} eigenpairs "
            f"(lastkeeper={lastkeeper}); tail completed by "
            f"{theta.size}-point moment quadrature for the lambda bounds")

    vectors = _head(vecs, lastkeeper, mesh)
    eig = Eigensystem(values_full=vals, vectors=vectors,
                      lastkeeper=lastkeeper)
    out = AdaptiveEig(eig=eig, L=float(L), U=float(U), k=k,
                      tail_theta=theta, tail_w=w)

    # accept the working-precision solve only if its bounds picked the same
    # bisection steps as the f64 oracle (steps are 0.05 / 1.0, far outside
    # rounding) and its lastkeeper agrees
    same_bounds = (abs(L_dev - L) <= 1e-5 * max(1.0, abs(L))
                   and abs(U_dev - U) <= 1e-5 * max(1.0, abs(U))
                   and int(lk) == lastkeeper)
    if same_bounds:
        return out, lam, Le, coeffs_d, spectrum_d[:lastkeeper]
    if noisy:
        log("  adaptive eig: working-precision bounds differ from the "
            "f64 oracle; re-running golden+solve with exact bounds")
    with progress.span("lambda_search"):
        lam, Le, coeffs = resume_adaptive(out, y_std, tol)
        spectrum = 1.0 / (out.eig.values + lam) ** 2
    return out, lam, Le, coeffs, spectrum


def resume_adaptive(out: AdaptiveEig, y_std, tol: float):
    """Golden search + spectral solve from a stored :class:`AdaptiveEig`
    (its vectors a tensor or row-sharded, as ``y_std``), on the device as
    JAX's resume re-runs ``_golden_solve``; returns ``(lam, Le, coeffs)``
    with λ* and Le read in one copy."""
    lam, Le, coeffs, _ = golden_solve(out.eig.vectors, out.eig.values,
                                      y_std, out.L, out.U, tol)
    progress.count("host_reads")
    lam, Le = torch.stack([lam, Le]).tolist()
    return lam, Le, coeffs


def _head(vecs, lastkeeper: int, mesh):
    """The first ``lastkeeper`` vectors, row-sharded over ``mesh`` when one
    is given (they already are, for a block-sharded K)."""
    if mesh is None:
        return vecs[:, :lastkeeper]
    return commit(rows_map(lambda v: v[:, :lastkeeper].contiguous(), vecs),
                  mesh, "row")


def adaptive_eigensystem(
    K,
    eigtrunc: float,
    iters: Optional[int] = None,
    seed: int = 0,
    max_fraction: float = 0.25,
    margin: int = 8,
    noisy: bool = False,
    log: Callable[[str], None] = print,
    start: Optional[Callable[[int], torch.Tensor]] = None,
    mesh=None,
) -> Optional[AdaptiveEig]:
    """Only ~lastkeeper eigenpairs of K, with verified truncation: the
    block-Krylov head and the deflated tail moments at k₀ ≈ N/16; capture
    checked past ``min(eigtrunc, 1e-3)·λ₁`` with ``margin`` pairs to
    spare; k grown from the decay's extrapolation (at most twice), or
    ``None`` (the caller runs the dense path) when it would pass
    ``max_fraction·N``; then the 3-point tail quadrature and the
    completed-spectrum λ bounds in f64. ``iters=None``: 5 in f64, 4 in
    f32.

    ``start(q)`` gives the (n, q) start block of each attempt (q grows with
    k); by default a seeded torch draw (``eig.start_block``). ``mesh``: as
    in :func:`postkernel_adaptive`; the head vectors come back row-sharded
    over axis "i"."""
    n = int(K.shape[0])
    if iters is None:
        iters = 5 if K.dtype == torch.float64 else 4
    kcap = (int(n * max_fraction) // 64) * 64
    if kcap < 64:
        if noisy:
            log("  adaptive eig: N too small to truncate profitably; "
                "using exact dense eigh")
        return None
    k = min(_round64(max(64, n / 16.0)), kcap)

    for _attempt in range(3):
        block = None
        if start is not None:
            block = start(_krylov_geometry(n, k, iters)[0])
        vals, vecs, moments = _krylov_moments(K, k, iters, start=block,
                                              seed=seed)
        vals_np = vals.detach().cpu().double().numpy()
        if np.any(np.isnan(vals_np)):
            raise ValueError(_NAN_EIG_MSG)
        plan, aux = _capture_plan(vals_np, eigtrunc, k, kcap, n=n,
                                  margin=margin, noisy=noisy, log=log)
        if plan == "ok":
            lastkeeper = aux
            break
        if plan == "fallback":
            return None
        k = aux
    else:
        if noisy:
            log("  adaptive eig: truncation not captured after 3 attempts; "
                "falling back to exact dense eigh")
        return None

    m_np = moments.detach().cpu().double().numpy()
    tail_m = np.concatenate([[float(n - k)], np.maximum(m_np, 0.0)])
    theta, w = _tail_atoms(tail_m)
    L = _lower_bound_completed(vals_np, theta, w)
    U = _upper_bound_completed(vals_np, theta, w, n)
    if noisy:
        log(f"  adaptive eig: computed {k} of {n} eigenpairs "
            f"(lastkeeper={lastkeeper}); tail completed by "
            f"{theta.size}-point moment quadrature for the lambda bounds")
    eig = Eigensystem(values_full=vals,
                      vectors=_head(vecs, lastkeeper, mesh),
                      lastkeeper=lastkeeper)
    return AdaptiveEig(eig=eig, L=float(L), U=float(U), k=k,
                       tail_theta=theta, tail_w=w)
