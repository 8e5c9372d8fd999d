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
they differ. ``_krylov_moments`` and ``adaptive_eigensystem`` wait
(ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..types import Eigensystem
from .eig import _NAN_EIG_MSG, _subspace_iteration, lastkeeper_from_values
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
        head = self.eig.values_full.detach().cpu().double().numpy()
        return float(n) - _wsum(head, self.tail_theta, self.tail_w, lam)


# ---------------------------------------------------------------------------
# device (working-precision) side — the JAX program's arithmetic
# ---------------------------------------------------------------------------

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
    theta_s, V = torch.linalg.eigh(0.5 * (J + J.T))
    valid = (chol_ok & (theta_s[0] >= -1e-10)
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
    program's 13 outputs; ``L``/``U`` stay device scalars so the caller
    can hold them against the f64 host bounds."""
    n = K.shape[0]
    dt = y_std.dtype
    vals, vecs = _subspace_iteration(K, k, iters, extra)
    R = K - (vecs * vals[None, :]) @ vecs.T
    R = 0.5 * (R + R.T)
    R2 = R @ R
    R3 = R2 @ R
    moments = torch.stack([torch.trace(R), torch.sum(R * R), torch.trace(R3),
                           torch.sum(R2 * R2), torch.sum(R2 * R3)])
    del R, R2, R3
    vecs = -vecs

    keep = vals >= eigtrunc * vals[0]
    idx = torch.arange(k, device=K.device)
    lastkeeper = torch.clamp_min(
        torch.max(torch.where(keep, idx, -1)) + 1, 1)
    mask = (idx < lastkeeper).to(dt)

    theta, w = _tail_atoms_device(moments, float(n - k))
    L = _lower_bound_completed_device(vals, theta, w)
    U = _upper_bound_completed_device(vals, theta, w, n)

    lam, Le, coeffs, it = golden_solve(vecs, vals, y_std, float(L),
                                       float(U), tol, mask=mask)
    spectrum = mask / (vals + lam) ** 2
    return (vals, vecs, moments, lastkeeper, theta, w, L, U, lam, Le, coeffs,
            spectrum, it)


def postkernel_adaptive(K, y_std, eigtrunc: float, tol: float,
                        iters: Optional[int] = None, noisy: bool = False,
                        log: Callable[[str], None] = print):
    """The adaptive post-kernel fit. Returns ``(AdaptiveEig, lam, Le,
    coeffs, spectrum)`` (``spectrum`` the vcov filter ``1/(λ+λ*)²``, σ̂²
    applied by the caller), or ``None`` when the dense path is the right
    call.

    Depth defaults: f64 ``iters=5`` with the default oversampling; f32
    ``iters=3`` with +8 (the JAX package's values). The capture check
    grows k at most twice; the device bounds are accepted only if they
    match the f64 host bounds, else golden+solve re-runs once with the
    exact ones."""
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
        (vals, vecs, moments, lk_d, _theta_d, _w_d, L_d, U_d, lam, Le_d,
         coeffs_d, spectrum_d, _it) = _adaptive_fused(
            K, y_std, k, iters, eigtrunc, tol, extra)
        vals_np = vals.detach().cpu().double().numpy()
        if np.any(np.isnan(vals_np)):
            raise ValueError(_NAN_EIG_MSG)
        plan, aux = _capture_plan(vals_np, eigtrunc, k, kcap, n=n,
                                  noisy=noisy, log=log)
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

    # exact f64 bounds from the same values/moments (the oracle)
    m_np = moments.detach().cpu().double().numpy()
    tail_m = np.concatenate([[float(n - k)], np.maximum(m_np, 0.0)])
    theta, w = _tail_atoms(tail_m)
    L = _lower_bound_completed(vals_np, theta, w)
    U = _upper_bound_completed(vals_np, theta, w, n)
    if noisy:
        log(f"  adaptive eig: computed {k} of {n} eigenpairs "
            f"(lastkeeper={lastkeeper}); tail completed by "
            f"{theta.size}-point moment quadrature for the lambda bounds")

    eig = Eigensystem(values_full=vals, vectors=vecs[:, :lastkeeper],
                      lastkeeper=lastkeeper)
    out = AdaptiveEig(eig=eig, L=float(L), U=float(U), k=k,
                      tail_theta=theta, tail_w=w)

    # accept the working-precision solve only if its bounds picked the same
    # bisection steps as the f64 oracle (steps are 0.05 / 1.0, far outside
    # rounding) and its lastkeeper agrees
    L_dev, U_dev = float(L_d), float(U_d)
    same_bounds = (abs(L_dev - L) <= 1e-5 * max(1.0, abs(L))
                   and abs(U_dev - U) <= 1e-5 * max(1.0, abs(U))
                   and int(lk_d) == lastkeeper)
    if same_bounds:
        return out, lam, float(Le_d), coeffs_d, spectrum_d[:lastkeeper]
    if noisy:
        log("  adaptive eig: working-precision bounds differ from the "
            "f64 oracle; re-running golden+solve with exact bounds")
    lam, Le, coeffs = resume_adaptive(out, y_std, tol)
    spectrum = 1.0 / (out.eig.values + lam) ** 2
    return out, lam, Le, coeffs, spectrum


def resume_adaptive(out: AdaptiveEig, y_std, tol: float):
    """Golden search + spectral solve from a stored :class:`AdaptiveEig`;
    returns ``(lam, Le, coeffs)``."""
    lam, Le, coeffs, _ = golden_solve(out.eig.vectors, out.eig.values,
                                      y_std, out.L, out.U, tol)
    return lam, float(Le), coeffs
