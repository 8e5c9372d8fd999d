"""Symmetric eigendecomposition of the kernel: the dense half.

Port of the single-device part of ``bigkrls_tpu/ops/eig.py``: the full
``eigh``, randomized block-Krylov iteration, Lanczos, the lastkeeper rule
and ``eigensystem``. The streaming solvers wait (ROADMAP queue 1, item 12).

Conventions copied from the reference: eigenvalues **descending**,
eigenvectors **negated**, and ``lastkeeper`` applied to the vectors only.

Start blocks: the JAX package draws them from ``jax.random.PRNGKey(seed)``,
which torch cannot reproduce. The iterative solvers take an optional
``start`` block (tests pass the JAX draw); the default comes from a
``torch.Generator`` seeded with the same ``seed``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import Eigensystem

# above this many rows an f32 block is orthonormalized by CholeskyQR²
CHOLQR_MIN_ROWS = 16384

_NAN_EIG_MSG = ("Missing eigenvalues prevent obtaining the regularization "
                "parameter lambda. Check for repeated observations (or other "
                "perfect linear combinations in X).")


def _eigh_desc(K):
    vals, vecs = torch.linalg.eigh(K)
    return vals.flip(0), -vecs.flip(1)


def start_block(n: int, q: int, dtype, device, seed: int = 0):
    """The default random start block: standard normal (n, q) from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((n, q), generator=gen, dtype=dtype, device=device)


def _dgks(B, W):
    """Block Gram–Schmidt of W against B's orthonormal columns, twice."""
    for _ in range(2):
        W = W - B @ (B.T @ W)
    return W


def _householder_q(W):
    return torch.linalg.qr(W, mode="reduced")[0]


def _block_orth(W):
    """Orthonormalize the columns of a tall block W.

    Householder QR at f64 or below ``CHOLQR_MIN_ROWS`` rows; CholeskyQR²
    above, with its orthonormality checked (‖I − QᵀQ‖_max < 1e-5, finite
    factors) and Householder QR taken when the check fails — a host read
    of one flag where the JAX program used ``lax.cond``."""
    if W.dtype == torch.float64 or W.shape[0] < CHOLQR_MIN_ROWS:
        return _householder_q(W)

    def chol_pass(w):
        L, info = torch.linalg.cholesky_ex(w.T @ w)
        q = torch.linalg.solve_triangular(L, w.T, upper=False).T
        return q, L, info

    Q1, L1, i1 = chol_pass(W)
    Q2, L2, i2 = chol_pass(Q1)
    G2 = Q2.T @ Q2
    orth_err = torch.max(torch.abs(G2 - torch.eye(G2.shape[0], dtype=G2.dtype,
                                                  device=G2.device)))
    ok = ((i1 == 0) & (i2 == 0) & torch.isfinite(L1).all()
          & torch.isfinite(L2).all() & torch.isfinite(orth_err)
          & (orth_err < 1e-5))
    return Q2 if bool(ok) else _householder_q(W)


def _ritz_topk(B, KB, k: int):
    """Rayleigh–Ritz on an orthonormal basis: T = BᵀKB, top-k."""
    T = B.T @ KB
    T = 0.5 * (T + T.T)
    evals, S = torch.linalg.eigh(T)          # ascending
    return evals.flip(0)[:k], (B @ S.flip(1))[:, :k]


def _krylov_geometry(n: int, k: int, iters: int,
                     extra: Optional[int] = None):
    """(q, progressive): block width, and whether the progressive basis
    flow applies (total width (iters+1)·q ≤ n)."""
    if extra is None:
        extra = min(k, 32) + 8
    q = min(n, k + extra)
    return q, (iters + 1) * q <= n


def _subspace_iteration(K, k: int, iters: int, extra: Optional[int] = None,
                        start=None, seed: int = 0):
    """Randomized block-Krylov iteration for the top-k eigenpairs of
    symmetric K (Musco & Musco 2015 style); every power block is kept and
    Rayleigh–Ritz runs on the whole Krylov basis.

    Large n: the basis is kept orthonormal progressively (per-block QR +
    block DGKS) and each K@V_g is reused as a block of K·B. Small n
    (width ≥ n): stacked blocks reduced by one fat QR.

    ``start`` is the (n, q) start block (q from ``_krylov_geometry``);
    by default :func:`start_block` with ``seed``. Returns (values,
    vectors), descending, vectors not negated."""
    n = K.shape[0]
    q, progressive = _krylov_geometry(n, k, iters, extra)
    if start is None:
        start = start_block(n, q, K.dtype, K.device, seed)
    if tuple(start.shape) != (n, q):
        raise ValueError(f"start block must be ({n}, {q}), got "
                         f"{tuple(start.shape)}")
    V = _block_orth(start.to(dtype=K.dtype, device=K.device))

    if progressive:
        width = (iters + 1) * q
        B = torch.zeros((n, width), dtype=K.dtype, device=K.device)
        B[:, :q] = V
        KBs = []
        for g in range(iters):
            W = K @ V                 # K @ V_g — reused as KB block g
            KBs.append(W)
            W = _dgks(B, W)
            V = _block_orth(W)
            B[:, (g + 1) * q:(g + 2) * q] = V
        KBs.append(K @ V)
        return _ritz_topk(B, torch.cat(KBs, dim=1), k)

    blocks = [V]
    for _ in range(iters):
        blocks.append(_block_orth(K @ blocks[-1]))
    Q = _householder_q(torch.cat(blocks, dim=1))
    return _ritz_topk(Q, K @ Q, k)


def _lanczos(K, k: int, start=None, seed: int = 0):
    """Lanczos with full reorthogonalization, m = min(N, 2k+32) steps.
    ``start`` is the (n,) start vector; by default a seeded normal draw."""
    n = K.shape[0]
    m = min(n, 2 * k + 32)
    if start is None:
        start = start_block(n, 1, K.dtype, K.device, seed)[:, 0]
    v0 = start.to(dtype=K.dtype, device=K.device)
    V = torch.zeros((m, n), dtype=K.dtype, device=K.device)
    V[0] = v0 / torch.linalg.norm(v0)
    alphas = torch.zeros((m,), dtype=K.dtype, device=K.device)
    betas = torch.zeros((m,), dtype=K.dtype, device=K.device)
    tiny = torch.finfo(K.dtype).tiny
    for i in range(m):
        v = V[i]
        w = K @ v
        alpha = torch.dot(v, w)
        w = w - alpha * v
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        beta = torch.linalg.norm(w)
        if i + 1 < m:
            V[i + 1] = w / torch.clamp_min(beta, tiny)
        alphas[i] = alpha
        betas[i] = beta
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    evals, S = torch.linalg.eigh(T)
    return evals.flip(0)[:k], V.T @ S.flip(1)[:, :k]


def lastkeeper_from_values(values: np.ndarray, eigtrunc: float) -> int:
    """Reference truncation rule ``max(which(values >= eigtrunc*values[1]))``
    as a count."""
    values = np.asarray(values)
    idx = np.nonzero(values >= eigtrunc * values[0])[0]
    if idx.size == 0:
        return 1
    return int(idx.max()) + 1


def eigensystem(K, neig: Optional[int] = None, eigtrunc: float = 0.0,
                method: str = "auto", full_threshold: int = 8192,
                subspace_iters: int = 8, seed: int = 0,
                start=None) -> Eigensystem:
    """The (possibly truncated) eigensystem of the kernel.

    ``method``: "auto" | "full" | "subspace" | "lanczos". "auto" takes the
    full ``eigh`` when ``neig`` is no real truncation, block-Krylov when
    ``neig ≤ N/8``, ``eigh``-then-slice up to ``full_threshold`` and
    block-Krylov beyond. ``start`` is passed to the iterative solvers."""
    n = K.shape[0]
    neig = n if neig is None else min(n, int(neig))
    if method == "jacobi":
        raise NotImplementedError(
            "eig method 'jacobi' is the mesh solver (ROADMAP queue 1, "
            "item 18)")
    if method == "auto":
        if neig >= n:
            method = "full"
        elif neig * 8 <= n or n > full_threshold:
            method = "subspace"
        else:
            method = "full"

    if method == "full":
        vals, vecs = _eigh_desc(K)
        vals, vecs = vals[:neig], vecs[:, :neig]
    elif method == "subspace":
        vals, vecs = _subspace_iteration(K, neig, subspace_iters,
                                         start=start, seed=seed)
        vecs = -vecs
    elif method == "lanczos":
        vals, vecs = _lanczos(K, neig, start=start, seed=seed)
        vecs = -vecs
    else:
        raise ValueError(f"unknown eig method: {method!r}")

    vals_np = vals.detach().cpu().numpy()
    if np.any(np.isnan(vals_np)):
        raise ValueError(_NAN_EIG_MSG)
    lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
    return Eigensystem(values_full=vals, vectors=vecs[:, :lastkeeper],
                       lastkeeper=lastkeeper)
