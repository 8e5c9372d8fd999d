"""Symmetric eigendecomposition of the kernel, dense and kernel-free.

Port of ``bigkrls_tpu/ops/eig.py``: the full ``eigh``, randomized
block-Krylov iteration, Lanczos, block Jacobi (``parallel/jacobi.py``),
the lastkeeper rule and ``eigensystem`` for a stored kernel, which may be
block-sharded over a mesh (``parallel/sharded.py``: the solvers' products
K·V are then block products, and what XLA runs replicated runs on the
mesh's first shard); and ``eigensystem_streaming``, which needs only
products K·V (``ops/matvec.py``, or the ring product of
``parallel/ring_kernel.py``) and never builds K, in its three flows
(progressive block-Krylov, stacked blocks + fat QR, constant-memory
Chebyshev).

Conventions copied from the reference: eigenvalues **descending**,
eigenvectors **negated**, and ``lastkeeper`` applied to the vectors only.

Start blocks: the JAX package draws them from ``jax.random.PRNGKey(seed)``,
which torch cannot reproduce. The iterative solvers take an optional
``start`` block (tests pass the JAX draw); the default comes from a
``torch.Generator`` seeded with the same ``seed``.
"""
from __future__ import annotations

import collections
import functools
import logging
from typing import Optional

import numpy as np
import torch

from ..parallel.sharded import (ShardedTensor, collect, commit, dense, gram,
                                mesh_of, move, place, replicate, rows_map,
                                rows_reduce)
from ..types import Eigensystem
from ..utils.progress import RECORDER, count, span
from . import matvec

# above this many rows an f32 block is orthonormalized by CholeskyQR²
CHOLQR_MIN_ROWS = 16384
# from this many rows the streaming solver reports progress after every
# product (the JAX package's rule: one product is seconds long there)
PER_PRODUCT_PROGRESS_N = 200_000
# how ``_block_orth`` has orthonormalized blocks since import, by branch:
# "cholqr2" (CholeskyQR², its check passed), "householder_after_check"
# (the check failed and Householder QR ran: the JAX program's ``lax.cond``
# branch) and "householder" (f64, or fewer than CHOLQR_MIN_ROWS rows)
block_orth_counts: collections.Counter = collections.Counter()

_LOG = logging.getLogger("bigkrls_tpu_torch")

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
    """Block Gram–Schmidt of W against B's orthonormal columns, twice. On
    row shards: the Gram BᵀW is reduced over them, the update is local."""
    for _ in range(2):
        W = rows_map(lambda b, w, g: w - b @ g, B, W, gram(B, W))
    return W


def _tsqr(W):
    """Householder QR of a row-sharded block by TSQR: each shard's QR, a
    replicated QR of the stacked R factors (k×k blocks, computed once and
    broadcast), and each shard's Q times its rows of the second Q. Only
    the R factors cross shards."""
    n, w = W.shape
    facs = [None if t is None else torch.linalg.qr(t, mode="reduced")
            for t in W.shards]
    shapes = [(min(r1 - r0, w), w) for r0, r1 in W.row_bounds]
    Rs = collect(W, [None if f is None else f[1] for f in facs], shapes,
                 label="eig: TSQR of a basis of N rows or more")
    (Q2,) = replicate(W.mesh, torch.linalg.qr(torch.cat(Rs),
                                              mode="reduced")[0])
    offs = np.concatenate([[0], np.cumsum([s[0] for s in shapes])])
    shards = [None if f is None else
              f[0] @ move(Q2[offs[i]:offs[i + 1]], f[0].device)
              for i, f in enumerate(facs)]
    return ShardedTensor(W.mesh, "row", (n, Q2.shape[1]), shards, W.dtype)


def _householder_q(W):
    if isinstance(W, ShardedTensor):
        return _tsqr(W)
    return torch.linalg.qr(W, mode="reduced")[0]


def _block_orth(W):
    """Orthonormalize the columns of a tall block W (a tensor, or
    row-sharded).

    Householder QR at f64 or below ``CHOLQR_MIN_ROWS`` rows (TSQR on row
    shards); CholeskyQR² above, with its orthonormality checked
    (‖I − QᵀQ‖_max < 1e-5, finite factors) and Householder QR taken when
    the check fails — a host read of one flag where the JAX program used
    ``lax.cond``. On row shards the Grams are reduced over them and the
    Cholesky factors computed once and broadcast, so every process reads
    the same flag. Each call counts its branch in ``block_orth_counts``."""
    if W.dtype == torch.float64 or W.shape[0] < CHOLQR_MIN_ROWS:
        block_orth_counts["householder"] += 1
        return _householder_q(W)
    mesh = mesh_of(W)

    def chol_pass(w):
        L, info = replicate(mesh, *torch.linalg.cholesky_ex(gram(w, w)))
        q = rows_map(lambda a, l: torch.linalg.solve_triangular(
            l, a.T, upper=False).T, w, L)
        return q, L, info

    Q1, L1, i1 = chol_pass(W)
    Q2, L2, i2 = chol_pass(Q1)
    G2 = gram(Q2, Q2)
    orth_err = torch.max(torch.abs(G2 - torch.eye(G2.shape[0], dtype=G2.dtype,
                                                  device=G2.device)))
    ok = ((i1 == 0) & (i2 == 0) & torch.isfinite(L1).all()
          & torch.isfinite(L2).all() & torch.isfinite(orth_err)
          & (orth_err < 1e-5))
    count("host_reads")
    if bool(ok):
        block_orth_counts["cholqr2"] += 1
        return Q2
    block_orth_counts["householder_after_check"] += 1
    return _householder_q(W)


def _ritz_topk(B, KB, k: int):
    """Rayleigh–Ritz on an orthonormal basis: T = BᵀKB, top-k. On row
    shards T is reduced over them and its ``eigh`` computed once and
    broadcast; the Ritz vectors stay on the shards."""
    T = gram(B, KB)
    T = 0.5 * (T + T.T)
    count("host_reads")    # eigh checks its info on the host
    evals, S = replicate(mesh_of(B), *torch.linalg.eigh(T))   # ascending
    return evals.flip(0)[:k], rows_map(lambda b, s: b @ s, B,
                                       S.flip(1)[:, :k])


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

    For a block-sharded K the basis is row-sharded over the mesh's axis
    "i" (the start block placed so) and every K@V a block product; the
    returned vectors are row-sharded.

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
    V = start.to(dtype=K.dtype, device=K.device)
    del start       # V may be the same tensor: the solve frees it with V
    if isinstance(K, ShardedTensor):
        V = place(V, K.mesh, "row")
    V = _block_orth(V)

    if progressive:
        width = (iters + 1) * q
        B = rows_map(lambda v: v.new_zeros((v.shape[0], width)), V)
        _put(B, 0, V)
        KBs = []
        for g in range(iters):
            W = K @ V                 # K @ V_g — reused as KB block g
            KBs.append(W)
            W = _dgks(B, W)
            V = _block_orth(W)
            _put(B, (g + 1) * q, V)
        KBs.append(K @ V)
        return _ritz_topk(B, _hcat(KBs), k)

    blocks = [V]
    for _ in range(iters):
        blocks.append(_block_orth(K @ blocks[-1]))
    Q = _householder_q(_hcat(blocks))
    return _ritz_topk(Q, K @ Q, k)


def _put(B, col: int, V):
    """``B[:, col:col + V.shape[1]] = V``, shard by shard on row shards."""
    rows_map(lambda b, v: b[:, col:col + v.shape[1]].copy_(v), B, V)


def _hcat(blocks):
    """The blocks side by side (``torch.cat(blocks, dim=1)``)."""
    return rows_map(lambda *bs: torch.cat(bs, dim=1), *blocks)


def _neg(V):
    return rows_map(torch.neg, V)


def _lanczos(K, k: int, start=None, seed: int = 0):
    """Lanczos with full reorthogonalization, m = min(N, 2k+32) steps.
    ``start`` is the (n,) start vector; by default a seeded normal draw.
    The Lanczos vectors are the columns of an (n, m) basis, row-sharded
    for a block-sharded K (dot products and the reorthogonalization's
    Grams then reduced over the shards)."""
    n = K.shape[0]
    m = min(n, 2 * k + 32)
    if start is None:
        start = start_block(n, 1, K.dtype, K.device, seed)[:, 0]
    v0 = start.to(dtype=K.dtype, device=K.device)
    if isinstance(K, ShardedTensor):
        v0 = place(v0, K.mesh, "row")
    Vt = rows_map(lambda v: v.new_zeros((v.shape[0], m)), v0)
    rows_map(lambda b, v, nrm: b[:, 0].copy_(v / nrm), Vt, v0, _norm(v0))
    alphas = torch.zeros((m,), dtype=K.dtype, device=K.device)
    betas = torch.zeros((m,), dtype=K.dtype, device=K.device)
    tiny = torch.finfo(K.dtype).tiny
    for i in range(m):
        v = rows_map(lambda b: b[:, i], Vt)
        w = K @ v
        alpha = gram(v, w)
        w = rows_map(lambda a, b, al: a - al * b, w, v, alpha)
        for _ in range(2):
            w = rows_map(lambda a, b, g: a - b @ g, w, Vt, gram(Vt, w))
        beta = _norm(w)
        if i + 1 < m:
            rows_map(lambda b, a, be: b[:, i + 1].copy_(
                a / torch.clamp_min(be, tiny)), Vt, w, beta)
        alphas[i] = alpha
        betas[i] = beta
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    evals, S = replicate(mesh_of(Vt), *torch.linalg.eigh(T))
    return evals.flip(0)[:k], rows_map(lambda b, s: b @ s, Vt,
                                       S.flip(1)[:, :k])


def _norm(v):
    """‖v‖₂ of a vector, reduced over row shards."""
    return torch.sqrt(rows_reduce(lambda a: torch.dot(a, a), v))


def lastkeeper_from_values(values: np.ndarray, eigtrunc: float) -> int:
    """Reference truncation rule ``max(which(values >= eigtrunc*values[1]))``
    as a count."""
    values = np.asarray(values)
    idx = np.nonzero(values >= eigtrunc * values[0])[0]
    if idx.size == 0:
        return 1
    return int(idx.max()) + 1


def _replicated_eigh_fits(n: int, itemsize: int,
                          budget: Optional[int] = None,
                          fraction: float = 0.35, device=None) -> bool:
    """The JAX package's memory crossover for a full decomposition under
    a mesh: a gathered ``eigh`` needs ~3·N² elements (operator, workspace,
    vectors) on one shard, block Jacobi keeps the O(N²) work split over
    the shards at ~10× the FLOPs. Gather while that fits ``fraction`` of
    the device's memory (``utils/memory.device_memory_budget``)."""
    need = 3 * n * n * itemsize
    if budget is None:
        from ..utils.memory import device_memory_budget
        budget = device_memory_budget(device)
    return need <= fraction * budget


def eigensystem(K, neig: Optional[int] = None, eigtrunc: float = 0.0,
                method: str = "auto", full_threshold: int = 8192,
                subspace_iters: int = 8, seed: int = 0,
                start=None, mesh=None) -> Eigensystem:
    """The (possibly truncated) eigensystem of the kernel.

    ``method``: "auto" | "full" | "subspace" | "lanczos" | "jacobi".
    "auto" takes the full ``eigh`` when ``neig`` is no real truncation,
    block-Krylov when ``neig ≤ N/8``, ``eigh``-then-slice up to
    ``full_threshold`` and block-Krylov beyond. ``start`` is passed to the
    iterative solvers.

    ``mesh`` (K then usually block-sharded over it): "auto" takes
    block-Krylov for any real truncation, its products K·V being block
    products; for the full spectrum, a gathered ``eigh`` on the mesh's
    first shard while :func:`_replicated_eigh_fits`, else block Jacobi
    (``parallel/jacobi.py``). A Jacobi run that does not converge falls
    back to a gathered ``eigh`` and logs a warning, as in the JAX package.
    The iterative solvers keep their bases row-sharded over the mesh's
    axis "i"; the gathered ``eigh`` and block Jacobi gather K, as the JAX
    package replicates them. The eigenvectors come back row-sharded over
    axis "i"."""
    n = K.shape[0]
    neig = n if neig is None else min(n, int(neig))
    if method == "auto":
        if neig < n and mesh is not None:
            method = "subspace"
        elif mesh is not None:
            if _replicated_eigh_fits(n, K.element_size(),
                                     device=mesh.first_device):
                method = "full"
                _LOG.info("mesh full-spectrum eig: the operator fits one "
                          "shard's memory; using a gathered eigh")
            else:
                method = "jacobi"
                _LOG.info("mesh full-spectrum eig: N=%d too large to "
                          "gather; using distributed block Jacobi", n)
        elif neig >= n:
            method = "full"
        elif neig * 8 <= n or n > full_threshold:
            method = "subspace"
        else:
            method = "full"

    if method == "full":
        vals, vecs = _eigh_desc(dense(K, label="eig: replicated eigh"))
        vals, vecs = vals[:neig], vecs[:, :neig]
    elif method == "jacobi":
        from ..parallel.jacobi import block_jacobi_eigh
        try:
            vals, vecs = block_jacobi_eigh(K, mesh=mesh)
        except RuntimeError as e:
            _LOG.warning("block Jacobi fell back to gathered dense eigh: %s",
                         e)
            vals, vecs = torch.linalg.eigh(
                dense(K, label="eig: eigh after block Jacobi failed"))
        vals = vals.flip(0)[:neig]
        vecs = -vecs.flip(1)[:, :neig]
    elif method == "subspace":
        vals, vecs = _subspace_iteration(K, neig, subspace_iters,
                                         start=start, seed=seed)
        vecs = _neg(vecs)
    elif method == "lanczos":
        vals, vecs = _lanczos(K, neig, start=start, seed=seed)
        vecs = _neg(vecs)
    else:
        raise ValueError(f"unknown eig method: {method!r}")

    vals_np = vals.detach().cpu().numpy()
    if np.any(np.isnan(vals_np)):
        raise ValueError(_NAN_EIG_MSG)
    lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
    # row-major, as a checkpoint's vectors load (``eigh`` returns them
    # column-major), so that a resumed fit runs the same products bit for bit
    vecs = rows_map(lambda v: v[:, :lastkeeper].contiguous(), vecs)
    if mesh is not None:
        vecs = commit(vecs, mesh, "row")
    return Eigensystem(values_full=vals, vectors=vecs, lastkeeper=lastkeeper)


# ---------------------------------------------------------------------------
# kernel-free (streaming) solvers: only products K·V, never K
# ---------------------------------------------------------------------------


def _orth(W):
    """``_block_orth`` with a contiguous result (the product kernel takes
    contiguous blocks; QR and triangular solves may return strided ones)."""
    return rows_map(lambda t: t.contiguous(), _block_orth(W))


def _cheb_degrees(nprod: int):
    """Split a product budget into Chebyshev application degrees: first
    degree 2 (its cutoff comes from a random subspace's Ritz values), then
    degree 3 while the budget lasts; a degree-1 remainder is a shifted
    power step."""
    degrees = []
    budget = int(nprod)
    first = True
    while budget > 0:
        d = min(2 if first else 3, budget)
        degrees.append(d)
        budget -= d
        first = False
    return degrees


def _block_scale(U):
    """Scalar scale of a recurrence block (max-abs: overflow-proof at f32
    even when the filter has amplified the block by ~1e8). A 0-dim tensor
    on U's device (the mesh's first, for row shards): no host read."""
    return torch.clamp_min(rows_reduce(lambda u: torch.max(torch.abs(u)), U,
                                       op="max"), 1e-30)


def _cheb_app_start(X, V, c_prev: float, sigma, matmul):
    """First product of a Chebyshev application: ``W = K·V`` plus the free
    cutoff update. The q×q Gram ``VᵀW`` is the Rayleigh quotient of the
    orthonormal block; its smallest eigenvalue θ_min ≤ λ_q (Cauchy
    interlacing), so ``c = max(c_prev, θ_min)`` never damps a wanted
    direction. Returns the first two scalar-rescaled recurrence blocks
    ``T₀(K̃)V = V`` and ``T₁(K̃)V`` for ``K̃ = (2K − cI)/c``, the relative
    scale and the cutoff. The cutoff is read to the host (one float per
    application): the product kernel takes its scale as a host number."""
    W = matmul(X, V, sigma)
    S = gram(V, W)
    S = 0.5 * (S + S.T)
    (theta,) = replicate(mesh_of(V), torch.linalg.eigvalsh(S))  # ascending
    count("host_reads", 2)     # eigvalsh's info, the cutoff
    lo, hi = theta[[0, -1]].tolist()
    c = max(max(c_prev, lo), 1e-6 * hi)
    Y = rows_map(lambda w, v: w.mul(2.0 / c).sub_(v), W, V)
    tau = _block_scale(Y)
    return V, rows_map(lambda y, t: y.div_(t), Y, tau), 1.0 / tau, c


def _cheb_step(X, Yp, Yc, r, c: float, sigma, matmul):
    """One Chebyshev three-term recurrence step (one K·V product):
    ``Y_{j+1} = 2·K̃·Y_j − Y_{j−1}``, carried in scalar-rescaled form (``r``
    is the previous block's relative scale) so degree-3 filters cannot
    overflow f32. Scalar rescaling leaves the final block's column span
    unchanged. The generic form, for any ``matmul(X, V, sigma)`` callable;
    the package's own product takes :func:`_cheb_step_fused`."""
    Z = matmul(X, Yc, sigma)
    U = rows_map(lambda z, yc, yp, r_: (4.0 / c) * z - 2.0 * yc - r_ * yp,
                 Z, Yc, Yp, r)
    tau = _block_scale(U)
    return Yc, rows_map(lambda u, t: u / t, U, tau), 1.0 / tau


def _cheb_step_fused(X, Yp, Yc, r, c: float, sigma, matmul):
    """:func:`_cheb_step` with the recurrence folded into the product's
    epilogue: ``U = (K·Yc + init)·(4/c)`` with ``init = −(c/4)(2Yc + rYp)``.
    ``init`` is built in place in ``Yp``'s storage and the product writes
    ``U`` over it, so no separate Z or U block exists and the step holds
    the two blocks a plain power step holds. ``Yp`` is consumed: the
    caller must not use it afterwards."""
    init = rows_map(lambda yp, yc, r_: yp.mul_(r_).add_(yc, alpha=2.0)
                    .mul_(-(c / 4.0)), Yp, Yc, r)
    U = matmul(X, Yc, sigma, init=init, out_scale=4.0 / c, out=init)
    tau = _block_scale(U)
    return Yc, rows_map(lambda u, t: u.div_(t), U, tau), 1.0 / tau


def _power_chunk_blocks(X, V, sigma, steps: int, matmul):
    """``steps`` plain power iterations returning every intermediate block
    (stacked column-wise): the small-n flow, whose caller runs one fat
    reduced QR over the stacked basis."""
    blocks = []
    for _ in range(steps):
        V = _orth(matmul(X, V, sigma))
        blocks.append(V)
    return V, _hcat(blocks)


def _fatqr_ritz_streaming(X, B, sigma, k: int, matmul):
    """Rayleigh–Ritz after one fat reduced QR of the stacked blocks; K·Q
    recomputed with the full-precision ``matmul``."""
    Q = rows_map(lambda t: t.contiguous(), _householder_q(B))
    return _ritz_topk(Q, matmul(X, Q, sigma), k)


def _krylov_chunk(X, V, B, KB, g: int, sigma, steps: int, matmul,
                  store_kb: bool):
    """``steps`` kernel-free block-Krylov steps (K·V product, block DGKS,
    QR). ``B`` is the preallocated n×((d+1)·q) basis holding orthonormal
    blocks V_0..V_g; each step stores K·V_g into ``KB`` (when
    ``store_kb``) and appends the next block to ``B``. Both are updated in
    place. DGKS projects against the filled blocks only (the unfilled ones
    are zero and would contribute exactly nothing)."""
    q = V.shape[1]
    for _ in range(steps):
        W = matmul(X, V, sigma)                  # K @ V_g
        if store_kb:
            _put(KB, g * q, W)
        W = _dgks(rows_map(lambda b: b[:, :(g + 1) * q], B), W)
        V = _orth(W)
        g += 1
        _put(B, g * q, V)
    return V, B, KB, g


def _krylov_ritz_streaming(X, B, KB, V_last, sigma, k: int, matmul,
                           reuse_kb: bool):
    """Rayleigh–Ritz for the streaming flows. With ``reuse_kb`` the power
    products already filled K·B at full precision and only the last
    block's product is computed here; otherwise the whole K·B is
    recomputed with the full-precision ``matmul``, so Ritz quality never
    inherits reduced-precision noise."""
    if reuse_kb:
        _put(KB, B.shape[1] - V_last.shape[1], matmul(X, V_last, sigma))
    else:
        KB = matmul(X, B, sigma)
    return _ritz_topk(B, KB, k)


def _resolve_fast_power(fast_power, krylov: bool, progressive: bool) -> bool:
    """Resolve ``fast_power="auto"`` by the flow's product structure: the
    progressive block-Krylov flow reuses its power products as K·B for
    Rayleigh–Ritz, so they must be full precision (fast products would
    force a full-width recompute); the constant-memory and stacked flows
    recompute K·B anyway, so fast power products cost nothing extra."""
    if fast_power != "auto":
        return bool(fast_power)
    return not (krylov and progressive)


def _auto_krylov(n: int, q: int, iters: int, itemsize: int,
                 budget: Optional[int] = None, fraction: float = 0.6,
                 device=None) -> bool:
    """Pick block-Krylov vs the constant-memory flow by memory fit.

    The progressive basis costs ~2·N·(iters+1)·q elements (B plus the
    recorded K·B); above ``fraction`` of the device's memory
    (``utils.memory.device_memory_budget``) the solver takes the
    constant-memory flow and logs why."""
    basis_bytes = 2 * n * (iters + 1) * q * itemsize
    if budget is None:
        from ..utils.memory import device_memory_budget
        budget = device_memory_budget(device)
    ok = basis_bytes <= fraction * budget
    if not ok:
        _LOG.warning(
            "eigensystem_streaming: block-Krylov basis would need "
            "%.1f GB (> %d%% of %.1f GB device memory); using the "
            "constant-memory Chebyshev subspace iteration instead — "
            "raise `iters` if trailing-eigenvalue accuracy matters at "
            "this scale",
            basis_bytes / 1024 ** 3, int(fraction * 100),
            budget / 1024 ** 3)
    return ok


def eigensystem_streaming(
    X_std,
    sigma,
    neig: int,
    eigtrunc: float = 0.0,
    iters: int = 8,
    seed: int = 0,
    matmul=None,
    fast_power="auto",
    power_matmul=None,
    progress=None,
    chunk: int = 4,
    krylov: Optional[bool] = None,
    start=None,
    impl: str = "auto",
    mesh=None,
) -> Eigensystem:
    """Truncated eigensystem of the (never materialized) kernel of X_std.

    Each power step is one product K·V (``ops/matvec.kernel_matmul``);
    storage is O(N·q). Same conventions as :func:`eigensystem`
    (descending values, negated vectors, lastkeeper applied to the vectors
    only). ``neig`` must be < N.

    ``matmul(X, V, sigma)`` is the full-precision product; by default the
    package's own, with ``impl`` passed on to it. A callable with the
    package product's signature (``fast_accum``, ``init``, ``out_scale``,
    ``out``) marks itself with ``takes_fast_accum = True``, as the ring
    product does, and is treated as the package's own. ``power_matmul``
    serves the power and Chebyshev products only; by default it is
    ``matmul``, or, when ``fast_power`` resolves true
    (:func:`_resolve_fast_power`) and X_std is an f32 CUDA tensor,
    ``matmul`` with ``fast_accum=True`` (TF32 on tile·V). The final
    Rayleigh–Ritz always uses ``matmul``. With any other caller-supplied
    callable, ``fast_power`` has no effect and the Chebyshev flow takes the
    generic :func:`_cheb_step`.

    ``krylov=True`` keeps every power block (progressively orthonormal)
    and runs Rayleigh–Ritz on the whole block-Krylov basis, memory
    O(N·q·iters); where that basis would be wider than N, the stacked
    blocks are reduced by one fat QR. ``krylov=False`` forces the
    constant-memory flow: Chebyshev-filtered subspace iteration, with
    ``iters ≥ 4`` mapped to ``iters − 2`` filter products. ``None`` picks
    by memory (:func:`_auto_krylov`).

    ``start`` is the (n, q) start block before orthonormalization, q from
    ``_krylov_geometry(n, neig, iters)``; by default :func:`start_block`
    with ``seed``. ``progress(done, total)`` is called after every
    ``chunk`` products, after the device has finished them; from
    N = 200,000 after every product (``chunk`` clamped to 1), as in the
    JAX package.

    ``mesh`` (a ring, passed together with its ring ``matmul``,
    ``parallel/ring_kernel.make_ring_matmul``): when N divides evenly, X,
    the start block and every block of the basis are row-sharded over it
    (the Grams of DGKS, CholeskyQR² and Rayleigh–Ritz reduced over the
    shards, their factorizations computed once and broadcast), and so are
    the returned eigenvectors; otherwise they stay gathered, with a
    warning (the ring still splits every product).

    Spans (``utils/progress``): ``krylov`` (the start block and the power,
    Krylov or Chebyshev blocks with their orthogonalization), then
    ``ritz`` (the Rayleigh–Ritz products, the Ritz ``eigh``, the values'
    read and lastkeeper)."""
    basis = RECORDER.open("krylov")
    if mesh is not None and X_std.shape[0] % mesh.size:
        _LOG.warning(
            "eigensystem_streaming: N=%d not divisible by %d shards; the "
            "Krylov basis and eigenvectors stay gathered at rest (the ring "
            "matmul still row-shards every K@V product internally)",
            X_std.shape[0], mesh.size)
    n = X_std.shape[0]
    rows = mesh is not None and n % mesh.size == 0
    if rows:
        X_std = place(X_std, mesh, "row")
    neig = min(int(neig), n)
    if n >= PER_PRODUCT_PROGRESS_N:
        chunk = min(chunk, 1)
    dtype, device = X_std.dtype, X_std.device
    q, progressive = _krylov_geometry(n, neig, iters)

    if krylov is None:
        krylov = _auto_krylov(n, q, iters, X_std.element_size(),
                              device=device)
    # the package's product, or one with its signature (the ring product,
    # ``parallel/ring_kernel.make_ring_matmul``): fast_accum, init, out
    own = power_matmul is None and (
        matmul is None or getattr(matmul, "takes_fast_accum", False))
    if matmul is None:
        matmul = functools.partial(matvec.kernel_matmul, impl=impl)
    if power_matmul is None:
        power_matmul = matmul
        if not own and fast_power is True:
            _LOG.warning("eigensystem_streaming: fast_power=True is ignored "
                         "for a caller-supplied matmul")
        if own and (_resolve_fast_power(fast_power, krylov, progressive)
                    and device.type == "cuda" and dtype == torch.float32):
            power_matmul = functools.partial(matmul, fast_accum=True)
            _LOG.info(
                "eigensystem_streaming: reduced-precision (TF32) power "
                "products enabled (a flow whose Rayleigh-Ritz recomputes "
                "K.B; Rayleigh-Ritz stays full precision)")

    if start is None:
        start = start_block(n, q, dtype, device, seed)
    if tuple(start.shape) != (n, q):
        raise ValueError(f"start block must be ({n}, {q}), got "
                         f"{tuple(start.shape)}")
    V = start.to(dtype=dtype, device=device)
    # V may be the same tensor: the solve frees it with V, not at its end
    del start
    if rows:
        V = place(V, mesh, "row")
    V = _orth(V)

    def report(done, total):
        if progress is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            progress(done, total)

    if krylov and progressive:
        reuse_kb = power_matmul is matmul
        width = (iters + 1) * q
        def zeros():
            return rows_map(lambda v: v.new_zeros((v.shape[0], width)), V)

        B = zeros()
        _put(B, 0, V)
        KB = zeros() if reuse_kb else None
        g = done = 0
        while done < iters:
            steps = min(chunk, iters - done)
            V, B, KB, g = _krylov_chunk(X_std, V, B, KB, g, sigma, steps,
                                        power_matmul, reuse_kb)
            done += steps
            report(done, iters)
        ritz = functools.partial(_krylov_ritz_streaming, X_std, B, KB, V,
                                 sigma, neig, matmul, reuse_kb)
    elif krylov:
        # small n (basis width would reach n): stacked blocks + fat QR
        done = 0
        bases = []
        while done < iters:
            steps = min(chunk, iters - done)
            V, blocks = _power_chunk_blocks(X_std, V, sigma, steps,
                                            power_matmul)
            bases.append(blocks)
            done += steps
            report(done, iters)
        ritz = functools.partial(_fatqr_ritz_streaming, X_std,
                                 _hcat(bases), sigma, neig, matmul)
    else:
        # constant-memory flow: Chebyshev-filtered subspace iteration. The
        # cutoff needs no a-priori spectral bounds: each application
        # starts from the free Gram Ritz values (_cheb_app_start), and a
        # pessimistic cutoff degrades toward plain power, never below it.
        nprod = iters if iters <= 3 else max(3, iters - 2)
        step_fn = _cheb_step_fused if own else _cheb_step
        c = 0.0
        done = 0
        for d in _cheb_degrees(nprod):
            Yp, Yc, r, c = _cheb_app_start(X_std, V, c, sigma, power_matmul)
            del V           # Yp is the same block
            done += 1
            report(done, nprod)
            for _ in range(d - 1):
                Yp, Yc, r = step_fn(X_std, Yp, Yc, r, c, sigma, power_matmul)
                done += 1
                report(done, nprod)
            del Yp
            V = _orth(Yc)
            del Yc
        # Rayleigh–Ritz on the last block only, K·B at full precision
        ritz = functools.partial(_krylov_ritz_streaming, X_std, V, None, V,
                                 sigma, neig, matmul, False)
    RECORDER.close(basis)
    with span("ritz"):
        vals, vecs = ritz()
        vecs = _neg(vecs)
        count("host_reads")
        vals_np = vals.detach().cpu().numpy()
        if np.any(np.isnan(vals_np)):
            raise ValueError(_NAN_EIG_MSG)
        lastkeeper = lastkeeper_from_values(vals_np, eigtrunc)
        if rows:
            vecs = rows_map(lambda v: v[:, :lastkeeper].contiguous(), vecs)
        else:
            vecs = vecs[:, :lastkeeper]
    return Eigensystem(values_full=vals, vectors=vecs, lastkeeper=lastkeeper)
