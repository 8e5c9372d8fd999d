"""The plain float64 KRLS of ``krls.py`` in blocks, for a fit whose N×N
kernel no one device holds.

The semantics are ``krls.py``'s (its docstring); what differs is only
where the numbers live and how the spectrum is reached. It imports
nothing of the program under test. ``devices`` is a g×g grid in row
order (four cards: a 2×2; devices may repeat, as on the CPU):

* K's block (i, j), rows ``bounds[i]`` and columns ``bounds[j]``, is built
  and kept on device (i, j); no device holds K, or any other N×N matrix,
  whole. ``K @ V`` is each block times V's rows j on its device, the
  partials summed in ascending j on the first device (``home``), where
  the N-row vectors and the Krylov basis live;
* the eigenpairs: a float64 block-Krylov basis (each new block K times
  the last, orthogonalized twice against the basis) and Rayleigh-Ritz on
  it, its block wide enough that every Ritz value down to
  min(eigtrunc, 1/1000) of the largest lies in the first block with
  ``MARGIN`` to spare (else the block widens), grown until the residual
  of every kept pair (``lastkeeper``) is below ``krls.KRYLOV_RTOL`` of the
  largest value; that residual is reported (``Eig.residual``);
* bigKRLS's bounds and Neffective use every eigenvalue. The kept pairs
  are exact here; the other N - lastkeeper values enter by a Gauss
  quadrature from their exact power sums m_j = tr(R^j), j = 0..5, of the
  deflated R = K - Q diag(l) Q' (m_0 their count; tr(R^3), ||R^2||^2 and
  tr(R^5) from R^2 = R R and R^3 = R^2 R, block products in column
  stripes): the quadrature's three atoms give sum l/(l + c) over those
  values exactly wherever l/(l + c) is a polynomial of degree 5 in l,
  and to (l_max / c)^6 of it otherwise, far inside the check's limits;
* the LOO loss, coefficients and vcov come from the kept pairs, the
  fitted values and derivatives from the explicit K and
  (x_ij - x_kj) K_ik, block by block, as in ``krls.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import krls

MARGIN = 16            # Ritz values past the cut inside the first block
STRIPE = 1 << 27       # entries of one column stripe of a block product


def _grid(devices) -> List[List[torch.device]]:
    g = int(round(math.sqrt(len(devices))))
    if g * g != len(devices):
        raise ValueError(f"{len(devices)} devices make no square grid")
    return [[torch.device(devices[i * g + j]) for j in range(g)]
            for i in range(g)]


def _bounds(n: int, parts: int):
    return [(int(a[0]), int(a[-1]) + 1)
            for a in np.array_split(np.arange(n), parts)]


def _stripes(rows: int, cols: int):
    step = max(1, STRIPE // max(1, rows))
    for lo in range(0, cols, step):
        yield lo, min(cols, lo + step)


class BlockedKernel:
    """K = exp(-||x_i - x_j||^2 / sigma) in g×g blocks, block (i, j) on
    device (i, j), its diagonal exactly 1."""

    def __init__(self, X_std: np.ndarray, sigma: float, devices,
                 dtype=torch.float64):
        self.grid = _grid(devices)
        self.g = len(self.grid)
        self.home = self.grid[0][0]
        self.n = X_std.shape[0]
        self.sigma = float(sigma)
        self.dtype = dtype
        self.bounds = _bounds(self.n, self.g)
        self.X = {(i, j): torch.as_tensor(X_std[r0:r1], dtype=dtype,
                                          device=self.grid[i][j])
                  for i in range(self.g) for j in range(self.g)
                  for r0, r1 in [self.bounds[i]]}
        self.blocks: Dict[tuple, torch.Tensor] = {}
        self.build()

    def keys(self):
        return [(i, j) for i in range(self.g) for j in range(self.g)]

    def cols(self, i: int, j: int) -> torch.Tensor:
        """X's rows of column block j, on device (i, j)."""
        return self.X[(j, i)].to(self.grid[i][j])

    def build(self) -> None:
        for i, j in self.keys():
            blk = krls.kernel(self.X[(i, j)], self.cols(i, j), self.sigma)
            if i == j:
                blk.fill_diagonal_(1.0)
            self.blocks[(i, j)] = blk

    def free(self) -> None:
        self.blocks.clear()

    def rows_to_home(self, parts: Dict[tuple, torch.Tensor]) -> torch.Tensor:
        """Per-block partials of row block i summed in ascending j and
        stacked on ``home``."""
        out = []
        for i in range(self.g):
            acc = None
            for j in range(self.g):
                p = parts[(i, j)].to(self.home)
                acc = p if acc is None else acc + p
            out.append(acc)
        return torch.cat(out)

    def __matmul__(self, V: torch.Tensor) -> torch.Tensor:
        vec = V.dim() == 1
        V = V[:, None] if vec else V
        parts = {}
        for i, j in self.keys():
            c0, c1 = self.bounds[j]
            parts[(i, j)] = self.blocks[(i, j)] @ V[c0:c1].to(
                self.grid[i][j])
        out = self.rows_to_home(parts)
        return out[:, 0] if vec else out


# ---------------------------------------------------------------------------
# the eigenpairs
# ---------------------------------------------------------------------------

def eig_head(K: BlockedKernel, eigtrunc: float, seed: int = 0,
             rtol: float = krls.KRYLOV_RTOL, block: int = 256,
             first: int = 4, more: int = 2, max_blocks: int = 40):
    """(kept pairs as ``krls.Eig``, every Ritz value): the pairs down to
    ``eigtrunc`` of the largest by block Krylov and Rayleigh-Ritz, the
    block widened (to 1.25 times what is needed, in steps of 64) until
    min(eigtrunc, 1/1000) of the largest value is reached ``MARGIN``
    values inside it; a head past a quarter of N is refused."""
    n = K.n
    cap = min(eigtrunc, 1e-3)
    b = min(n, block)
    while True:
        gen = torch.Generator(device=K.home).manual_seed(seed)
        V = torch.randn(n, b, generator=gen, dtype=K.dtype, device=K.home)
        basis = [torch.linalg.qr(V).Q]
        KB = [K @ basis[0]]
        target = first
        while True:
            while len(basis) < target and (len(basis) + 1) * b <= n:
                Q = torch.cat(basis, 1)
                W = KB[-1]
                for _ in range(2):
                    W = W - Q @ (Q.T @ W)
                basis.append(torch.linalg.qr(W).Q)
                KB.append(K @ basis[-1])
            Q, KQ = torch.cat(basis, 1), torch.cat(KB, 1)
            H = Q.T @ KQ
            theta, S = torch.linalg.eigh(0.5 * (H + H.T))
            theta, S = theta.flip(0), S.flip(1)
            vals = theta.cpu().numpy()
            need = int(np.count_nonzero(vals >= cap * vals[0]))
            if need + MARGIN > b:
                b = 64 * math.ceil(1.25 * (need + MARGIN) / 64)
                if b > n // 4:
                    raise ValueError(
                        f"{need} of {n} values reach the cut: too many for "
                        "a Krylov head (krls.prepare decomposes K whole)")
                break                       # a wider block
            lk = krls.lastkeeper(vals[:b], eigtrunc)
            vecs = Q @ S[:, :lk]
            r = KQ @ S[:, :lk] - vecs * theta[None, :lk]
            res = float(torch.linalg.vector_norm(r, dim=0).max() / theta[0])
            if res < rtol or len(basis) >= max_blocks or \
                    (len(basis) + 1) * b > n:
                return krls.Eig(theta[:lk].clone(), vecs, lk, res), vals
            target = len(basis) + more
        del basis, KB, Q, KQ


def tail_moments(K: BlockedKernel, eig: krls.Eig) -> np.ndarray:
    """m_0..m_5 of the values past the kept pairs: their count and
    tr(R^j), j = 1..5, of R = K - Q diag(l) Q' (K's blocks become R's;
    ``K.build()`` makes them again)."""
    QL = eig.vectors * eig.values[None, :]
    R = K.blocks
    for i, j in K.keys():
        dev = K.grid[i][j]
        (r0, r1), (c0, c1) = K.bounds[i], K.bounds[j]
        R[(i, j)].sub_(QL[r0:r1].to(dev) @ eig.vectors[c0:c1].to(dev).T)
    C = {key: _product_block(R, R, K, *key) for key in K.keys()}
    m1 = sum(float(torch.diagonal(R[(i, i)]).sum()) for i in range(K.g))
    m2 = sum(float((R[k] * R[k]).sum()) for k in K.keys())
    m3 = sum(float((C[k] * R[k]).sum()) for k in K.keys())
    m4 = sum(float((C[k] * C[k]).sum()) for k in K.keys())
    m5 = sum(_product_block(C, R, K, *k, against=C[k]) for k in K.keys())
    del C
    K.free()
    return np.array([K.n - eig.lastkeeper, m1, m2, m3, m4, m5])


def _product_block(A, B, K: BlockedKernel, i: int, j: int, against=None):
    """Block (i, j) of A B (each a dict of K's blocks) on device (i, j),
    by column stripes of B's blocks; with ``against``, only <(A B)_ij,
    against>, the product itself never held."""
    dev = K.grid[i][j]
    rows = K.bounds[i][1] - K.bounds[i][0]
    cols = K.bounds[j][1] - K.bounds[j][0]
    out = None if against is not None else torch.zeros(
        rows, cols, dtype=K.dtype, device=dev)
    total = 0.0
    for k in range(K.g):
        a = A[(i, k)].to(dev)
        for s0, s1 in _stripes(max(rows, a.shape[1]), cols):
            part = a @ B[(k, j)][:, s0:s1].to(dev)
            if against is None:
                out[:, s0:s1] += part
            else:
                total = total + (part * against[:, s0:s1]).sum()
            del part
        del a
    return out if against is None else float(total)


def tail_atoms(m: np.ndarray):
    """(atoms, weights) of the Gauss quadrature with power sums m_0..m_5
    (Golub-Welsch from the Hankel moments, scaled by the mean value);
    three points, or two or one where the moments admit no more."""
    m = np.asarray(m, np.float64)
    if m[0] <= 0 or m[1] <= 0:
        return np.zeros(0), np.zeros(0)
    s = m[1] / m[0]
    ms = m / (m[0] * s ** np.arange(m.size))
    for k in (3, 2, 1):
        H = np.array([[ms[a + b] for b in range(k)] for a in range(k)])
        H1 = np.array([[ms[a + b + 1] for b in range(k)] for a in range(k)])
        try:
            L = np.linalg.cholesky(H)
        except np.linalg.LinAlgError:
            continue
        Li = np.linalg.inv(L)
        T = Li @ H1 @ Li.T
        atoms, V = np.linalg.eigh(0.5 * (T + T.T))
        if atoms[0] < -1e-10:
            continue
        return np.maximum(atoms, 0.0) * s, m[0] * V[0] ** 2
    return np.zeros(0), np.zeros(0)


@dataclasses.dataclass
class Spectrum:
    """The kept values exactly and the rest as quadrature atoms."""
    head: np.ndarray
    atoms: np.ndarray
    weights: np.ndarray

    def filter_sum(self, c: np.ndarray) -> np.ndarray:
        """sum l/(l + c) over every value, for each c."""
        c = np.asarray(c, np.float64)
        head = (self.head[None, :] / (self.head[None, :] + c[:, None])).sum(1)
        tail = (self.weights[None, :] * self.atoms[None, :]
                / (self.atoms[None, :] + c[:, None])).sum(1)
        return head + tail

    def upper_bound(self, n: int) -> float:
        """krls.upper_bound's walk N, N-1, ... on every value."""
        for hi in range(n, 0, -4096):
            cand = np.arange(hi, max(0, hi - 4096), -1, dtype=np.float64)
            ok = np.nonzero(self.filter_sum(cand) >= 1.0)[0]
            if ok.size:
                return float(cand[ok[0]])
        return 1.0

    def lower_bound(self, q: int) -> float:
        """krls.lower_bound's walk eps + 0.05 k on every value, q the
        1-based place of the value nearest l_1/1000."""
        for lo in range(0, 1 << 40, 4096):
            cand = krls.EPS + 0.05 * np.arange(lo, lo + 4096,
                                               dtype=np.float64)
            ok = np.nonzero(self.filter_sum(cand) <= q)[0]
            if ok.size:
                return float(cand[ok[0]])
        raise ValueError("no lower bound")


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Fit:
    """What the reference works out for one dataset, in blocks."""
    X: np.ndarray
    y: np.ndarray
    X_std: np.ndarray
    y_std: torch.Tensor          # on K.home
    x_mean: np.ndarray
    x_sd: np.ndarray
    y_mean: float
    y_sd: float
    K: BlockedKernel
    eig: krls.Eig                # the kept pairs, vectors on K.home
    spectrum: Spectrum
    spectral: krls.Spectral
    binary: np.ndarray
    lambda_: float
    L: float
    U: float
    moments: np.ndarray


def prepare(X: np.ndarray, y: np.ndarray, *, devices,
            eigtrunc: Optional[float] = None, sigma: Optional[float] = None,
            rtol: float = krls.KRYLOV_RTOL) -> Fit:
    """K's blocks, the kept eigenpairs, the completed spectrum, the
    bounds and lambda* of one dataset, with bigKRLS's defaults."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    n, p = X.shape
    sigma = float(p) if sigma is None else float(sigma)
    if eigtrunc is None:
        eigtrunc = 0.001 if n > 3000 else 0.0
    Xs, ys, xm, xsd, ym, ysd = krls.zscore(X, y)
    K = BlockedKernel(Xs, sigma, devices)
    eig, ritz = eig_head(K, eigtrunc, rtol=rtol)
    moments = tail_moments(K, eig)
    K.build()
    atoms, weights = tail_atoms(moments)
    spectrum = Spectrum(eig.values.cpu().numpy(), atoms, weights)
    q = int(np.argmin(np.abs(ritz - ritz[0] / 1000.0))) + 1
    U, L = spectrum.upper_bound(n), spectrum.lower_bound(q)
    y_std = torch.as_tensor(ys, dtype=K.dtype, device=K.home)
    spec = krls.Spectral(eig, y_std)
    lam = krls.golden(spec.loo, L, U, n / 1000.0)
    binary = np.array([np.unique(X[:, j]).size == 2 for j in range(p)])
    return Fit(X, y, Xs, y_std, xm, xsd, ym, ysd, K, eig, spectrum, spec,
               binary, lam, L, U, moments)


def neffective(f: Fit, lam: float) -> float:
    """N - sum l/(l + lambda) over every value."""
    return float(f.K.n - f.spectrum.filter_sum(np.array([lam]))[0])


def effects(f: Fit, C: torch.Tensor, cols: Sequence[int]):
    """For each column of ``C`` (N × r coefficient vectors, on home), the
    row derivatives of every column in ``cols`` in standardized units
    ((N, len(cols), r), on home), and each column's g with AME = g'c
    ((N, len(cols)), on home): ``krls._slope`` and
    ``krls._first_difference`` summed block by block."""
    K = f.K
    n, r = C.shape
    D = torch.zeros(n, len(cols), r, dtype=K.dtype, device=K.home)
    G = torch.zeros(n, len(cols), dtype=K.dtype, device=K.home)
    for t, j in enumerate(cols):
        parts, sums = {}, {}
        if f.binary[j]:
            z0, z1 = float(f.X_std[:, j].min()), float(f.X_std[:, j].max())
            delta = z1 - z0
        for i, b in K.keys():
            dev = K.grid[i][b]
            (r0, r1), (c0, c1) = K.bounds[i], K.bounds[b]
            Xi, Xb = K.X[(i, b)], K.cols(i, b)
            c = C[c0:c1].to(dev)
            d = torch.zeros(r1 - r0, r, dtype=K.dtype, device=dev)
            s = torch.zeros(c1 - c0, dtype=K.dtype, device=dev)
            for lo, hi in krls._rows(r1 - r0, c1 - c0):
                if f.binary[j]:
                    up, down = Xi[lo:hi].clone(), Xi[lo:hi].clone()
                    up[:, j], down[:, j] = z1, z0
                    Lb = (krls.kernel(up, Xb, K.sigma)
                          - krls.kernel(down, Xb, K.sigma)) / delta
                else:
                    Lb = (Xi[lo:hi, j, None] - Xb[None, :, j]) * \
                        K.blocks[(i, b)][lo:hi] * (-2.0 / K.sigma)
                d[lo:hi] = Lb @ c
                s += Lb.sum(0)
                del Lb
            parts[(i, b)], sums[(i, b)] = d, s
        D[:, t] = K.rows_to_home(parts)
        for b in range(K.g):
            c0, c1 = K.bounds[b]
            for i in range(K.g):
                G[c0:c1, t] += sums[(i, b)].to(K.home)
    return D, G / n


def outputs(f: Fit, lam: float, coeffs: np.ndarray,
            which: Optional[Sequence[int]] = None, derivative: bool = True):
    """(the reference's outputs at ``lam`` as ``krls.Outputs``, and the
    fitted values, derivatives and AMEs that follow from ``coeffs``, the
    program's coefficients), by ``krls.outputs``' and
    ``krls.from_coeffs``' definitions in one pass over K's blocks."""
    n, p = f.X.shape
    c = f.spectral.coeffs(lam)
    theirs = torch.as_tensor(np.asarray(coeffs, np.float64), dtype=c.dtype,
                             device=c.device)
    both = torch.stack([c, theirs], 1)
    fitted = f.K @ both
    yhat_std = fitted[:, 0]
    sigmasq = float(((f.y_std - yhat_std) ** 2).sum()) / n
    spectrum = sigmasq / (f.spectral.l + lam) ** 2
    neff = neffective(f, lam)
    yfitted = yhat_std.cpu().numpy() * f.y_sd + f.y_mean
    yfitted_c = fitted[:, 1].cpu().numpy() * f.y_sd + f.y_mean
    R2 = float(1.0 - np.var(f.y - yfitted, ddof=1) / f.y_sd ** 2)
    out = krls.Outputs(lam, f.spectral.loo(lam) * f.y_sd, neff,
                       c.cpu().numpy(), yfitted, R2, None, None, None, None,
                       None, spectrum)
    if not derivative:
        return out, (yfitted_c, None, None)
    cols = list(range(p)) if which is None else list(which)
    D, G = effects(f, both, cols)
    qg = f.spectral.Q.T @ G
    factor = torch.as_tensor(np.where(f.binary[cols], 2.0, 1.0),
                             dtype=qg.dtype, device=qg.device)
    var = (factor * (spectrum[:, None] * qg * qg).sum(0)).cpu().numpy()
    ratio = f.y_sd / f.x_sd[cols]
    D = D.cpu().numpy() * ratio[None, :, None]
    var = var * ratio ** 2
    ame = D[:, :, 0].mean(0)
    se = np.sqrt(var)
    out.derivatives, out.avgderivatives = D[:, :, 0], ame
    out.var_avgderivatives, out.se = var, se
    out.pvalues = krls.pvalues(ame / se, neff - p)
    return out, (yfitted_c, D[:, :, 1], D[:, :, 1].mean(0))
