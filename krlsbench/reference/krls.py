"""A plain float64 KRLS, written from the reference's definitions.

This is the yardstick that decides ``correct``. It imports nothing of the
program under test and takes nothing the program made: it standardizes
the generated X and y itself, builds K itself, decomposes it itself and
works out every output from its definition, in float64 torch on whatever
device it is given (the card, after the program's state is freed; the CPU
in the tests).

The semantics are bigKRLS's (``R/bigKRLS.R``, ``R/bigKRLS_Rcpp_functions.R``,
``src/bigderiv_v3.cpp``):

* X and y are z-scored with ddof = 1; K = exp(-||x_i - x_j||^2 / sigma);
* eigenpairs descending; ``lastkeeper`` is the last index whose value is
  at least ``eigtrunc`` times the first, applied to the vectors only; the
  lambda bounds and Neffective use every computed value;
* U is the largest of N, N-1, ... with sum l/(l+U) >= 1; L = eps + 0.05 k
  for the smallest k with sum l/(l+L) <= q, q the 1-based position of the
  value nearest l_1/1000; the golden-section search uses 0.381966, stops
  at |S1 - S2| <= tol = N/1000 and returns X1 if S1 < S2 else X2;
* the LOO loss is sum_i (c_i / G_ii)^2 over the truncated pairs, with
  c = Q (Q'y / (l + lambda)) and G_ii = sum_k Q_ik^2 / (l_k + lambda);
  the model's ``looe`` is that loss times sd(y);
* yhat = K c over the whole K; sigma^2 = ||y - yhat||^2 / N (standardized);
  Var(c) = sigma^2 Q diag(1/(l + lambda)^2) Q';
* a continuous column's derivative at row i is
  (-2/sigma) sum_k (x_ij - x_kj) K_ik c_k; a binary column's (two distinct
  values) is the first difference (yhat_i with x_ij at its max minus with
  it at its min) over the distance between them;
* the AME is the mean derivative and its variance g' Var(c) g for the g
  with AME = g'c; for a binary column the reference doubles it
  (``bigderiv_v3.cpp``'s accumulation, kept for parity);
* derivatives and their variances are rescaled by sd(y)/sd(x_j);
* summary: SE = sqrt(var), t = AME/SE, p = 2 P(T > |t|) with Neffective - P
  degrees of freedom;
* predict: new rows z-scored by the training moments, yhat = K_new c, and
  SE = sqrt(sqrt(N/Neff) sd(y)^2 diag(K_new Var(c) K_new')), the
  reference's correct_SE quirk.

A truncated eigensystem (``neig`` < N) comes from a block-Krylov basis in
float64 and Rayleigh-Ritz on it, grown until the residual of every kept
Ritz pair is below ``KRYLOV_RTOL`` of the largest value; its residual is
reported with the result, so a reference that did not converge shows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import scipy.stats
import torch

GOLD = 0.381966
EPS = 2.220446049250313e-16          # R's .Machine$double.eps
KRYLOV_RTOL = 1e-9                    # float64; 1e-5 in float32
ROW_BLOCK_ELEMS = 1 << 27             # entries of one block of K's rows


def _rows(n: int, width: int):
    step = max(1, ROW_BLOCK_ELEMS // max(1, width))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def zscore(X: np.ndarray, y: np.ndarray):
    """(X_std, y_std, x_mean, x_sd, y_mean, y_sd) with ddof = 1, float64."""
    x_mean, x_sd = X.mean(0), X.std(0, ddof=1)
    y_mean, y_sd = float(y.mean()), float(y.std(ddof=1))
    return (X - x_mean) / x_sd, (y - y_mean) / y_sd, x_mean, x_sd, \
        y_mean, y_sd


def kernel(A: torch.Tensor, B: torch.Tensor, sigma: float,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """exp(-||a_i - b_j||^2 / sigma), built in blocks of rows."""
    out = A.new_empty((A.shape[0], B.shape[0])) if out is None else out
    bb = (B * B).sum(1)
    for lo, hi in _rows(A.shape[0], B.shape[0]):
        a = A[lo:hi]
        d2 = (a * a).sum(1)[:, None] + bb[None, :] - 2.0 * (a @ B.T)
        torch.exp(-d2.clamp_min_(0.0) / sigma, out=out[lo:hi])
    return out


@dataclasses.dataclass
class Eig:
    values: torch.Tensor      # every computed value, descending
    vectors: torch.Tensor     # the first ``lastkeeper`` vectors
    lastkeeper: int
    residual: float           # max ||K v - l v|| / l_1 over the kept pairs


def lastkeeper(values: np.ndarray, eigtrunc: float) -> int:
    keep = np.nonzero(values >= eigtrunc * values[0])[0]
    return 1 if keep.size == 0 else int(keep.max()) + 1


def _residual(K, vals, vecs) -> float:
    r = K @ vecs - vecs * vals[None, :]
    return float(torch.linalg.vector_norm(r, dim=0).max() / vals[0])


def eig_full(K: torch.Tensor, eigtrunc: float) -> Eig:
    vals, vecs = torch.linalg.eigh(K)
    vals, vecs = vals.flip(0), vecs.flip(1)
    lk = lastkeeper(vals.cpu().numpy(), eigtrunc)
    vecs = vecs[:, :lk].contiguous()
    return Eig(vals, vecs, lk, _residual(K, vals[:lk], vecs))


def eig_top(K: torch.Tensor, neig: int, eigtrunc: float, seed: int = 0,
            block: Optional[int] = None, first: int = 6, more: int = 3,
            max_blocks: int = 24) -> Eig:
    """The ``neig`` largest eigenpairs of K by a float64 block-Krylov
    basis (each new block K times the last, orthogonalized twice against
    the basis) and Rayleigh-Ritz on ``first`` blocks, then on ``more``
    blocks more at a time until every kept pair's residual is below
    ``KRYLOV_RTOL`` of the largest value (at most ``max_blocks``)."""
    n = K.shape[0]
    rtol = KRYLOV_RTOL if K.dtype == torch.float64 else 1e-5
    b = block or min(n, neig + max(16, neig // 10))
    gen = torch.Generator(device=K.device).manual_seed(seed)
    V = torch.randn(n, b, generator=gen, dtype=K.dtype, device=K.device)
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
        theta, S = theta.flip(0)[:neig], S.flip(1)[:, :neig]
        lk = lastkeeper(theta.cpu().numpy(), eigtrunc)
        vecs = Q @ S[:, :lk]
        r = KQ @ S[:, :lk] - vecs * theta[None, :lk]
        res = float(torch.linalg.vector_norm(r, dim=0).max() / theta[0])
        if res < rtol or len(basis) >= max_blocks or \
                (len(basis) + 1) * b > n:
            return Eig(theta, vecs, lk, res)
        target = len(basis) + more


def _filter_sum(values: np.ndarray, lam: np.ndarray) -> np.ndarray:
    return (values[None, :] / (values[None, :] + lam[:, None])).sum(1)


def upper_bound(values: np.ndarray, n: int) -> float:
    """The largest U in N, N-1, ..., 1 with sum l/(l+U) >= 1 (each step
    of the reference's loop evaluated; 1 where none holds)."""
    for hi in range(n, 0, -4096):
        cand = np.arange(hi, max(0, hi - 4096), -1, dtype=np.float64)
        ok = np.nonzero(_filter_sum(values, cand) >= 1.0)[0]
        if ok.size:
            return float(cand[ok[0]])
    return 1.0


def lower_bound(values: np.ndarray) -> float:
    """L = eps + 0.05 k for the smallest k >= 0 with sum l/(l+L) <= q."""
    q = int(np.argmin(np.abs(values - values.max() / 1000.0))) + 1
    for lo in range(0, 1 << 40, 4096):
        cand = EPS + 0.05 * np.arange(lo, lo + 4096, dtype=np.float64)
        ok = np.nonzero(_filter_sum(values, cand) <= q)[0]
        if ok.size:
            return float(cand[ok[0]])
    raise ValueError("no lower bound")


class Spectral:
    """Solves on the truncated pairs: c(lambda), G_ii(lambda), LOO."""

    def __init__(self, eig: Eig, y_std: torch.Tensor):
        self.Q = eig.vectors
        self.l = eig.values[: eig.lastkeeper]
        self.Qty = self.Q.T @ y_std
        self.Q2 = self.Q * self.Q

    def coeffs(self, lam: float) -> torch.Tensor:
        return self.Q @ (self.Qty / (self.l + lam))

    def loo(self, lam: float) -> float:
        g = self.Q2 @ (1.0 / (self.l + lam))
        return float(((self.coeffs(lam) / g) ** 2).sum())


def golden(loo, L: float, U: float, tol: float) -> float:
    X1 = L + GOLD * (U - L)
    X2 = U - GOLD * (U - L)
    S1, S2 = loo(X1), loo(X2)
    it = 0
    while abs(S1 - S2) > tol and it < 10_000:
        if S1 < S2:
            U, X2 = X2, X1
            X1 = L + GOLD * (U - L)
            S2, S1 = S1, loo(X1)
        else:
            L, X1 = X1, X2
            X2 = U - GOLD * (U - L)
            S1, S2 = S2, loo(X2)
        it += 1
    return X1 if S1 < S2 else X2


@dataclasses.dataclass
class Fit:
    """What the reference works out for one dataset."""
    X: np.ndarray
    y: np.ndarray
    X_std: torch.Tensor
    y_std: torch.Tensor
    x_mean: np.ndarray
    x_sd: np.ndarray
    y_mean: float
    y_sd: float
    sigma: float
    K: torch.Tensor
    eig: Eig
    spectral: Spectral
    binary: np.ndarray
    lambda_: float           # the reference's own lambda*
    L: float
    U: float


def prepare(X: np.ndarray, y: np.ndarray, *, neig: Optional[int] = None,
            eigtrunc: Optional[float] = None, sigma: Optional[float] = None,
            device="cpu", dtype=torch.float64) -> Fit:
    """K, the eigensystem, the bounds and lambda* of one dataset, with
    bigKRLS's defaults (sigma = P, eigtrunc 0.001 above N = 3000).
    ``dtype`` float32 gives the control, the same arithmetic a precision
    lower."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    n, p = X.shape
    sigma = float(p) if sigma is None else float(sigma)
    if eigtrunc is None:
        eigtrunc = 0.001 if n > 3000 else 0.0
    neig = n if neig is None else min(n, int(neig))
    Xs, ys, xm, xsd, ym, ysd = zscore(X, y)
    dev = torch.device(device)
    X_std = torch.as_tensor(Xs, dtype=dtype, device=dev)
    y_std = torch.as_tensor(ys, dtype=dtype, device=dev)
    K = kernel(X_std, X_std, sigma)
    K.fill_diagonal_(1.0)
    eig = eig_full(K, eigtrunc) if neig >= n else eig_top(K, neig, eigtrunc)
    vals = eig.values.cpu().numpy()
    U, L = upper_bound(vals, n), lower_bound(vals)
    spec = Spectral(eig, y_std)
    lam = golden(spec.loo, L, U, n / 1000.0)
    binary = np.array([np.unique(X[:, j]).size == 2 for j in range(p)])
    return Fit(X, y, X_std, y_std, xm, xsd, ym, ysd, sigma, K, eig, spec,
               binary, lam, L, U)


@dataclasses.dataclass
class Outputs:
    """The fit's outputs at one lambda, in the model's units."""
    lambda_: float
    looe: float
    neffective: float
    coeffs: np.ndarray
    yfitted: np.ndarray
    R2: float
    derivatives: Optional[np.ndarray]
    avgderivatives: Optional[np.ndarray]
    var_avgderivatives: Optional[np.ndarray]
    se: Optional[np.ndarray]
    pvalues: Optional[np.ndarray]
    vcov_spectrum: torch.Tensor   # sigma^2 / (l + lambda)^2, standardized


def outputs(f: Fit, lam: float, which: Optional[Sequence[int]] = None,
            derivative: bool = True) -> Outputs:
    """Every output of a fit at ``lam`` (the program's lambda*, to judge
    what follows from it; or ``f.lambda_``)."""
    n, p = f.X.shape
    c = f.spectral.coeffs(lam)
    yhat_std = f.K @ c
    sigmasq = float(((f.y_std - yhat_std) ** 2).sum()) / n
    spectrum = sigmasq / (f.spectral.l + lam) ** 2
    neff = float(n - (f.eig.values / (f.eig.values + lam)).sum())
    yfitted = yhat_std.cpu().numpy() * f.y_sd + f.y_mean
    R2 = float(1.0 - np.var(f.y - yfitted, ddof=1) / f.y_sd ** 2)
    out = Outputs(lam, f.spectral.loo(lam) * f.y_sd, neff, c.cpu().numpy(),
                  yfitted, R2, None, None, None, None, None, spectrum)
    if not derivative:
        return out
    cols = list(range(p)) if which is None else list(which)
    D = np.empty((n, len(cols)))
    var = np.empty(len(cols))
    Q = f.spectral.Q
    for k, j in enumerate(cols):
        if f.binary[j]:
            d, g = _first_difference(f, c, j)
            factor = 2.0
        else:
            d, g = _slope(f, c, j)
            factor = 1.0
        qg = Q.T @ g
        var[k] = factor * float((spectrum * qg * qg).sum())
        D[:, k] = d.cpu().numpy()
    ratio = f.y_sd / f.x_sd[cols]
    D *= ratio[None, :]
    var *= ratio ** 2
    ame = D.mean(0)
    se = np.sqrt(var)
    t = ame / se
    out.derivatives, out.avgderivatives = D, ame
    out.var_avgderivatives, out.se = var, se
    out.pvalues = pvalues(t, neff - p)
    return out


def pvalues(t, df: float) -> np.ndarray:
    """Two-sided p-values of t statistics with ``df`` degrees of freedom."""
    return 2.0 * scipy.stats.t.sf(np.abs(np.asarray(t, np.float64)), df)


def _slope(f: Fit, c: torch.Tensor, j: int):
    """Row derivatives (-2/sigma) sum_k (x_ij - x_kj) K_ik c_k and the g
    with AME = g'c, from the explicit (x_ij - x_kj) K_ik, by row blocks."""
    n = f.K.shape[0]
    x = f.X_std[:, j]
    d = torch.empty_like(x)
    colsum = torch.zeros_like(x)
    for lo, hi in _rows(n, n):
        Lb = (x[lo:hi, None] - x[None, :]) * f.K[lo:hi]
        d[lo:hi] = Lb @ c
        colsum += Lb.sum(0)
    scale = -2.0 / f.sigma
    return scale * d, (scale / n) * colsum


def _first_difference(f: Fit, c: torch.Tensor, j: int):
    """yhat with x_j at its max minus with it at its min, over their
    distance, row by row; and the g with AME = g'c."""
    n = f.K.shape[0]
    z0, z1 = float(f.X_std[:, j].min()), float(f.X_std[:, j].max())
    delta = z1 - z0
    d = torch.empty_like(c)
    colsum = torch.zeros_like(c)
    for lo, hi in _rows(n, n):
        hi_rows, lo_rows = f.X_std[lo:hi].clone(), f.X_std[lo:hi].clone()
        hi_rows[:, j], lo_rows[:, j] = z1, z0
        diff = kernel(hi_rows, f.X_std, f.sigma) - \
            kernel(lo_rows, f.X_std, f.sigma)
        d[lo:hi] = diff @ c
        colsum += diff.sum(0)
    return d / delta, colsum / (n * delta)


def from_coeffs(f: Fit, coeffs: np.ndarray,
                which: Optional[Sequence[int]] = None,
                derivative: bool = True):
    """What follows from a given coefficient vector, by the definitions
    above with the reference's own K and X: (fitted values, derivatives,
    AMEs) in the model's units. The check passes the program's
    coefficients, to judge each later stage on its own input."""
    n, p = f.X.shape
    c = torch.as_tensor(coeffs, dtype=f.K.dtype, device=f.K.device)
    yfitted = (f.K @ c).cpu().numpy() * f.y_sd + f.y_mean
    if not derivative:
        return yfitted, None, None
    cols = list(range(p)) if which is None else list(which)
    D = np.empty((n, len(cols)))
    for k, j in enumerate(cols):
        d = _first_difference(f, c, j)[0] if f.binary[j] else \
            _slope(f, c, j)[0]
        D[:, k] = d.cpu().numpy() * (f.y_sd / f.x_sd[j])
    return yfitted, D, D.mean(0)


def predict_from_coeffs(f: Fit, coeffs: np.ndarray,
                        newdata: np.ndarray) -> np.ndarray:
    """Predictions of new rows from a given coefficient vector."""
    new_std = (np.asarray(newdata, np.float64) - f.x_mean) / f.x_sd
    Kn = kernel(torch.as_tensor(new_std, dtype=f.K.dtype,
                                device=f.K.device), f.X_std, f.sigma)
    c = torch.as_tensor(coeffs, dtype=f.K.dtype, device=f.K.device)
    return (Kn @ c).cpu().numpy() * f.y_sd + f.y_mean


def predict(f: Fit, out: Outputs, newdata: np.ndarray):
    """(yhat, se) for new rows, in the model's units."""
    new_std = (np.asarray(newdata, np.float64) - f.x_mean) / f.x_sd
    Kn = kernel(torch.as_tensor(new_std, dtype=f.K.dtype,
                                device=f.K.device), f.X_std, f.sigma)
    c = torch.as_tensor(out.coeffs, dtype=f.K.dtype, device=f.K.device)
    yhat = (Kn @ c).cpu().numpy() * f.y_sd + f.y_mean
    QtK = f.spectral.Q.T @ Kn.T
    corr = math.sqrt(f.X.shape[0] / out.neffective)
    quad = (out.vcov_spectrum[:, None] * QtK * QtK).sum(0)
    se = np.sqrt(corr * f.y_sd ** 2 * quad.cpu().numpy())
    return yhat, se
