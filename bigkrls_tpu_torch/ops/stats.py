"""Standardization, effective sample sizes and the Student-t tail.

Port of ``bigkrls_tpu/ops/stats.py``. torch has no regularized incomplete
beta function, so the t tail is computed on the host with
``scipy.special.betainc`` (the JAX package uses
``jax.scipy.special.betainc``).
"""
from __future__ import annotations

import numpy as np
import scipy.special
import torch


def col_sd(X, dim=0):
    """R's sample standard deviation (ddof=1)."""
    return torch.std(X, dim=dim, correction=1)


def standardize(X, y):
    """Column z-scoring of X and y with ddof=1.

    Returns (X_std, y_std, x_means, x_sds, y_mean, y_sd)."""
    x_means = torch.mean(X, dim=0)
    x_sds = col_sd(X)
    X_std = (X - x_means[None, :]) / x_sds[None, :]
    y_mean = torch.mean(y)
    y_sd = col_sd(y)
    y_std = (y - y_mean) / y_sd
    return X_std, y_std, x_means, x_sds, y_mean, y_sd


def neffective_spectral(values_full, lambda_, n: int) -> float:
    """N − Σ λₖ/(λₖ+λ) over the full eigenvalue list."""
    return float(n - torch.sum(values_full / (values_full + lambda_)))


def auto_acf_block(n: int, itemsize: int, budget: int,
                   fraction: float = 0.25) -> int:
    """Slab width for the blocked acf statistic: ``fraction`` of the
    memory budget over the (N, block) Gram slab and its |·| image,
    floored at 256 and capped at 4096."""
    max_block = int(fraction * budget / (2 * n * itemsize))
    return max(256, min(4096, (max_block // 256) * 256))


def _normalized_rows(X_std):
    Z = X_std - torch.mean(X_std, dim=1, keepdim=True)
    return Z / torch.sqrt(torch.sum(Z * Z, dim=1, keepdim=True))


def neffective_acf(X_std, block: int = 0) -> float:
    """Autocorrelation-based effective N (``src/Neffective.cpp:13-76``):
    rows de-meaned over P and scaled to unit norm, r = Σ_{i<j}|zᵢ·zⱼ|,
    Neff = N(1 − 2r/N²) + 1. Above 8192 rows (or with ``block``) the Gram
    is streamed in (N, block) slabs sized to the device's memory."""
    n = X_std.shape[0]
    if block == 0 and n > 8192:
        if X_std.device.type == "cuda":
            budget = torch.cuda.mem_get_info(X_std.device)[1]
        else:
            budget = 8 << 30
        block = auto_acf_block(n, X_std.element_size(), budget)
    Z = _normalized_rows(X_std)
    if block and n > block:
        total = sum(float(torch.sum(torch.abs(Z @ Z[lo:lo + block].T)))
                    for lo in range(0, n, block))
    else:
        total = float(torch.sum(torch.abs(Z @ Z.T)))
    r = 0.5 * (total - n)
    mapc = 2.0 * r / (float(n) * float(n))
    return n * (1.0 - mapc) + 1.0


def t_sf(t, df):
    """Upper-tail survival function of Student's t, P(T > t), via
    P(T>t) = ½ I_x(ν/2, ½) with x = ν/(ν+t²) (R's ``pt(t, df,
    lower.tail=FALSE)``). Host numpy in, numpy out."""
    t = np.asarray(t, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    x = df / (df + t * t)
    p = 0.5 * scipy.special.betainc(df / 2.0, 0.5, x)
    return np.where(t >= 0, p, 1.0 - p)


def two_sided_p(t, df):
    """2·P(T > |t|), the AME p-value (``R/bigKRLS.R:727``)."""
    return 2.0 * t_sf(np.abs(np.asarray(t, dtype=np.float64)), df)
