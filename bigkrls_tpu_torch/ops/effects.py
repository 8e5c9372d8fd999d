"""Pointwise marginal effects and AME variances, all columns at once.

Port of the dense half of ``bigkrls_tpu/ops/effects.py`` (its docstring
derives the identities). Everything the derivative step needs from the
kernel is K @ V for the stacked right-hand side

    V = [ c | 1 | X∘c | X | B∘c | B ]        (N, 2+4P)

(B = per-column max-level indicators for the binary first differences),
one multi-RHS product. On the dense path that product is a plain
``torch.matmul``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DerivativesResult(NamedTuple):
    derivatives: torch.Tensor    # (N, P_est) standardized units
    var_avgderiv: torch.Tensor   # (P_est,) standardized units
    yfitted_std: torch.Tensor    # K @ coeffs, the first column's product


def _binary_geometry(X_std, binary_mask, z0, z1):
    delta = torch.where(binary_mask, z1 - z0, torch.ones_like(z1))
    B = (X_std >= (z1[None, :] - 0.5 * delta[None, :])).to(X_std.dtype)
    return delta, B


def _rhs_stack(X_std, coeffs, B):
    """V = [c | 1 | X∘c | X | B∘c | B], shape (N, 2+4P)."""
    c = coeffs[:, None]
    ones = torch.ones_like(c)
    return torch.cat([c, ones, X_std * c, X_std, B * c, B], dim=1)


def _from_products(Y, X_std, coeffs, Q, spectrum, sigma: float, binary_mask,
                   delta, B):
    """Assemble derivatives + AME variances from Y = K @ V."""
    n, p = X_std.shape
    Kc = Y[:, 0]
    K1 = Y[:, 1]
    KXc = Y[:, 2:2 + p]
    KX = Y[:, 2 + p:2 + 2 * p]
    KBc = Y[:, 2 + 2 * p:2 + 3 * p]
    KB = Y[:, 2 + 3 * p:2 + 4 * p]
    n2 = float(n) * float(n)

    # continuous columns
    deriv_cont = (-2.0 / sigma) * (X_std * Kc[:, None] - KXc)
    s_cont = X_std * K1[:, None] - KX
    Qts = Q.T @ s_cont
    var_cont = (4.0 / (sigma * sigma) / n2) * torch.sum(
        spectrum[:, None] * Qts * Qts, dim=0)

    # binary columns (masked)
    phi = -(delta * delta) / sigma
    e_phi = torch.exp(phi)
    e_mphi = torch.exp(-phi)
    same = B * KBc + (1.0 - B) * (Kc[:, None] - KBc)
    diff = Kc[:, None] - same
    mix = e_phi[None, :] * same + e_mphi[None, :] * diff
    sign = 2.0 * B - 1.0
    deriv_bin = (sign / delta[None, :]) * (Kc[:, None] - mix)

    u = torch.exp(phi[None, :] * (1.0 - 2.0 * B))
    h = (u - 1.0) * (K1[:, None] - KB) - (1.0 / u - 1.0) * KB
    Qth = Q.T @ h
    var_bin = (2.0 / (delta * delta) / n2) * torch.sum(
        spectrum[:, None] * Qth * Qth, dim=0)

    derivatives = torch.where(binary_mask[None, :], deriv_bin, deriv_cont)
    var_avg = torch.where(binary_mask, var_bin, var_cont)
    return DerivativesResult(derivatives, var_avg, Kc)


def derivatives_all(X_std, K, coeffs, Q, spectrum, sigma: float, binary_mask,
                    z0, z1) -> DerivativesResult:
    """Dense-kernel path: one K @ V multi-RHS product, then assembly.

    ``X_std`` (N, P_est) is already subset to the estimated columns;
    ``spectrum`` is the Var(c) spectral diagonal σ̂²/(λₖ+λ)²;
    ``binary_mask`` marks the first-difference columns and ``z0``/``z1``
    are their standardized min/max."""
    delta, B = _binary_geometry(X_std, binary_mask, z0, z1)
    Y = K @ _rhs_stack(X_std, coeffs, B)
    return _from_products(Y, X_std, coeffs, Q, spectrum, float(sigma),
                          binary_mask, delta, B)
