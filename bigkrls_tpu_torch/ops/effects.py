"""Pointwise marginal effects and AME variances, all columns at once.

Port of ``bigkrls_tpu/ops/effects.py`` (its docstring derives the
identities). Everything the derivative step needs from the
kernel is K @ V for the stacked right-hand side

    V = [ c | 1 | X∘c | X | B∘c | B ]        (N, 2+4P)

(B = per-column max-level indicators for the binary first differences),
one multi-RHS product. On the dense path that product is a plain
``torch.matmul``, as the JAX package leaves it to XLA; on the kernel-free
path it is one call of ``ops/matvec.kernel_matmul``.

On a mesh (``parallel/sharded.py``) X, c, Q, the stacked right-hand side,
its product and the derivatives are row-sharded alike: the product is the
block product (or the ring product), the derivatives are assembled shard
by shard, and the AME variances' Qᵀs and Qᵀh are reduced over the shards.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.sharded import gram, rows_map
from ..utils.progress import count


class DerivativesResult(NamedTuple):
    derivatives: torch.Tensor    # (N, P_est) standardized units
    var_avgderiv: torch.Tensor   # (P_est,) standardized units
    yfitted_std: torch.Tensor    # K @ coeffs, the first column's product


def _binary_geometry(X_std, binary_mask, z0, z1):
    delta = torch.where(binary_mask, z1 - z0, torch.ones_like(z1))
    B = rows_map(lambda x, z, d: (x >= (z[None, :] - 0.5 * d[None, :]))
                 .to(x.dtype), X_std, z1, delta)
    return delta, B


def _rhs_stack(X_std, coeffs, B):
    """V = [c | 1 | X∘c | X | B∘c | B], shape (N, 2+4P)."""
    def stack(x, cf, b):
        c = cf[:, None]
        return torch.cat([c, torch.ones_like(c), x * c, x, b * c, b], dim=1)
    return rows_map(stack, X_std, coeffs, B)


def _from_products(Y, X_std, coeffs, Q, spectrum, sigma: float, binary_mask,
                   delta, B):
    """Assemble derivatives + AME variances from Y = K @ V."""
    n, p = X_std.shape
    n2 = float(n) * float(n)
    phi = -(delta * delta) / sigma
    e_phi = torch.exp(phi)
    e_mphi = torch.exp(-phi)

    def rows(Y, X_std, B, binary_mask, delta, phi, e_phi, e_mphi):
        Kc = Y[:, 0]
        K1 = Y[:, 1]
        KXc = Y[:, 2:2 + p]
        KX = Y[:, 2 + p:2 + 2 * p]
        KBc = Y[:, 2 + 2 * p:2 + 3 * p]
        KB = Y[:, 2 + 3 * p:2 + 4 * p]
        # continuous columns
        deriv_cont = (-2.0 / sigma) * (X_std * Kc[:, None] - KXc)
        s_cont = X_std * K1[:, None] - KX
        # binary columns (masked)
        same = B * KBc + (1.0 - B) * (Kc[:, None] - KBc)
        diff = Kc[:, None] - same
        mix = e_phi[None, :] * same + e_mphi[None, :] * diff
        sign = 2.0 * B - 1.0
        deriv_bin = (sign / delta[None, :]) * (Kc[:, None] - mix)
        u = torch.exp(phi[None, :] * (1.0 - 2.0 * B))
        h = (u - 1.0) * (K1[:, None] - KB) - (1.0 / u - 1.0) * KB
        derivatives = torch.where(binary_mask[None, :], deriv_bin,
                                  deriv_cont)
        return derivatives, s_cont, h, Kc

    derivatives, s_cont, h, Kc = rows_map(rows, Y, X_std, B, binary_mask,
                                          delta, phi, e_phi, e_mphi)
    Qts = gram(Q, s_cont)
    var_cont = (4.0 / (sigma * sigma) / n2) * torch.sum(
        spectrum[:, None] * Qts * Qts, dim=0)
    Qth = gram(Q, h)
    var_bin = (2.0 / (delta * delta) / n2) * torch.sum(
        spectrum[:, None] * Qth * Qth, dim=0)
    var_avg = torch.where(binary_mask, var_bin, var_cont)
    return DerivativesResult(derivatives, var_avg, Kc)


def derivatives_all(X_std, K, coeffs, Q, spectrum, sigma: float, binary_mask,
                    z0, z1) -> DerivativesResult:
    """Dense-kernel path: one K @ V multi-RHS product, then assembly. K
    may be block-sharded over a mesh, with X_std, coeffs and Q row-sharded
    over its axis "i": the product is then the block product
    (``parallel/sharded.py``) and the result row-sharded.

    ``X_std`` (N, P_est) is already subset to the estimated columns;
    ``spectrum`` is the Var(c) spectral diagonal σ̂²/(λₖ+λ)²;
    ``binary_mask`` marks the first-difference columns and ``z0``/``z1``
    are their standardized min/max."""
    delta, B = _binary_geometry(X_std, binary_mask, z0, z1)
    Y = K @ _rhs_stack(X_std, coeffs, B)
    return _from_products(Y, X_std, coeffs, Q, spectrum, float(sigma),
                          binary_mask, delta, B)


def derivatives_streaming(X_full, cols, coeffs, Q, spectrum, sigma: float,
                          binary_mask, z0, z1, matmul) -> DerivativesResult:
    """Kernel-free path: the same assembly, with the product computed by
    ``matmul(X, V, sigma)`` (``ops/matvec.kernel_matmul``), which rebuilds
    K tile by tile from the full standardized ``X_full`` (N, P). ``cols``
    are the estimated columns; ``binary_mask``, ``z0`` and ``z1`` refer to
    them. The result's ``yfitted_std`` is the product's first column,
    K·c, so the fit needs no separate product for ŷ."""
    X_sel = rows_map(lambda x: x[:, list(cols)], X_full)
    count("host_reads")      # the index list's copy to the device
    delta, B = _binary_geometry(X_sel, binary_mask, z0, z1)
    Y = matmul(X_full, _rhs_stack(X_sel, coeffs, B), sigma)
    return _from_products(Y, X_sel, coeffs, Q, spectrum, float(sigma),
                          binary_mask, delta, B)
