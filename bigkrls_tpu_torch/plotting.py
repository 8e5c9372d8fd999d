"""Marginal-effects visualization, ported from ``bigkrls_tpu/plotting.py``
(numpy only; ``matplotlib`` is imported by ``plot_effects`` when called,
and is not needed for anything else) — the notebook/script replacement for
the reference's Shiny app (``shiny.bigKRLS``, ``R/bigKRLS.R:1041-1114``).

The reference app scatters pointwise derivatives dy/dxₚ against any xₚ with
a loess smoother and a horizontal reference line; ``plot_effects`` renders
the same view (all requested pairs, or one) with matplotlib, using a local
quadratic smoother in place of loess.  ``export_effects`` mirrors the app's
``export=TRUE`` mode (``:1098-1110``): it strips the N×N matrices and
writes a small portable bundle for sharing.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .types import KRLSModel


def _loess_like(x: np.ndarray, y: np.ndarray, frac: float = 0.4,
                num: int = 80) -> tuple:
    """Lightweight local-quadratic smoother (tricube weights), standing in
    for R's loess in the reference plot (``R/bigKRLS.R:1069``)."""
    order = np.argsort(x)
    xs, ys = x[order], y[order]
    grid = np.linspace(xs[0], xs[-1], num)
    n = len(xs)
    k = max(int(frac * n), 5)
    out = np.empty(num)
    for g, x0 in enumerate(grid):
        d = np.abs(xs - x0)
        idx = np.argpartition(d, min(k, n - 1))[:k]
        dmax = d[idx].max() or 1.0
        w = (1 - (d[idx] / dmax) ** 3) ** 3
        A = np.stack([np.ones(k), xs[idx] - x0, (xs[idx] - x0) ** 2], axis=1)
        W = w[:, None]
        beta, *_ = np.linalg.lstsq(A * W, ys[idx] * w, rcond=None)
        out[g] = beta[0]
    return grid, out


def plot_effects(
    model: KRLSModel,
    dydx: Optional[int] = None,
    x: Optional[int] = None,
    labs: Optional[Sequence[str]] = None,
    hline: float = 0.0,
    save_to: Optional[str] = None,
):
    """Scatter pointwise marginal effects against a predictor.

    ``dydx``/``x``: 0-based column indices; ``None`` plots every estimated
    derivative against its own x (the common diagonal of the Shiny app's
    dropdown grid).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if model.derivatives is None:
        raise ValueError("fit with derivative=True to plot marginal effects")
    which = (model.which_derivatives if model.which_derivatives is not None
             else list(range(model.p)))
    labels = list(labs) if labs is not None else list(model.xlabs)

    if dydx is not None:
        pairs = [(dydx, x if x is not None else which[dydx])]
    else:
        pairs = [(d, col) for d, col in enumerate(which)]

    ncol = min(3, len(pairs))
    nrow = (len(pairs) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(5 * ncol, 3.6 * nrow),
                             squeeze=False)
    for ax in axes.flat[len(pairs):]:
        ax.axis("off")
    for (d, col), ax in zip(pairs, axes.flat):
        xv = np.asarray(model.X[:, col], dtype=np.float64)
        dv = np.asarray(model.derivatives[:, d], dtype=np.float64)
        ax.scatter(xv, dv, s=4, alpha=0.5, color="#888888", linewidths=0)
        if np.unique(xv).size > 2:
            gx, gy = _loess_like(xv, dv)
            ax.plot(gx, gy, color="#2166ac", lw=2)
        ax.axhline(hline, color="black", lw=0.8)
        ax.set_xlabel(labels[col])
        ax.set_ylabel(f"dy/d {labels[which[d]]}")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
        plt.close(fig)
        return save_to
    return fig


def export_effects(model: KRLSModel, path: str) -> str:
    """Portable bundle without N×N matrices (ref ``export=TRUE``,
    ``R/bigKRLS.R:1098-1110``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        X=model.X, derivatives=model.derivatives,
        avgderivatives=model.avgderivatives,
        var_avgderivatives=model.var_avgderivatives,
        xlabs=np.asarray(model.xlabs),
        which_derivatives=np.asarray(
            model.which_derivatives
            if model.which_derivatives is not None else range(model.p)),
    )
    return path
