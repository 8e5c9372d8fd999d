"""Reducibility test: are average marginal effects sufficient summaries?

Ported from ``bigkrls_tpu/reducibility.py`` (numpy only, unchanged), itself
a port of the reference's examples-only component (``examples/reducibility.R``,
SURVEY.md §2.2 P7 — excluded from the R build by ``.Rbuildignore`` but part
of the package's documented methodology).

Per X column p, compare two sets of prediction losses:

* null:        loss(ŷ_full − ŷ_AME), where ŷ_AME = X · AMEᵀ
               (``reducibility.R:13, 27`` — note the null deliberately
               benchmarks against the *fitted* values ŷ, the regularized
               target function y* = Kc, not raw y);
* alternative: loss(y − ŷ_p), where ŷ_p uses the pointwise effects
               dy/dxₚ for column p and the AMEs for every other column
               (``:18-21, 30``);

then a one-sided paired Wilcoxon signed-rank test of
``alternative < null`` per column (``:31-33``) with Benjamini–Hochberg
FDR control across the P columns (``:36-42``).  "Reject Null" for column
p means the pointwise effects materially improve prediction — the AME is
NOT a sufficient ("reducible") summary of that effect.

L1 or L2 loss, q (FDR level) as in the reference.  The Wilcoxon p-value
uses the normal approximation with midranks for ties and continuity
correction — what R's ``wilcox.test`` does whenever ties/zeros are
present, which is always at these N.  The BH step-up here is the standard
one (reject p ≤ p₍ₖ₎ with k = max{i : p₍ᵢ₎ ≤ i·q/P}); the reference's
hand-rolled loop (``:37-39``) additionally rejects the first *failing*
p-value — an off-by-one we do not reproduce.
"""
from __future__ import annotations

import dataclasses
from math import erfc, sqrt
from typing import List

import numpy as np

from .types import KRLSModel


def _midranks(a: np.ndarray) -> np.ndarray:
    order = np.argsort(a, kind="mergesort")
    ranks = np.empty(a.size, dtype=np.float64)
    sa = a[order]
    i = 0
    while i < a.size:
        j = i
        while j + 1 < a.size and sa[j + 1] == sa[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def wilcoxon_paired_less(x: np.ndarray, y: np.ndarray) -> float:
    """P-value for H1: x < y (paired Wilcoxon signed-rank, normal approx
    with tie correction and continuity correction, zeros dropped —
    matching R's ``wilcox.test(x, y, paired=TRUE, alternative='less')``
    in the tied/large-sample regime)."""
    d = np.asarray(x, np.float64) - np.asarray(y, np.float64)
    d = d[d != 0]
    n = d.size
    if n == 0:
        return 1.0
    ranks = _midranks(np.abs(d))
    V = float(np.sum(ranks[d > 0]))
    mu = n * (n + 1) / 4.0
    _, counts = np.unique(np.abs(d), return_counts=True)
    sig2 = n * (n + 1) * (2 * n + 1) / 24.0 - np.sum(
        counts ** 3 - counts) / 48.0
    if sig2 <= 0:
        return 1.0
    z = (V - mu + 0.5) / sqrt(sig2)     # lower tail, continuity corrected
    return 0.5 * erfc(-z / sqrt(2.0))


def benjamini_hochberg_reject(pvals: np.ndarray, q: float) -> np.ndarray:
    """Standard BH step-up decision at FDR level q."""
    p = np.asarray(pvals, dtype=np.float64)
    m = p.size
    order = np.argsort(p)
    thresh = (np.arange(1, m + 1) * q) / m
    below = p[order] <= thresh
    if not below.any():
        return np.zeros(m, dtype=bool)
    k = int(np.max(np.nonzero(below)[0]))
    cut = p[order][k]
    return p <= cut


@dataclasses.dataclass
class ReducibilityResult:
    labels: List[str]
    pvalues: np.ndarray        # raw one-sided Wilcoxon p per column
    reject: np.ndarray         # BH decision: True = "Reject Null"
    loss: int
    q: float

    def __str__(self) -> str:
        lines = ["Reducibility test — H0: the AME approximates the "
                 "regularized target as well as the pointwise effects "
                 f"(L{self.loss} loss, BH at q={self.q})",
                 f"{'':24s}{'p':>12s}   BH decision"]
        for lab, p, r in zip(self.labels, self.pvalues, self.reject):
            lines.append(f"{lab:24s}{p:12.4g}   "
                         f"{'Reject Null' if r else 'Accept Null'}")
        return "\n".join(lines)


def reducibility(model: KRLSModel, loss: int = 2,
                 q: float = 0.05) -> ReducibilityResult:
    if model.derivatives is None:
        raise ValueError("fit with derivative=True first")
    if loss not in (1, 2):
        loss = 2
    which = (model.which_derivatives if model.which_derivatives is not None
             else list(range(model.p)))
    labels = [model.xlabs[i] for i in which]

    X = np.asarray(model.X, np.float64)[:, which]
    D = np.asarray(model.derivatives, np.float64)
    ame = np.asarray(model.avgderivatives, np.float64)
    y = np.asarray(model.y, np.float64)
    yfit = np.asarray(model.yfitted, np.float64)

    yhat_ame = X @ ame
    lossf = (lambda r: np.abs(r)) if loss == 1 else (lambda r: r * r)
    loss_null = lossf(yfit - yhat_ame)

    pvals = np.empty(len(which))
    for j in range(len(which)):
        yhat_p = yhat_ame - X[:, j] * ame[j] + X[:, j] * D[:, j]
        pvals[j] = wilcoxon_paired_less(lossf(y - yhat_p), loss_null)

    reject = benjamini_hochberg_reject(pvals, q)
    return ReducibilityResult(labels, pvals, reject, loss, q)
