"""Model summary: AME t-tests, p-values, and marginal-effect percentiles.

Port of ``bigkrls_tpu/inference.py``, the equivalent of ``summary.bigKRLS`` (``R/bigKRLS.R:666-757``):

* ``degrees``: "Neffective" (default) uses the regularization-aware dof
  ``Neffective − P``; "N" uses raw N; "acf" uses the autocorrelation
  Neffective (computing it lazily if the fit didn't, ``:683-691``);
* when ``degrees != "Neffective"`` the se is rescaled by N/n (``:723-724``
  — a no-op for "N" since n = N, replicated anyway);
* ``t = AME/se``; ``p = 2·pt(|t|, df = n − P)`` with P = ncol(X) (all
  columns, even when only a subset of derivatives was estimated, ``:727``);
* percentiles of the pointwise marginal effects (``:738-743``);
* binary columns are flagged with ``*`` = min→max first difference
  (``:731-734, 745-747``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .ops.stats import neffective_acf, two_sided_p
from .types import KRLSModel


@dataclasses.dataclass
class KRLSSummary:
    ttests: np.ndarray        # (P_est, 4): estimate, se, t, p
    percentiles: np.ndarray   # (P_est, len(probs))
    labels: Sequence[str]
    probs: Sequence[float]
    lambda_: float
    N: int
    n_dof: float
    R2: float
    R2AME: Optional[float]

    def __str__(self) -> str:
        lines = ["", "MODEL SUMMARY:", "",
                 f"lambda: {self.lambda_:.4f}",
                 f"N: {self.N}"]
        if self.n_dof != self.N:
            lines.append(f"N Effective: {self.n_dof:.4g}")
        lines.append(f"R2: {self.R2:.4f}")
        if self.R2AME is not None:
            lines.append(f"R2AME**: {self.R2AME:.4f}")
        lines += ["", "Average Marginal Effects:", ""]
        hdr = f"{'':24s}{'Estimate':>12s}{'Std. Error':>12s}{'t value':>10s}{'Pr(>|t|)':>10s}"
        lines.append(hdr)
        for lab, row in zip(self.labels, self.ttests):
            lines.append(f"{lab:24s}{row[0]:12.4f}{row[1]:12.4f}"
                         f"{row[2]:10.3f}{row[3]:10.4g}")
        lines += ["", "Percentiles of Marginal Effects:", ""]
        lines.append("".join([f"{'':24s}"] + [f"{100*q:>9.0f}%" for q in self.probs]))
        for lab, row in zip(self.labels, self.percentiles):
            lines.append(f"{lab:24s}" + "".join(f"{v:10.4f}" for v in row))
        if any(lab.endswith("*") for lab in self.labels):
            lines += ["", "(*) dy/dx is the discrete change of the dummy "
                          "variable from min to max."]
        lines += ["", "(**) Pseudo-R^2 computed using only the Average "
                      "Marginal Effects."]
        return "\n".join(lines)


def summary(
    model: KRLSModel,
    degrees: str = "Neffective",
    probs: Sequence[float] = (0.05, 0.25, 0.5, 0.75, 0.95),
    labs: Optional[Sequence[str]] = None,
) -> KRLSSummary:
    if degrees not in ("acf", "Neffective", "N"):
        raise ValueError("degrees must be 'Neffective', 'N', or 'acf'")
    if model.derivatives is None:
        raise ValueError(
            "recompute with fit(..., derivative=True) for marginal effects")

    N = model.n
    p = model.p
    if degrees == "Neffective":
        n = model.neffective
    elif degrees == "N":
        n = float(N)
    else:  # acf
        if model.neffective_acf is None:
            Xd = torch.as_tensor(model.X, dtype=torch.float64)
            X_std = (Xd - Xd.mean(0)) / Xd.std(0, correction=1)
            n = float(neffective_acf(X_std))
        else:
            n = model.neffective_acf

    which = (model.which_derivatives if model.which_derivatives is not None
             else list(range(p)))
    if labs is not None:
        if len(labs) != p:
            raise ValueError("labs must have length ncol(X)")
        base_labels = [labs[i] for i in which]
    else:
        base_labels = [model.xlabs[i] for i in which]
    labels = [lab + ("*" if model.binaryindicator[i] else "")
              for lab, i in zip(base_labels, which)]

    est = np.asarray(model.avgderivatives, dtype=np.float64)
    se = np.sqrt(np.asarray(model.var_avgderivatives, dtype=np.float64))
    if degrees != "Neffective":
        se = se * N / n     # ref :723-724 (no-op for degrees="N")
    tval = est / se
    pval = two_sided_p(tval, n - p)
    ttests = np.stack([est, se, tval, pval], axis=1)

    qs = np.quantile(np.asarray(model.derivatives, np.float64),
                     np.asarray(probs), axis=0).T
    return KRLSSummary(
        ttests=ttests, percentiles=qs, labels=labels, probs=list(probs),
        lambda_=model.lambda_, N=N, n_dof=float(n), R2=model.R2,
        R2AME=model.R2AME,
    )
