"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the plain
float64 reference (``reference/krls.py``) works each sampled job out
again from the same generated inputs. The program's outputs are judged,
and read only for that: each stage is held on its own input (the
eigenvalues against the reference's own; the fitted values, derivatives,
AMEs and predictions against what the reference works out from the
program's own coefficients), and the end-to-end outputs at the program's
lambda*, so that a lambda* within the search's own tolerance does not
move every later number. Only the numbers a configuration gives a limit
are compared; the rest are printed as readings.

Each kind of traffic (``kinds/<kind>.py``) samples its jobs and works out
their numbers with the pieces here. Each number is a worst case over the
sampled jobs; the configuration's ``limits`` give each its limit, under the
traffic's kind. ``PERF.md`` gives the readings each limit was set from.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from . import data
from .reference import krls


# lambda* is held to be a minimum of the reference's LOO loss against the
# loss at lambda* / NEAR and lambda* * NEAR (within [L, U]): on the dense
# route's shallow interior basin the loss moves 0.1-0.5% over a factor 1.25,
# while a lambda* doubled by a fault reads 6-14% (PERF.md has the readings)
NEAR = 1.25


def _gap(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def reference_fit(config: dict, y, X, device) -> krls.Fit:
    fit = config.get("fit", {})
    return krls.prepare(X, y, neig=fit.get("neig"),
                        eigtrunc=fit.get("eigtrunc"),
                        sigma=fit.get("sigma"), device=device)


def fit_numbers(out: dict, ref: krls.Fit) -> Dict[str, float]:
    """The numbers of one fit (and its summary, where run).

    Stage by stage: the eigenvalues against the reference's own; lambda*
    by the reference's LOO loss there over the least of its loss a factor
    ``NEAR`` below and above (``loo_local``: whether the program stopped at
    a minimum of the loss, as the golden search promises; the loss can have
    two basins, and which one a search ends in turns on rounding, so the
    place it stops and its loss against the reference's own lambda*,
    ``loo_excess``, are readings); Neff at the program's lambda*; the fitted values, derivatives and
    AMEs against what the reference works out from the program's own
    coefficients; the p-values against the reference's from the program's
    own AMEs, SEs and Neff (``p_c``). Beside them, end to end at the
    program's lambda*: the coefficients, fitted values, derivatives, LOO
    error, SEs and p-values against the reference's own (these carry the
    truncated eigenvectors' convergence; the configuration's limits say
    which are held, and how far).
    """
    which = out["which"]
    deriv = out["derivatives"] is not None
    o = krls.outputs(ref, out["lambda"], which=which, derivative=deriv)
    loss = ref.spectral.loo(out["lambda"])
    yhat_c, deriv_c, ame_c = krls.from_coeffs(ref, out["coeffs"], which,
                                              deriv)
    sd_y = ref.y_sd
    vals = ref.eig.values.cpu().numpy()
    k = min(ref.eig.lastkeeper, out["lastkeeper"], len(out["eigenvalues"]))
    nums = {
        "eigvals": float(np.max(np.abs(out["eigenvalues"][:k] - vals[:k]))
                         / vals[0]),
        "lastkeeper": float(abs(out["lastkeeper"] - ref.eig.lastkeeper)),
        "lambda_rel": _rel(out["lambda"], ref.lambda_),
        "loo_excess": loss / ref.spectral.loo(ref.lambda_) - 1.0,
        "loo_local": loss / min(
            ref.spectral.loo(max(ref.L, out["lambda"] / NEAR)),
            ref.spectral.loo(min(ref.U, out["lambda"] * NEAR))) - 1.0,
        "neff_rel": _rel(out["neffective"], o.neffective),
        "yhat_c": float(np.max(np.abs(out["yfitted"] - yhat_c)) / sd_y),
        "looe_rel": _rel(out["looe"], o.looe),
        "coef": _gap(out["coeffs"], o.coeffs),
        "yhat": float(np.max(np.abs(out["yfitted"] - o.yfitted)) / sd_y),
        "r2_abs": abs(out["R2"] - o.R2),
    }
    if deriv:
        nums["deriv_c"] = _gap(out["derivatives"], deriv_c)
        nums["deriv"] = _gap(out["derivatives"], o.derivatives)
    if out.get("ame") is not None:
        nums["ame_c"] = _gap(out["ame"], ame_c)
        nums["ame"] = _gap(out["ame"], o.avgderivatives)
        nums["se_rel"] = float(np.max(np.abs(out["se"] / o.se - 1.0)))
        nums["p_abs"] = float(np.max(np.abs(out["pvalues"] - o.pvalues)))
        p = ref.X.shape[1]
        nums["p_c"] = float(np.max(np.abs(out["pvalues"] - krls.pvalues(
            out["ame"] / out["se"], out["neffective"] - p))))
    return nums


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def sample(n: int, k: int, seed: int, must: Optional[int] = None):
    """``k`` of ``n`` indices drawn from the seed, with ``must`` among
    them."""
    rng = data.stream(seed, 4)
    picks = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    if must is not None and must not in picks:
        picks.discard(max(picks))
        picks.add(must)
    return sorted(picks)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(every limited number within its limit, [(name, value, limit)]).
    A limited number the run did not produce fails."""
    rows = [(k, numbers.get(k, float("nan")), float(v))
            for k, v in limits.items()]
    ok = all(v <= lim for _, v, lim in rows)   # nan compares false
    return ok, rows
