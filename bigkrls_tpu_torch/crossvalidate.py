"""Train/test and K-fold cross-validation, ported from
``bigkrls_tpu/crossvalidate.py``.

Equivalent of ``crossvalidate.bigKRLS`` (``R/bigKRLS.R:1146-1336``) and
``summary.bigKRLS_CV`` (``:783-879``):

* exactly one of ``kfolds`` / ``ptesting`` must be given (``:1148``);
* seeded partitions drawn from ``np.random.default_rng(seed)`` in the JAX
  package's order, so a seed gives the same train and test rows in both
  packages: ``ptesting`` draws ``round(N·p/100)`` test rows without
  replacement (``:1177-1180``); K-fold slices a random permutation into
  K contiguous, nearly equal blocks (``cut(sample(N), breaks=K)``,
  ``:1232``);
* every fold is checked with ``check_data`` before any training
  (``:1234-1243``);
* per split: in/out-of-sample MSE and pseudo-R² (``cor(pred, ytest)²``)
  for the full model and for the AME-only linear predictor
  ``ŷ_AME = X·avgderivatives`` (``:1293-1313``).

``fit_kwargs`` (``device``, ``dtype`` and every other ``fit`` argument)
go to each fold's ``fit``; ``predict`` runs where the fold's model lives.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from .model import check_data, fit
from .predict import predict
from .types import KRLSModel, KRLSPrediction


@dataclasses.dataclass
class KRLSFold:
    trained: KRLSModel
    tested: KRLSPrediction


@dataclasses.dataclass
class KRLSCrossValidation:
    type: str                      # "crossvalidated" | "KfoldsCV"
    seed: int
    folds: Optional[np.ndarray]    # fold assignment (KfoldsCV) or None
    indices: Optional[Dict[str, np.ndarray]]  # train/test sets (ptesting)
    fold_results: List[KRLSFold]
    metrics: Dict[str, Any]
    kfolds: Optional[int] = None
    ptesting: Optional[float] = None

    def __getitem__(self, key):
        return self.metrics[key]

    @property
    def trained(self) -> KRLSModel:
        return self.fold_results[0].trained

    @property
    def tested(self) -> KRLSPrediction:
        return self.fold_results[0].tested


def _ame_yhat(model: KRLSModel, X: np.ndarray) -> np.ndarray:
    """ŷ from average marginal effects only (``:1203-1213``), over the
    estimated subset of columns when ``which_derivatives`` was given."""
    cols = (model.which_derivatives if model.which_derivatives is not None
            else list(range(model.p)))
    return X[:, cols] @ np.asarray(model.avgderivatives)


def _split_metrics(trained: KRLSModel, tested: KRLSPrediction,
                   Xtest: np.ndarray, ytest: np.ndarray,
                   marginals: bool) -> Dict[str, float]:
    out: Dict[str, float] = {}
    out["R2_is"] = trained.R2
    out["R2_oos"] = float(np.corrcoef(ytest, tested.predicted)[0, 1] ** 2)
    out["MSE_is"] = float(np.mean((trained.y - trained.yfitted) ** 2))
    out["MSE_oos"] = float(np.mean((ytest - tested.predicted) ** 2))
    if marginals:
        out["R2AME_is"] = trained.R2AME
        yhat_is = _ame_yhat(trained, trained.X)
        out["MSE_AME_is"] = float(np.mean((trained.y - yhat_is) ** 2))
        yhat_oos = _ame_yhat(trained, Xtest)
        out["R2AME_oos"] = float(np.corrcoef(ytest, yhat_oos)[0, 1] ** 2)
        out["MSE_AME_oos"] = float(np.mean((ytest - yhat_oos) ** 2))
    return out


def crossvalidate(
    y,
    X,
    seed: int,
    kfolds: Optional[int] = None,
    ptesting: Optional[float] = None,
    noisy: Optional[bool] = None,
    equalize_folds: Optional[bool] = None,
    **fit_kwargs,
) -> KRLSCrossValidation:
    """``equalize_folds`` (K-fold only): when N % K ≠ 0, hold N % K
    randomly chosen rows (at most K − 1) out of the partition, never
    trained on and never tested, so every fold has one train and one test
    size; the held-out rows are in ``cv.indices['dropped']``. ``None`` =
    on from N ≥ 16384, as in the JAX package, so that both packages draw
    the same partition for the same seed; below that the reference's
    exact ±1-row partition (``R/bigKRLS.R:1232``)."""
    if (kfolds is None) == (ptesting is None):
        raise ValueError("Specify either kfolds or ptesting but not both.")

    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    N = X.shape[0]
    marginals = fit_kwargs.get("derivative", True)
    noisy_flag = (N > 2000) if noisy is None else bool(noisy)
    rng = np.random.default_rng(seed)

    if ptesting is not None:
        if not (0 < ptesting < 100):
            raise ValueError(
                "ptesting, the percentage of data used for validation, "
                "must be between 0 and 100.")
        n_test = int(round(N * ptesting / 100.0))
        train_set = np.sort(rng.choice(N, size=N - n_test, replace=False))
        test_set = np.setdiff1d(np.arange(N), train_set)

        trained = fit(y[train_set], X[train_set], noisy=noisy_flag,
                      **fit_kwargs)
        tested = predict(trained, X[test_set], ytest=y[test_set])
        m = _split_metrics(trained, tested, X[test_set], y[test_set],
                           marginals)
        metrics = {
            "pseudoR2_is": m["R2_is"], "pseudoR2_oos": m["R2_oos"],
            "MSE_is": m["MSE_is"], "MSE_oos": m["MSE_oos"],
        }
        if marginals:
            metrics.update({
                "pseudoR2AME_is": m["R2AME_is"],
                "pseudoR2AME_oos": m["R2AME_oos"],
                "MSE_AME_is": m["MSE_AME_is"],
                "MSE_AME_oos": m["MSE_AME_oos"],
            })
        return KRLSCrossValidation(
            type="crossvalidated", seed=seed, folds=None,
            indices={"train_set": train_set, "test_set": test_set},
            fold_results=[KRLSFold(trained, tested)],
            metrics=metrics, ptesting=ptesting,
        )

    # ---- K-fold path ----
    kfolds = int(kfolds)
    if kfolds <= 0:
        raise ValueError("kfolds must be a positive integer")
    if not (2 <= kfolds <= N):
        # K=1 trains on nothing; K>N makes empty folds
        raise ValueError(
            f"kfolds must be between 2 and N={N} (got {kfolds})")
    remainder = N % kfolds
    if equalize_folds is None:
        equalize_folds = N >= 16384
    dropped = None
    active = np.arange(N)
    if remainder and equalize_folds:
        dropped = np.sort(rng.choice(N, size=remainder, replace=False))
        active = np.setdiff1d(np.arange(N), dropped)
        logging.getLogger("bigkrls_tpu_torch").warning(
            "crossvalidate: equalize_folds holds %d of %d rows out of the "
            "K-fold partition (never trained or tested; see "
            "cv.indices['dropped']) so all %d folds have one size; it is on "
            "by default from N = 16384 so that the partition equals the JAX "
            "package's for the same seed. Pass equalize_folds=False for the "
            "reference's exact +-1-row partition.", remainder, N, kfolds)
    Na = active.size
    # cut(sample(N), breaks=K): permute, then contiguous rank blocks (:1232)
    perm_rank = np.argsort(rng.permutation(Na))
    folds = np.full(N, -1, dtype=int)          # -1 = held out (equalized)
    folds[active] = (perm_rank * kfolds // Na).astype(int)

    for k in range(kfolds):
        tr = (folds != k) & (folds >= 0)
        check_data(y[tr], X[tr])

    per_fold: Dict[str, list] = {}
    fold_results: List[KRLSFold] = []
    for k in range(kfolds):
        tr = (folds != k) & (folds >= 0)
        te = folds == k
        trained = fit(y[tr], X[tr], noisy=noisy_flag, **fit_kwargs)
        tested = predict(trained, X[te], ytest=y[te])
        fold_results.append(KRLSFold(trained, tested))
        m = _split_metrics(trained, tested, X[te], y[te], marginals)
        for key, val in m.items():
            per_fold.setdefault(key, []).append(val)

    metrics = {key: np.asarray(vals) for key, vals in per_fold.items()}
    return KRLSCrossValidation(
        type="KfoldsCV", seed=seed, folds=folds,
        indices=None if dropped is None else {"dropped": dropped},
        fold_results=fold_results, metrics=metrics, kfolds=kfolds,
    )


class CVSummary(dict):
    """``summary_cv``'s return: a dict with the overview, the per-model
    ``KRLSSummary`` objects and the formatted ``"text"``, which is what
    ``str()`` shows (as the reference prints ``summary.bigKRLS_CV``)."""

    def __str__(self) -> str:
        return self.get("text", super().__repr__())


def summary_cv(cv: KRLSCrossValidation, **summary_kwargs):
    """Overview of model performance plus per-model summaries
    (``summary.bigKRLS_CV``, ``R/bigKRLS.R:783-879``)."""
    from .inference import summary

    lines = ["", "Overview of Model Performance", ""]
    out: Dict[str, Any] = {}
    if cv.type == "crossvalidated":
        idx = cv.indices
        lines.append(f"N: {len(idx['train_set']) + len(idx['test_set'])}")
        lines.append(f"Seed: {cv.seed}")
        rows = [
            ("Mean Squared Error (Full Model)", "MSE_is", "MSE_oos"),
            ("Mean Squared Error (AMEs Only)", "MSE_AME_is", "MSE_AME_oos"),
            ("Pseudo-R^2 (Full Model)", "pseudoR2_is", "pseudoR2_oos"),
            ("Pseudo-R^2 (AMEs Only)", "pseudoR2AME_is", "pseudoR2AME_oos"),
        ]
        lines.append(f"{'':48s}{'In Sample':>12s}{'Out of Sample':>15s}")
        overview = {}
        for label, kin, kout in rows:
            if kin in cv.metrics:
                overview[label] = (cv.metrics[kin], cv.metrics[kout])
                lines.append(
                    f"{label:48s}{cv.metrics[kin]:12.3f}{cv.metrics[kout]:15.3f}")
        out["overview"] = overview
        if cv.trained.derivatives is not None:
            out["training_summary"] = summary(cv.trained, **summary_kwargs)
    else:
        ntot = len(cv.folds)
        lines += [f"N: {ntot}", f"Kfolds: {cv.kfolds}", f"Seed: {cv.seed}", ""]
        lines.append("".join([f"{'':16s}"] +
                             [f"{'Fold ' + str(k + 1):>12s}"
                              for k in range(cv.kfolds)]))
        for key in sorted(cv.metrics):
            vals = cv.metrics[key]
            lines.append(f"{key:16s}" + "".join(f"{v:12.4f}" for v in vals))
        out["overview"] = dict(cv.metrics)
        for k, fold in enumerate(cv.fold_results):
            if fold.trained.derivatives is not None:
                out[f"training{k + 1}_summary"] = summary(fold.trained,
                                                          **summary_kwargs)
    out["text"] = "\n".join(lines)
    return CVSummary(out)
