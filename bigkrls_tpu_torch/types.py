"""Core data types, ported from ``bigkrls_tpu/types.py``.

Same classes and field names. Heavy objects (the kernel ``K``, the
eigenbasis ``Q`` of the factored covariance) are torch tensors on the
fit's device; scalars and the per-observation outputs (coefficients,
fitted values, derivatives, eigenvalues) are numpy float64 arrays, as in
the JAX package. The O(N²) covariances stay factored and are materialized
only on request.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

Array = Any  # torch.Tensor or np.ndarray


@dataclasses.dataclass
class Eigensystem:
    """Truncated symmetric eigendecomposition of the kernel.

    ``values_full`` holds all computed eigenvalues, descending; ``vectors``
    the first ``lastkeeper`` eigenvectors (negated, as in the reference).
    The λ-search bounds and Neffective consume ``values_full``; the
    spectral solve and the covariances the truncated pair."""

    values_full: Array      # (neig,) descending
    vectors: Array          # (N, lastkeeper)
    lastkeeper: int

    @property
    def values(self) -> Array:
        return self.values_full[: self.lastkeeper]

    @property
    def neig(self) -> int:
        return int(self.values_full.shape[0])


@dataclasses.dataclass
class FactoredCovariance:
    """A covariance matrix held as ``scale · Q diag(spectrum) Qᵀ``.

    ``Q`` is (N, k), ``spectrum`` (k,), both tensors on one device;
    ``scale`` a python float."""

    Q: Array
    spectrum: Array
    scale: float = 1.0

    def materialize(self) -> Array:
        """Dense N×N matrix ``scale * Q diag(spectrum) Qᵀ``."""
        return self.scale * ((self.Q * self.spectrum[None, :]) @ self.Q.T)

    def quad_form(self, A: Array) -> Array:
        """``scale * Aᵀ (Q S Qᵀ) A`` for (N, m) ``A`` in O(N·k·m)."""
        QtA = self.Q.T @ A
        return self.scale * (QtA.T * self.spectrum[None, :]) @ QtA

    def quad_form_diag(self, A: Array) -> Array:
        """``diag(Aᵀ (QSQᵀ) A)`` without the m×m intermediate."""
        QtA = self.Q.T @ A
        return self.scale * torch.sum(QtA * QtA * self.spectrum[:, None],
                                      dim=0)


@dataclasses.dataclass
class KRLSModel:
    """Fitted KRLS model. Matrices are in original units, as in the
    reference; see ``bigkrls_tpu.types.KRLSModel`` for each field."""

    # --- data ---
    X: Array                       # (N, P) original units, numpy
    y: Array                       # (N,) original units, numpy
    K: Array                       # (N, N) kernel of standardized X, tensor
    xlabs: Sequence[str]

    # --- estimates ---
    coeffs: Array                  # (N,) standardized-unit coefficients
    yfitted: Array                 # (N,) original units
    sigma: float
    lambda_: float
    looe: float
    R2: float
    R2AME: Optional[float]

    # --- spectral objects ---
    # (neig,) descending; on the adaptive route only the computed head,
    # with the tail summarized by eig_tail_theta / eig_tail_w
    K_eigenvalues: Array
    lastkeeper: int
    neffective: float
    neffective_acf: Optional[float]

    # --- marginal effects (None when derivative=False) ---
    derivatives: Optional[Array]
    avgderivatives: Optional[Array]
    var_avgderivatives: Optional[Array]
    binaryindicator: Array
    which_derivatives: Optional[Sequence[int]]

    # --- factored covariances ---
    vcov_c_factored: Optional[FactoredCovariance]
    sigmasq_std: Optional[float]

    # --- bookkeeping ---
    y_mean: float
    y_sd: float
    x_means: Array
    x_sds: Array
    path: Optional[str] = None
    timings: Optional[list] = None
    sharding_report: Optional[dict] = None
    eig_path: Optional[str] = None
    eig_tail_theta: Optional[Array] = None
    eig_tail_w: Optional[Array] = None

    @property
    def spectrum_is_complete(self) -> bool:
        """True when ``K_eigenvalues`` holds one value per observation."""
        return int(np.asarray(self.K_eigenvalues).shape[0]) == self.n

    @property
    def n(self) -> int:
        return int(np.asarray(self.X).shape[0])

    @property
    def p(self) -> int:
        return int(np.asarray(self.X).shape[1])

    @property
    def vcov_est_c(self) -> Optional[Array]:
        """Dense Var(c) in original y units, materialized on demand."""
        if self.vcov_c_factored is None:
            return None
        return self.vcov_c_factored.materialize()

    @property
    def vcov_est_fitted(self) -> Optional[Array]:
        """Dense Var(ŷ) = Kᵀ Var(c) K, materialized on demand."""
        if self.vcov_c_factored is None or self.K is None:
            return None
        return self.vcov_c_factored.quad_form(self.K)

    def vcov_fitted_diag(self) -> Optional[Array]:
        """diag Var(ŷ) in O(N·k)."""
        if self.vcov_c_factored is None:
            return None
        if self.K is None:
            raise NotImplementedError(
                "vcov_fitted_diag without a stored kernel needs the "
                "streaming K·V product (ROADMAP queue 1, item 13)")
        return self.vcov_c_factored.quad_form_diag(self.K)

    @property
    def derivative_call(self) -> bool:
        return self.derivatives is not None

    @property
    def has_big_matrices(self) -> bool:
        return True


@dataclasses.dataclass
class KRLSPrediction:
    """Prediction output (reference ``bigKRLS_predicted``)."""

    predicted: Array
    se_pred: Optional[Array]
    newdata: Array
    newdataK: Optional[Array]
    ytest: Optional[Array] = None
    vcov_est_pred: Optional[Array] = None
    pseudoR2: Optional[float] = None
    MSE: Optional[float] = None

    @property
    def has_big_matrices(self) -> bool:
        return True
