"""Core data types, ported from ``bigkrls_tpu/types.py``.

Same classes and field names. Heavy objects (the kernel ``K``, the
eigenbasis ``Q`` of the factored covariance) are torch tensors on the
fit's device; scalars and the per-observation outputs (coefficients,
fitted values, derivatives, eigenvalues) are numpy float64 arrays, as in
the JAX package. The O(N²) covariances stay factored and are materialized
only on request. A mesh fit's model keeps its kernel block-sharded and the
factored covariance's Q row-sharded (``parallel/sharded.ShardedTensor``);
every method below takes them so.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .parallel.sharded import ShardedTensor, dense, gram, rows_map

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

    ``Q`` is (N, k), a tensor or row-sharded, ``spectrum`` (k,) a tensor on
    Q's (first) device; ``scale`` a python float. The products with Q
    reduce over its shards; :meth:`diag` comes back row-sharded like Q."""

    Q: Array
    spectrum: Array
    scale: float = 1.0

    def materialize(self) -> Array:
        """Dense N×N matrix ``scale * Q diag(spectrum) Qᵀ`` (a row-sharded
        Q is gathered for it)."""
        Q = dense(self.Q, label="FactoredCovariance.materialize")
        return self.scale * ((Q * self.spectrum[None, :]) @ Q.T)

    def diag(self) -> Array:
        """Diagonal in O(N·k)."""
        return rows_map(lambda q, s: self.scale * torch.sum(
            (q * q) * s[None, :], dim=1), self.Q, self.spectrum)

    def quad_form(self, A: Array) -> Array:
        """``scale * Aᵀ (Q S Qᵀ) A`` for (N, m) ``A`` (row-sharded like a
        row-sharded Q) in O(N·k·m)."""
        QtA = gram(self.Q, A)
        return self.scale * (QtA.T * self.spectrum[None, :]) @ QtA

    def quad_form_diag(self, A: Array) -> Array:
        """``diag(Aᵀ (QSQᵀ) A)`` without the m×m intermediate."""
        QtA = gram(self.Q, A)
        return self.scale * torch.sum(QtA * QtA * self.spectrum[:, None],
                                      dim=0)

    def scaled(self, factor: float) -> "FactoredCovariance":
        """The same factors with ``scale`` multiplied by ``factor``."""
        return FactoredCovariance(self.Q, self.spectrum, self.scale * factor)


@dataclasses.dataclass
class KRLSModel:
    """Fitted KRLS model. Matrices are in original units, as in the
    reference; see ``bigkrls_tpu.types.KRLSModel`` for each field."""

    # --- data ---
    X: Array                       # (N, P) original units, numpy
    y: Array                       # (N,) original units, numpy
    K: Array                       # (N, N) kernel of standardized X, tensor
    #                                (block-sharded for a mesh fit); None
    #                                for a streaming (kernel-free) fit
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
        """Dense Var(ŷ) = Kᵀ Var(c) K, materialized on demand (for a
        block-sharded K from the gathered K·Q). None for a model without a
        stored kernel: use :meth:`vcov_fitted_diag`."""
        fac = self.vcov_c_factored
        if fac is None or self.K is None:
            return None
        if isinstance(self.K, ShardedTensor):
            KQ = dense(self.K @ fac.Q, label="vcov_est_fitted")
            return fac.scale * (KQ * fac.spectrum[None, :]) @ KQ.T
        return fac.quad_form(self.K)

    def vcov_fitted_diag(self) -> Optional[Array]:
        """diag Var(ŷ) in O(N·k) (row-sharded for a mesh fit's model). For
        a block-sharded K, K·Q is the block product; for a model without a
        stored kernel (a streaming fit, or a converted model) K·Q is
        recomputed by the kernel-free product, on Q's device (the ring
        product over a row-sharded Q's ring)."""
        fac = self.vcov_c_factored
        if fac is None:
            return None
        if self.K is not None and not isinstance(self.K, ShardedTensor):
            return fac.quad_form_diag(self.K)
        if self.K is not None:
            KQ = self.K @ fac.Q
        else:
            Q = rows_map(lambda q: q.contiguous(), fac.Q)
            X_std = torch.as_tensor((self.X - self.x_means) / self.x_sds,
                                    dtype=Q.dtype)
            if isinstance(Q, ShardedTensor):
                from .parallel.ring_kernel import make_ring_matmul
                from .parallel.sharded import place
                KQ = make_ring_matmul(Q.mesh)(place(X_std, Q.mesh, "row"), Q,
                                              self.sigma)
            else:
                from .ops.matvec import kernel_matmul
                KQ = kernel_matmul(X_std.to(Q.device), Q, self.sigma)
        return rows_map(lambda kq, s: fac.scale * torch.sum(
            kq * kq * s[None, :], dim=1), KQ, fac.spectrum)

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
