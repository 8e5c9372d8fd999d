"""Out-of-sample prediction with standard errors.

Port of ``bigkrls_tpu/predict.py`` (``predict.bigKRLS``,
``R/bigKRLS.R:547-637``):

* training X and newdata are re-standardized by the *training* moments,
  recomputed from the stored X; the model is not mutated;
* the cross kernel comes from ``ops.kernels.cross_kernel_matrix`` (the
  CUDA kernel on f32 CUDA tensors);
* ``ŷ = K_new·c`` rescaled by sd(y), mean(y);
* SEs come from the factored Var(c), so only the O(U·k) diagonal is
  formed unless ``materialize_vcov``; ``correct_SE`` multiplies the
  covariance by √(N/Neff) before the square root, i.e. the reference's
  (N/Neff)^¼ quirk, kept for parity;
* above ``AUTO_BLOCK_ELEMS`` cross-kernel elements (or with
  ``block_size``) newdata is processed in row blocks and ``newdataK`` is
  returned as None.

The device and dtype are those of the model's kernel (or, for a model
without one, of its covariance factor).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .ops.kernels import cross_kernel_matrix
from .types import KRLSModel, KRLSPrediction
from .utils.precision import ieee_fp32

AUTO_BLOCK_ELEMS = 50_000_000


def _model_placement(model: KRLSModel):
    for t in (model.K, getattr(model.vcov_c_factored, "Q", None)):
        if isinstance(t, torch.Tensor):
            return t.device, t.dtype
    return torch.device("cpu"), torch.float64


def _np(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def predict(model: KRLSModel, newdata, se_pred: bool = False,
            correct_SE: bool = True, ytest=None,
            materialize_vcov: bool = False,
            block_size: int = None) -> KRLSPrediction:
    with ieee_fp32():
        return _predict_impl(model, newdata, se_pred, correct_SE, ytest,
                             materialize_vcov, block_size)


def _predict_impl(model, newdata, se_pred, correct_SE, ytest,
                  materialize_vcov, block_size) -> KRLSPrediction:
    newdata_np = np.asarray(newdata, dtype=np.float64)
    if newdata_np.ndim == 1:
        newdata_np = newdata_np[:, None]
    if newdata_np.shape[1] != model.p:
        raise ValueError("ncol(newdata) differs from ncol(X) of the fitted model")
    if se_pred and model.vcov_c_factored is None:
        raise ValueError(
            "refit with vcov_est=True to compute standard errors on predictions")

    device, dtype = _model_placement(model)
    Xm = model.X.mean(axis=0)
    Xs = model.X.std(axis=0, ddof=1)
    X_std = torch.as_tensor((model.X - Xm) / Xs, dtype=dtype, device=device)
    new_std = torch.as_tensor((newdata_np - Xm) / Xs, dtype=dtype,
                              device=device)

    U, n = new_std.shape[0], X_std.shape[0]
    if block_size is None and U * n > AUTO_BLOCK_ELEMS:
        block_size = max(1, AUTO_BLOCK_ELEMS // n)
        logging.getLogger("bigkrls_tpu_torch").warning(
            "predict: U*N = %d cross-kernel elements exceeds %d; switching "
            "to the blocked path (block_size=%d). prediction.newdataK will "
            "be None — pass block_size >= nrow(newdata) to force the dense "
            "cross kernel.", U * n, AUTO_BLOCK_ELEMS, block_size)
    blocked = block_size is not None and block_size < U
    if blocked and materialize_vcov:
        raise ValueError(
            "materialize_vcov builds the dense U x U prediction covariance "
            "and needs the full cross kernel; pass block_size=None (and "
            "enough memory) to request it at this scale.")

    coeffs = torch.as_tensor(model.coeffs, dtype=dtype, device=device)
    fac = model.vcov_c_factored   # original y units (scale = sd(y)²)
    corr = 1.0
    if se_pred and correct_SE and model.neffective is not None:
        corr = float(np.sqrt(model.n / model.neffective))
    y_sd, y_mean = model.y.std(ddof=1), model.y.mean()

    se = None
    vcov_pred = None
    Knew = None
    if blocked:
        ypred_std = np.empty(U, dtype=np.float64)
        if se_pred:
            se = np.empty(U, dtype=np.float64)
        for lo in range(0, U, block_size):
            hi = min(lo + block_size, U)
            Kb = cross_kernel_matrix(new_std[lo:hi].contiguous(), X_std,
                                     model.sigma)
            ypred_std[lo:hi] = _np(Kb @ coeffs)
            if se_pred:
                se[lo:hi] = np.sqrt(_np(fac.quad_form_diag(Kb.T) * corr))
    else:
        Knew = cross_kernel_matrix(new_std, X_std, model.sigma)
        ypred_std = _np(Knew @ coeffs)
        if se_pred:
            if materialize_vcov:
                vcov_pred = _np(fac.quad_form(Knew.T) * corr)   # (U, U)
                se = np.sqrt(np.diag(vcov_pred))
            else:
                se = np.sqrt(_np(fac.quad_form_diag(Knew.T) * corr))
    ypred = ypred_std * y_sd + y_mean

    pseudoR2 = mse = None
    if ytest is not None:
        ytest = np.asarray(ytest, np.float64).reshape(-1)
        if ytest.shape[0] != ypred.shape[0]:
            raise ValueError("ytest length differs from nrow(newdata)")
        mse = float(np.mean((ytest - ypred) ** 2))
        if ytest.std() > 0 and ypred.std() > 0:
            pseudoR2 = float(np.corrcoef(ypred, ytest)[0, 1] ** 2)

    return KRLSPrediction(
        predicted=ypred,
        se_pred=se,
        newdata=newdata_np,
        newdataK=None if Knew is None else _np(Knew),
        ytest=ytest,
        vcov_est_pred=vcov_pred,
        pseudoR2=pseudoR2,
        MSE=mse,
    )
