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
  returned as None (a warning, once per process, says so).

The device and dtype are those of the model's kernel or, for a model
without one (a streaming fit, a converted model), of its covariance
factor. A mesh fit's model (K block-sharded, Q row-sharded) predicts over
its mesh: the training rows are laid out as Q's, each row shard's cross
kernel is one K1 launch on its device, and ŷ = K_new·c and the SEs'
Qᵀ·K_newᵀ are sums over the row shards; ``newdataK`` is fetched to the
host shard by shard.

Each call records its spans (``utils/progress``): the call ``predict``
(counter ``blocked``), and under it ``prepare`` (the re-standardization
of the training X and of newdata, the copies to the device, counter
``bytes_to_device``), ``kernel`` (the K1 cross launches), ``products``
(ŷ = K·c and the SEs' quadratic form) and ``to_host`` (``newdataK``, ŷ
and the SEs to the host as float64, counters ``bytes_to_host``,
``bytes_to_host_pinned``); on the blocked path one ``kernel``,
``products`` and ``to_host`` a block.

Where the results land (``to_host``). A model on one CUDA card widens
a span's results to float64 on the card (exact: the values are the
float32 results' bit for bit) into one buffer and copies it into one
pinned block of PyTorch's caching host allocator: one DMA and one wait
for the stream, so one ``host_reads`` a span, with no page faults and no
conversion on the host. The arrays returned are views of that block; it goes back to
the allocator's pool only when nothing holds any of them, so a later
call never writes under a live result. The allocator rounds a block
up to a power of two and keeps it, so the process keeps pinned host
memory of up to about twice the largest ``newdataK`` it has returned
(1 GB for 1000 rows against 50,000). A model on the CPU or on a mesh,
and a call whose pinned allocation fails, read each result as it is into
pageable memory (a mesh's ``newdataK`` shard by shard) and widen it on
the host.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .ops.kernels import cross_kernel_matrix
from .parallel.sharded import (ShardedTensor, gram, host_gather, mesh_of,
                               place, rows_map)
from .types import KRLSModel, KRLSPrediction
from .utils import progress
from .utils.precision import matmul_precision

AUTO_BLOCK_ELEMS = 50_000_000

_LOG = logging.getLogger("bigkrls_tpu_torch")
_warned_blocked = False


def _model_placement(model: KRLSModel):
    for t in (model.K, getattr(model.vcov_c_factored, "Q", None)):
        if isinstance(t, (torch.Tensor, ShardedTensor)):
            return t.device, t.dtype
    return torch.device("cpu"), torch.float64


def _np(t) -> np.ndarray:
    a = host_gather(t)
    progress.count("bytes_to_host", a.nbytes)
    progress.count("bytes_to_host_pinned", 0)
    return a.astype(np.float64)


class _ToHost:
    """A call's results to the host as float64 arrays (None passes
    through), one ``to_host`` span's at a time. Where ``pinned`` (a model
    on one CUDA card): widened on the card into one buffer, copied into
    one pinned block with one wait, and views of the block returned; else
    each by ``_np``. A failed pinned allocation turns ``pinned`` off for
    the rest of the call."""

    def __init__(self, pinned: bool):
        self.pinned = pinned

    def __call__(self, *ts):
        if self.pinned:
            n = sum(t.numel() for t in ts if t is not None)
            try:
                host = torch.empty(n, dtype=torch.float64, pin_memory=True)
            except RuntimeError:
                self.pinned = False
            else:
                return self._pinned(ts, host)
        return [None if t is None else _np(t) for t in ts]

    @staticmethod
    def _pinned(ts, host):
        live = [t.reshape(-1) for t in ts if t is not None]
        flat = torch.empty(host.shape, dtype=torch.float64,
                           device=live[0].device)
        # into pinned memory a blocking copy_ is one DMA and one wait for
        # the stream, the span's one read (less host time than a
        # non-blocking copy and a synchronize called from Python)
        host.copy_(torch.cat(live, out=flat))
        progress.count("host_reads")
        progress.count("bytes_to_host", host.nbytes)
        progress.count("bytes_to_host_pinned", host.nbytes)
        a, lo, out = host.numpy(), 0, []
        for t in ts:
            if t is None:
                out.append(None)
                continue
            out.append(a[lo:lo + t.numel()].reshape(t.shape))
            lo += t.numel()
        return out


def _to_device(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A copy from pageable host memory: the host waits for the stream,
    as for a read."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    progress.count("host_reads")
    progress.count("bytes_to_device", t.numel() * t.element_size())
    return t


def _warn_blocked(elems: int, block_size: int) -> None:
    """The switch to the blocked path, logged once per process."""
    global _warned_blocked
    if _warned_blocked:
        return
    _warned_blocked = True
    _LOG.warning(
        "predict: U*N = %d cross-kernel elements exceeds %d; switching to "
        "the blocked path (block_size=%d). prediction.newdataK will be "
        "None — pass block_size >= nrow(newdata) to force the dense cross "
        "kernel. (Logged once per process.)", elems, AUTO_BLOCK_ELEMS,
        block_size)


def predict(model: KRLSModel, newdata, se_pred: bool = False,
            correct_SE: bool = True, ytest=None,
            materialize_vcov: bool = False, precision: str = "highest",
            block_size: int = None) -> KRLSPrediction:
    """Predictions (and standard errors) for ``newdata``; ``precision``
    sets the product precision, as in ``fit`` (``utils/precision``)."""
    device, _ = _model_placement(model)
    mesh = mesh_of(getattr(model.vcov_c_factored, "Q", None), model.K)
    devices = [device] if mesh is None else mesh.local_devices
    with matmul_precision(precision), \
            progress.span("predict", device=progress.one_card(devices)) as s:
        return _predict_impl(model, newdata, se_pred, correct_SE, ytest,
                             materialize_vcov, block_size, mesh, s)


def _predict_impl(model, newdata, se_pred, correct_SE, ytest,
                  materialize_vcov, block_size, mesh,
                  call) -> KRLSPrediction:
    prepare = progress.RECORDER.open("prepare")
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
    X_std = _to_device((model.X - Xm) / Xs, dtype,
                       device if mesh is None else "cpu")
    new_std = _to_device((newdata_np - Xm) / Xs, dtype, device)

    U, n = new_std.shape[0], X_std.shape[0]
    if block_size is None and U * n > AUTO_BLOCK_ELEMS:
        block_size = max(1, AUTO_BLOCK_ELEMS // n)
        _warn_blocked(U * n, block_size)
    blocked = block_size is not None and block_size < U
    call.count("blocked", int(blocked))
    if blocked and materialize_vcov:
        raise ValueError(
            "materialize_vcov builds the dense U x U prediction covariance "
            "and needs the full cross kernel; pass block_size=None (and "
            "enough memory) to request it at this scale.")

    coeffs = _to_device(model.coeffs, dtype,
                        device if mesh is None else "cpu")
    if mesh is not None:
        X_std, coeffs = place(X_std, mesh, "row"), place(coeffs, mesh, "row")

    def cross_t(rows_new):
        """K_newᵀ (N, U): one cross-kernel launch per row shard."""
        return rows_map(lambda xs, nw: cross_kernel_matrix(
            nw, xs, model.sigma).T, X_std, rows_new)
    fac = model.vcov_c_factored   # original y units (scale = sd(y)²)
    corr = 1.0
    if se_pred and correct_SE and model.neffective is not None:
        corr = float(np.sqrt(model.n / model.neffective))
    y_sd, y_mean = model.y.std(ddof=1), model.y.mean()
    progress.RECORDER.close(prepare)

    def products(KT, vcov=False):
        """ŷ (standardized) and, with ``se_pred``, the SEs' quadratic form
        on the device: its diagonal, or with ``vcov`` the (U, U) form."""
        with progress.span("products"):
            yp = gram(KT, coeffs)
            if not se_pred:
                return yp, None
            if vcov:
                return yp, fac.quad_form(KT) * corr
            return yp, fac.quad_form_diag(KT) * corr

    to_host = _ToHost(mesh is None and torch.device(device).type == "cuda")
    se = None
    vcov_pred = None
    newdataK = None
    if blocked:
        ypred_std = np.empty(U, dtype=np.float64)
        if se_pred:
            se = np.empty(U, dtype=np.float64)
        for lo in range(0, U, block_size):
            hi = min(lo + block_size, U)
            with progress.span("kernel"):
                KbT = cross_t(new_std[lo:hi].contiguous())
            yp, q = products(KbT)
            with progress.span("to_host"):
                ypred_std[lo:hi], q = to_host(yp, q)
                if se_pred:
                    se[lo:hi] = np.sqrt(q)
    else:
        with progress.span("kernel"):
            KnewT = cross_t(new_std)
        yp, q = products(KnewT, vcov=materialize_vcov)
        # U x N: a row-sharded K_newᵀ is fetched shard by shard
        sharded = isinstance(KnewT, ShardedTensor)
        with progress.span("to_host"):
            ypred_std, q, newdataK = to_host(yp, q,
                                             KnewT if sharded else KnewT.T)
            if sharded:
                newdataK = newdataK.T
            if se_pred and materialize_vcov:
                vcov_pred = q        # (U, U)
                se = np.sqrt(np.diag(vcov_pred))
            elif se_pred:
                se = np.sqrt(q)
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
        newdataK=newdataK,
        ytest=ytest,
        vcov_est_pred=vcov_pred,
        pseudoR2=pseudoR2,
        MSE=mse,
    )
