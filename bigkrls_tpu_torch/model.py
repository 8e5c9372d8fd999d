"""The KRLS fit orchestrator, ported from ``bigkrls_tpu/model.py``.

The reference's ``bigKRLS()`` pipeline (``R/bigKRLS.R:97-516``):

  1. Gaussian kernel of the standardized X            (ops/kernels.py)
  2. symmetric eigendecomposition + eigtrunc          (ops/eig.py, ops/adaptive.py)
  3. golden-section λ search over exact LOO error     (lambda_search.py)
  4. coefficients, fitted values, factored vcov       (ops/solve.py)
  5. pointwise marginal effects + AME variances       (ops/effects.py)

on one device, named by ``device=`` (default ``"cuda"``; nothing probes
for a card). The single-device dense routes run: adaptive, fused and
stepwise (``routing.select_route``). A mesh, a checkpoint directory and
the streaming route raise ``NotImplementedError`` naming the ROADMAP item
that ports them; none of them silently runs the dense path instead.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .lambda_search import lambda_search, lambda_search_solve
from .ops.adaptive import postkernel_adaptive
from .ops.effects import derivatives_all
from .ops.eig import _NAN_EIG_MSG, eigensystem
from .ops.fused import postkernel_device
from .ops.kernels import kernel_matrix
from .ops.solve import solve_for_c
from .ops.stats import neffective_acf, neffective_spectral, standardize
from .routing import select_route
from .types import Eigensystem, FactoredCovariance, KRLSModel
from .utils.precision import ieee_fp32
from .utils.progress import PhaseTimer

# the fit's dtype when none is passed; ``enable_x64()`` sets float64
DEFAULT_DTYPE = torch.float32


def _as_2d(X) -> np.ndarray:
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    return X


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _validate(X: np.ndarray, y: np.ndarray) -> None:
    """Input validation mirroring ``R/bigKRLS.R:183-224`` and
    ``check_data``."""
    if np.isnan(X).any():
        bad = [i for i in range(X.shape[1]) if np.isnan(X[:, i]).any()]
        raise ValueError(
            f"the following columns in X contain missing data, which must "
            f"be removed: {bad}")
    sds = X.std(axis=0, ddof=1)
    if (sds == 0).any():
        bad = [i for i in range(X.shape[1]) if sds[i] == 0]
        raise ValueError(
            f"The following columns in X are constant and must be removed: {bad}")
    if X.shape[0] != y.shape[0]:
        raise ValueError("nrow(X) not equal to number of elements in y.")
    if np.isnan(y).any():
        raise ValueError("y contains missing data.")
    if y.std(ddof=1) == 0:
        raise ValueError("y is a constant.")


def check_data(y, X, **kwargs) -> None:
    """Dry-run validator (reference ``check_data``)."""
    X = _as_2d(X).astype(np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    _validate(X, y)


def _fit_impl(
    y,
    X,
    *,
    device="cuda",
    dtype=None,
    sigma: Optional[float] = None,
    derivative: bool = True,
    which_derivatives: Optional[Sequence[int]] = None,
    vcov_est: bool = True,
    neig: Optional[int] = None,
    eigtrunc: Optional[float] = None,
    lambda_: Optional[float] = None,
    L: Optional[float] = None,
    U: Optional[float] = None,
    tol: Optional[float] = None,
    acf: bool = False,
    noisy: Optional[bool] = None,
    xlabs: Optional[Sequence[str]] = None,
    eig_method: str = "auto",
    kernel_impl: str = "auto",
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    streaming: Optional[bool] = None,
    streaming_threshold: int = 32768,
    ncores: Optional[int] = None,
    instructions: bool = False,
    log: Callable[[str], None] = print,
) -> KRLSModel:
    t0 = time.time()
    device = torch.device(device)
    timer = PhaseTimer(device=device)

    if mesh is not None:
        raise NotImplementedError(
            "fit(mesh=...): multi-device fits are not ported yet (ROADMAP "
            "queue 1, item 18)")
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "fit(checkpoint_dir=...): checkpointing is not ported yet "
            "(ROADMAP queue 1, item 15)")

    if xlabs is None and hasattr(X, "columns"):
        xlabs = [str(c) for c in X.columns]
    X_np = _as_2d(X).astype(np.float64)
    y_np = np.asarray(y).reshape(-1).astype(np.float64)
    n, p = X_np.shape

    dtype = DEFAULT_DTYPE if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be torch.float32 or torch.float64, "
                        f"got {dtype}")

    if xlabs is None:
        xlabs = [f"x{i + 1}" for i in range(p)]
    xlabs = [lab if lab else f"x{i + 1}" for i, lab in enumerate(xlabs)]
    _validate(X_np, y_np)

    noisy = (n > 2000) if noisy is None else bool(noisy)
    if ncores is not None and noisy:
        log("Note: ncores is accepted for reference-API compatibility but "
            "has no effect (no process pool).")
    acf = bool(acf) and p > 2

    neig = n if neig is None else min(n, int(neig))
    if eigtrunc is None:
        eigtrunc = 0.001 if n > 3000 else 0.0
        if n > 3000 and noisy:
            log("Using eigentruncation = 0.001 to speed up computation.")
    elif not (0.0 <= eigtrunc <= 1.0):
        raise ValueError("eigtrunc must be between 0 (no truncation) and 1 "
                         "(keep largest only).")

    if which_derivatives is not None:
        if not derivative:
            raise ValueError("which_derivatives requires derivative=True")
        which_derivatives = list(int(i) for i in which_derivatives)
        if not all(0 <= i < p for i in which_derivatives):
            raise ValueError("which_derivatives indices out of range (0-based)")
    if lambda_ is not None and not lambda_ > 0:
        raise ValueError("lambda_ must be positive")
    sigma = float(p) if sigma is None else float(sigma)
    if not sigma > 0:
        raise ValueError("sigma must be positive")
    if derivative and not vcov_est:
        raise ValueError("vcov_est is needed to get derivatives "
                         "(derivative=True requires vcov_est=True).")
    if tol is None:
        tol = n / 1000.0

    if streaming is None:
        streaming = n >= streaming_threshold and neig < n
    if streaming:
        raise NotImplementedError(
            "the streaming (kernel-free) fit is not ported yet (ROADMAP "
            "queue 1, items 11-13); it is chosen for neig < n at "
            f"n >= streaming_threshold={streaming_threshold}")

    # binary (first-difference) columns: exactly two unique values
    x_is_binary = np.array(
        [np.unique(X_np[:, j]).size == 2 for j in range(p)])
    if noisy and x_is_binary.any():
        log("First differences will be computed for the following (binary) "
            f"columns of X: {list(np.nonzero(x_is_binary)[0])}")

    # ---- standardization (ddof=1, reference :251-254) ----
    Xd = torch.as_tensor(X_np, dtype=dtype, device=device)
    yd = torch.as_tensor(y_np, dtype=dtype, device=device)
    X_std, y_std, x_means, x_sds, y_mean, y_sd = standardize(Xd, yd)
    y_init_sd = float(y_sd)
    y_init_mean = float(y_mean)
    x_init_sds = _to_numpy(x_sds)

    # ---- step 1: kernel ----
    if noisy:
        log(f"Step 1/5: Kernel (t+{time.time() - t0:.1f}s)")
    K = kernel_matrix(X_std, sigma, kernel_impl)
    timer.mark("kernel")

    # ---- steps 2-4 by route ----
    eig = None
    eig_path = None
    adaptive_out = None
    adaptive_spec = None
    fused_out = None
    route_kwargs = dict(
        n=n, neig=neig, eigtrunc=eigtrunc, eig_method=eig_method,
        explicit_lambda=lambda_ is not None, explicit_L=L is not None,
        explicit_U=U is not None)
    route = select_route(**route_kwargs)
    adaptive_attempted = route.route == "adaptive"
    if adaptive_attempted:
        if noisy:
            log(f"Steps 2-4: adaptive truncation (block-Krylov eig + "
                f"lambda search + solve) (t+{time.time() - t0:.1f}s)")
        res = postkernel_adaptive(K, y_std, eigtrunc, tol, noisy=noisy,
                                  log=log)
        if res is not None:
            adaptive_out, lam_a, Le_a, coeffs_a, adaptive_spec = res
            eig = adaptive_out.eig
            eig_path = f"adaptive-krylov:k={adaptive_out.k}"
            fused_out = (lam_a, Le_a, coeffs_a)
            if noisy:
                log(f"Lambda: {lam_a:.6g} (t+{time.time() - t0:.1f}s)")
        else:
            # declined at runtime (flat spectrum): the one feedback edge
            route = select_route(adaptive_declined=True, **route_kwargs)
    if adaptive_out is None and eig_method == "adaptive":
        eig_method = "auto"   # documented fallback: exact dense path
    if eig is None and route.route == "fused":
        if noisy:
            log(f"Steps 2-4: eigendecomposition + lambda search + solve "
                f"(t+{time.time() - t0:.1f}s)")
        vals, vecs, lk, lam_f, Le_f, coeffs_f, _spec, iters = \
            postkernel_device(K, y_std, eigtrunc, tol,
                              log=log if noisy else None)
        if torch.isnan(vals).any():
            raise ValueError(_NAN_EIG_MSG)
        eig = Eigensystem(values_full=vals, vectors=vecs[:, :lk],
                          lastkeeper=lk)
        eig_path = ("eigh-fused(adaptive-fallback)" if adaptive_attempted
                    else "eigh-fused")
        fused_out = (lam_f, Le_f, coeffs_f)
        if noisy:
            log(f"Lambda: {lam_f:.6g} selected in {iters} golden-section "
                f"iterations (t+{time.time() - t0:.1f}s)")
    if eig is None:
        if noisy:
            log(f"Step 2/5: Spectral decomposition "
                f"(t+{time.time() - t0:.1f}s)")
        eig = eigensystem(K, neig=neig, eigtrunc=eigtrunc, method=eig_method)
        eig_path = f"stepwise:{eig_method}"
    timer.mark("eigendecomposition")

    # ---- step 3: λ search ----
    if fused_out is not None:
        lambda_ = fused_out[0]
    if lambda_ is None:
        if noisy:
            log(f"Step 3/5: Golden search for lambda "
                f"(t+{time.time() - t0:.1f}s)")
            lambda_ = lambda_search(eig, y_std, L=L, U=U, tol=tol,
                                    noisy=True, log=log)
        else:
            fused_out = lambda_search_solve(eig, y_std, L=L, U=U, tol=tol)
            lambda_ = fused_out[0]
    elif noisy and fused_out is None:
        log("Skipping step 3/5, proceeding with user-inputted lambda.")
    timer.mark("lambda_search")

    if adaptive_out is not None:
        neff = adaptive_out.neffective(lambda_, n)
    else:
        neff = neffective_spectral(eig.values_full, lambda_, n)
    if noisy:
        log(f"Effective sample size: {neff:.2f}")

    # ---- step 4: coefficients & fits ----
    if noisy and fused_out is None:
        log(f"Step 4/5: Coefficients & related estimates "
            f"(t+{time.time() - t0:.1f}s)")
    if fused_out is not None:
        Le, coeffs = fused_out[1], fused_out[2]
    else:
        Le, coeffs = solve_for_c(eig, y_std, lambda_)
    yfitted_std = K @ coeffs
    resid = y_std - yfitted_std
    sigmasq = float(torch.sum(resid * resid)) / n   # ref :294
    spectrum = None
    if vcov_est:
        if adaptive_spec is not None:
            spectrum = sigmasq * adaptive_spec
        else:
            spectrum = sigmasq / (eig.values + lambda_) ** 2
    timer.mark("coefficients")

    # ---- step 5: marginal effects ----
    derivatives = avgderiv = varavgderiv = None
    R2AME = None
    if derivative:
        if noisy:
            log(f"Step 5/5: Marginal effects (t+{time.time() - t0:.1f}s)")
        cols = (which_derivatives if which_derivatives is not None
                else list(range(p)))
        X_est = X_std[:, cols]
        bmask = torch.as_tensor(x_is_binary[cols], device=device)
        z0 = torch.amin(X_est, dim=0)
        z1 = torch.amax(X_est, dim=0)
        dres = derivatives_all(X_est, K, coeffs, eig.vectors, spectrum,
                               sigma, bmask, z0, z1)
        deriv_std_np = _to_numpy(dres.derivatives)

        # R2AME on standardized X vs original y (ref :390-392)
        X_est_np = ((X_np - _to_numpy(x_means)) / x_init_sds)[:, cols]
        yhat_ame = X_est_np @ deriv_std_np.mean(axis=0)
        if yhat_ame.std() > 0:
            R2AME = float(np.corrcoef(y_np, yhat_ame)[0, 1] ** 2)
        else:
            R2AME = float("nan")

        # rescale to original units (ref :394-407)
        sd_ratio = y_init_sd / x_init_sds[cols]
        derivatives = deriv_std_np * sd_ratio[None, :]
        varavgderiv = _to_numpy(dres.var_avgderiv) * sd_ratio ** 2
        avgderiv = derivatives.mean(axis=0)
    timer.mark("derivatives")

    neff_acf = None
    if acf:
        if noisy:
            log("Accumulating absolute pairwise correlations within X "
                "(acf Neffective)")
        neff_acf = float(neffective_acf(X_std))

    vcov_c_fac = None
    if vcov_est:
        # vcov.est.c in original y units = y.init.sd² × (Q S Qᵀ) (ref :438)
        vcov_c_fac = FactoredCovariance(eig.vectors, spectrum,
                                        scale=y_init_sd ** 2)

    yfitted = _to_numpy(yfitted_std) * y_init_sd + y_init_mean
    R2 = float(1.0 - np.var(y_np - yfitted, ddof=1) / y_init_sd ** 2)

    model = KRLSModel(
        X=X_np,
        y=y_np,
        K=K,
        xlabs=list(xlabs),
        coeffs=_to_numpy(coeffs),
        yfitted=yfitted,
        sigma=sigma,
        lambda_=float(lambda_),
        looe=float(Le) * y_init_sd,
        R2=R2,
        R2AME=R2AME,
        K_eigenvalues=_to_numpy(eig.values_full),
        lastkeeper=eig.lastkeeper,
        neffective=neff,
        neffective_acf=neff_acf,
        derivatives=derivatives,
        avgderivatives=avgderiv,
        var_avgderivatives=varavgderiv,
        binaryindicator=x_is_binary,
        which_derivatives=which_derivatives,
        vcov_c_factored=vcov_c_fac,
        sigmasq_std=sigmasq if vcov_est else None,
        y_mean=y_init_mean,
        y_sd=y_init_sd,
        x_means=_to_numpy(x_means),
        x_sds=x_init_sds,
        timings=timer.phases,
        eig_path=eig_path,
        eig_tail_theta=(adaptive_out.tail_theta if adaptive_out is not None
                        else None),
        eig_tail_w=(adaptive_out.tail_w if adaptive_out is not None
                    else None),
    )
    if noisy:
        log(f"Done (t+{time.time() - t0:.1f}s)")
    if instructions:
        log("All done. You may wish to use bigkrls_tpu_torch.summary() for "
            "detail and bigkrls_tpu_torch.predict() for out-of-sample "
            "forecasts.")
    return model


def fit(y, X, **kwargs) -> KRLSModel:
    """Fit a KRLS model on one device; see ``_fit_impl`` for the
    arguments. Defaults follow the reference's ``bigKRLS()``: sigma = P,
    eigtrunc 0.001 above N = 3000, tol = N/1000, λ by golden search.
    Matrix products run in IEEE fp32 (no TF32) throughout."""
    with ieee_fp32():
        return _fit_impl(y, X, **kwargs)


# R-flavored alias matching the reference entry point name
bigKRLS = fit
