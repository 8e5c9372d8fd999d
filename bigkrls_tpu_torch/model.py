"""The KRLS fit orchestrator, ported from ``bigkrls_tpu/model.py``.

The reference's ``bigKRLS()`` pipeline (``R/bigKRLS.R:97-516``):

  1. Gaussian kernel of the standardized X            (ops/kernels.py)
  2. symmetric eigendecomposition + eigtrunc          (ops/eig.py, ops/adaptive.py)
  3. golden-section λ search over exact LOO error     (lambda_search.py)
  4. coefficients, fitted values, factored vcov       (ops/solve.py)
  5. pointwise marginal effects + AME variances       (ops/effects.py)

on the device named by ``device=`` (default ``"cuda"``; nothing probes
for a card), or over a mesh of shards (``mesh=``, ``parallel/``). All four
routes run (``routing.select_route``): adaptive, fused and stepwise on a
stored kernel, and the streaming (kernel-free) route, which never builds
K: every product K·V is recomputed tile by tile from X (``ops/matvec.py``)
and the eigensystem comes from ``ops/eig.eigensystem_streaming``. It is
chosen by itself from ``n >= streaming_threshold`` (32768) with
``neig < n``. ``checkpoint_dir`` stores the eigendecomposition and resumes
from it (``checkpoint.py``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import checkpoint as ckpt
from .lambda_search import lambda_search, lambda_search_solve
from .ops.adaptive import postkernel_adaptive, resume_adaptive
from .ops import fused, matvec
from .ops.effects import derivatives_all, derivatives_streaming
from .ops.eig import _NAN_EIG_MSG, eigensystem, eigensystem_streaming
from .ops.kernels import kernel_matrix
from .ops.solve import solve_for_c
from .ops.stats import neffective_acf, neffective_spectral, standardize
from .parallel.sharded import (Mesh, ShardedTensor, host_gather, place,
                               rows_map, rows_reduce, shard_fit_arrays,
                               shard_info, sharded_gauss_kernel)
from .routing import select_route
from .types import Eigensystem, FactoredCovariance, KRLSModel
from .utils.precision import matmul_precision, reduced
from .utils import progress
from .utils.progress import PhaseTimer, trace

# the fit's dtype when none is passed; ``enable_x64()`` sets float64
DEFAULT_DTYPE = torch.float32


def _as_2d(X) -> np.ndarray:
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    return X


def _to_numpy(t) -> np.ndarray:
    """A tensor, or a sharded one fetched shard by shard, as host f64."""
    return host_gather(t).astype(np.float64)


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
    eig_iters: Optional[int] = None,
    fast_eig_power: Optional[bool] = None,
    ncores: Optional[int] = None,
    instructions: bool = False,
    precision: str = "highest",
    log: Callable[[str], None] = print,
) -> KRLSModel:
    t0 = time.time()
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a bigkrls_tpu_torch Mesh "
                            f"(parallel/sharded.make_mesh), got "
                            f"{type(mesh).__name__}")
        # the fit runs on the mesh's shards; what XLA runs replicated runs
        # on its first shard
        device = mesh.first_device
    device = torch.device(device)
    # a mesh's phases end when every one of its cards has finished them
    timer = PhaseTimer(device=mesh.local_devices if mesh is not None
                       else device)
    # validation, the binary-column scan, standardization, the copies to
    # the device and their placement: the "kernel" phase before K1
    prepare = progress.RECORDER.open("prepare")
    fast = reduced(precision)

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
    if eig_iters is None:
        # precision-matched Krylov depth: the deeper basis only pays at f64
        eig_iters = 8 if dtype == torch.float64 else 6
    if streaming and neig >= n:
        raise ValueError(
            "streaming=True requires a truncated eigensystem: pass neig < n "
            "(the streaming path never materializes the N x N kernel, so a "
            "full decomposition is not available).")
    if fast_eig_power is None:
        # reduced-precision power products exactly where the flow's
        # Rayleigh-Ritz recomputes K.B anyway (eig._resolve_fast_power);
        # every one of them under a reduced ``precision``
        fast_eig_power = True if fast else "auto"

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
    progress.count("host_reads", 4)    # the two copies and two reads
    x_init_sds = _to_numpy(x_sds)

    if checkpoint_dir is not None:
        # keyed by the whole standardized inputs, before any placement
        ckpt_fp = ckpt.fingerprint(X_std, sigma, neig, eigtrunc, dtype)
        sol_fp = ckpt.solution_fingerprint(y_std, tol)

    # ---- mesh placement: on a dense route X and y are row-sharded over
    # "i" and K block-sharded over ("i", "j"); on the streaming route the
    # same shards form a ring over which X and V rotate, one K2 cross
    # launch a step. Every N-row object after them (the Krylov basis, Q,
    # c, ŷ, the derivatives) stays row-sharded alike, and only k-vectors,
    # k×k blocks and scalars cross shards; on a ring that N does not divide
    # X, y and the basis stay whole (the JAX rule; the ring still splits
    # every product). ``sharding_report`` records the layouts.
    ring = at_rest = None
    if mesh is not None:
        if streaming:
            from .parallel.ring_kernel import make_ring_matmul, ring_mesh_of
            ring = ring_mesh_of(mesh)
        at_rest = ring or mesh
        if ring is None or n % ring.size == 0:
            X_std, y_std = shard_fit_arrays(at_rest, X_std, y_std)

    def laid_out(e: Eigensystem) -> Eigensystem:
        """A loaded eigensystem on the fit's device, its vectors laid out
        as the fit's N-row objects are."""
        if mesh is None:
            return e
        vecs = (place(e.vectors, at_rest, "row")
                if isinstance(X_std, ShardedTensor) else e.vectors.to(device))
        return Eigensystem(values_full=e.values_full.to(device),
                           vectors=vecs, lastkeeper=e.lastkeeper)

    load_device = device if mesh is None else "cpu"
    if ring is not None:
        product = make_ring_matmul(ring, kernel_impl)
    else:
        product = functools.partial(matvec.kernel_matmul, impl=kernel_impl)
    # the kernel-free product, for every consumer outside the eigensolver
    km = functools.partial(product, fast_accum=True) if fast else product
    progress.RECORDER.close(prepare)

    # ---- step 1: kernel ----
    if streaming:
        K = None
        if noisy:
            log("Step 1/5: kernel will be streamed tile-wise "
                "(never materialized)")
    else:
        if noisy:
            log(f"Step 1/5: Kernel (t+{time.time() - t0:.1f}s)")
        with progress.span("k1"):
            if mesh is not None:
                K = sharded_gauss_kernel(mesh, kernel_impl)(X_std, sigma)
            else:
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
        streaming=streaming, mesh_present=mesh is not None,
        checkpoint_present=checkpoint_dir is not None,
        explicit_lambda=lambda_ is not None,
        explicit_L=L is not None, explicit_U=U is not None)
    route = select_route(**route_kwargs)
    adaptive_attempted = False
    if checkpoint_dir is not None:
        if route.route == "adaptive":
            # the head pairs, completed bounds and tail quadrature, plus
            # the solution under a (y, tol) fingerprint: an identical refit
            # resumes bit-exact, a changed y/tol re-runs golden + solve
            loaded = ckpt.load_adaptive(checkpoint_dir, ckpt_fp, dtype,
                                        sol_fp, device=load_device)
            if loaded is not None:
                adaptive_out, sol = loaded
                adaptive_out.eig = laid_out(adaptive_out.eig)
                eig = adaptive_out.eig
                if sol is not None and mesh is not None:
                    sol = (sol[0], sol[1],
                           place(sol[2], at_rest, "row")
                           if isinstance(X_std, ShardedTensor)
                           else sol[2].to(device))
                eig_path = "checkpoint"
                if noisy:
                    log(f"Steps 2-4: adaptive truncation (resumed from "
                        f"checkpoint{' incl. solution' if sol else ''}) "
                        f"(t+{time.time() - t0:.1f}s)")
                if sol is not None:
                    fused_out = sol
                else:
                    fused_out = resume_adaptive(adaptive_out, y_std, tol)
                    # store the new solution; the vectors stay as written
                    ckpt.update_adaptive_solution(
                        checkpoint_dir, ckpt_fp, sol_fp, lam=fused_out[0],
                        Le=fused_out[1], coeffs=fused_out[2])
        if eig is None:
            eig = ckpt.load_eig(checkpoint_dir, ckpt_fp, dtype,
                                device=load_device)
            if eig is not None:
                eig = laid_out(eig)
                eig_path = "checkpoint"
                if noisy:
                    log(f"Step 2/5: Spectral decomposition (resumed from "
                        f"checkpoint) (t+{time.time() - t0:.1f}s)")
    if eig is None and route.route == "adaptive":
        adaptive_attempted = True
        if noisy:
            log(f"Steps 2-4: adaptive truncation (block-Krylov eig + "
                f"lambda search + solve) (t+{time.time() - t0:.1f}s)")
        res = postkernel_adaptive(K, y_std, eigtrunc, tol, noisy=noisy,
                                  mesh=mesh, log=log)
        if res is not None:
            adaptive_out, lam_a, Le_a, coeffs_a, adaptive_spec = res
            eig = adaptive_out.eig
            eig_path = f"adaptive-krylov:k={adaptive_out.k}"
            fused_out = (lam_a, Le_a, coeffs_a)
            if checkpoint_dir is not None:
                ckpt.save_adaptive(
                    checkpoint_dir, ckpt_fp, adaptive_out, sol_fp=sol_fp,
                    lam=lam_a, Le=Le_a, coeffs=coeffs_a)
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
        # the heartbeat ticks only fits long enough to need progress, as
        # the JAX fit gates it; its sink is this fit's log, released after
        heartbeat = noisy and n > fused.HEARTBEAT_MIN_N
        if heartbeat:
            fused.set_heartbeat_log(log)
        try:
            vals, vecs, lk, lam_f, Le_f, coeffs_f, _spec, iters = \
                fused.postkernel_device(K, y_std, eigtrunc, tol,
                                        log=log if noisy else None,
                                        heartbeat=heartbeat)
        finally:
            if heartbeat:
                fused.set_heartbeat_log(print)
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
        if streaming:
            report = None
            if noisy:
                report = lambda d, t: log(
                    f"  subspace power iteration {d}/{t} "
                    f"(t+{time.time() - t0:.1f}s)")
            eig = eigensystem_streaming(
                X_std, sigma, neig=neig, eigtrunc=eigtrunc, iters=eig_iters,
                fast_power=fast_eig_power, progress=report,
                impl=kernel_impl, mesh=ring,
                matmul=product if ring is not None else None)
            eig_path = "streaming-krylov"
        else:
            eig = eigensystem(K, neig=neig, eigtrunc=eigtrunc,
                              method=eig_method, mesh=mesh)
            eig_path = f"stepwise:{eig_method}"
        if checkpoint_dir is not None:
            ckpt.save_eig(checkpoint_dir, ckpt_fp, eig)
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

    def residual_variance(yhat_std):
        progress.count("host_reads")
        return float(rows_reduce(lambda a, b: torch.sum((a - b) * (a - b)),
                                 y_std, yhat_std)) / n   # ref :294

    # On the kernel-free route every product pays a full rebuild of K, and
    # the derivatives' stacked right-hand side already carries c as its
    # first column: ŷ, and with it σ̂², come out of that one product in
    # step 5, not out of a width-1 product of their own.
    yhat_from_derivatives = streaming and derivative
    yfitted_std = sigmasq = spectrum = None
    if not yhat_from_derivatives:
        if streaming:
            yfitted_std = rows_map(lambda t: t[:, 0], km(
                X_std, rows_map(lambda c: c[:, None].contiguous(), coeffs),
                sigma))
        else:
            yfitted_std = K @ coeffs
        sigmasq = residual_variance(yfitted_std)
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
        X_est = rows_map(lambda x: x[:, cols], X_std)
        bmask = torch.as_tensor(x_is_binary[cols], device=device)
        progress.count("host_reads", 2)   # the index list's copy, bmask's
        z0 = rows_reduce(lambda x: torch.amin(x, dim=0), X_est, op="min")
        z1 = rows_reduce(lambda x: torch.amax(x, dim=0), X_est, op="max")
        if yhat_from_derivatives:
            # the AME variances come back under the unscaled filter
            # 1/(λ+λ*)², since σ̂² needs this product's ŷ; it is applied after
            filt = 1.0 / (eig.values + lambda_) ** 2
            dres = derivatives_streaming(X_std, cols, coeffs, eig.vectors,
                                         filt, sigma, bmask, z0, z1,
                                         matmul=km)
            yfitted_std = dres.yfitted_std
            sigmasq = residual_variance(yfitted_std)
            spectrum = sigmasq * filt
            var_avg_std = sigmasq * dres.var_avgderiv
        else:
            dres = derivatives_all(X_est, K, coeffs, eig.vectors, spectrum,
                                   sigma, bmask, z0, z1)
            var_avg_std = dres.var_avgderiv
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
        varavgderiv = _to_numpy(var_avg_std) * sd_ratio ** 2
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

    sharding_report = None
    if mesh is not None:
        # each heavy object's layout as the work ran on it, in the JAX
        # keys; "devices" counts distinct shards
        sharding_report = {"Q": shard_info(eig.vectors, mesh),
                           "yfitted": shard_info(yfitted_std, mesh),
                           "X_std": shard_info(X_std, mesh)}
        if K is not None:
            sharding_report["K"] = shard_info(K, mesh)
        if derivative:
            sharding_report["derivatives"] = shard_info(dres.derivatives,
                                                        mesh)

    if isinstance(Le, torch.Tensor):
        progress.count("host_reads")      # read below, in float(Le)
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
        timings=timer.finish(),
        sharding_report=sharding_report,
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
            "detail, bigkrls_tpu_torch.predict() for out-of-sample "
            "forecasts, bigkrls_tpu_torch.plot_effects() or "
            "effects_explorer() to visualize results, "
            "bigkrls_tpu_torch.crossvalidate() for CV, and "
            "bigkrls_tpu_torch.save_model()/load_model() for persistence.")
    return model


def fit(y, X, *, precision: str = "highest",
        model_subfolder_name: Optional[str] = None,
        overwrite_existing: bool = False, trace_dir: Optional[str] = None,
        **kwargs) -> KRLSModel:
    """Fit a KRLS model; see ``_fit_impl`` for the arguments. Defaults
    follow the reference's ``bigKRLS()``: sigma = P,
    eigtrunc 0.001 above N = 3000, tol = N/1000, λ by golden search.
    ``streaming=True`` (by itself from ``streaming_threshold`` rows with
    ``neig < n``) never builds the N×N kernel; ``eig_iters`` is its
    Krylov depth (8 at f64, 6 at f32) and ``fast_eig_power`` forces or
    forbids TF32 on the eigensolver's power products (default: only in
    the flows whose Rayleigh–Ritz recomputes K·B).

    ``precision`` (the JAX package's names, ``utils/precision``):
    "highest" (the default) runs every matrix product in IEEE fp32, no
    TF32, and K2 in its precise split-TF32 mode. The lower settings
    ("high", "default", "fastest", ...) allow TF32 on cuBLAS products and
    on K2's tile·V (its ``fast_accum`` mode, the eigensolver's power
    products included); the rank-P distance part of both kernels stays
    IEEE fp32. On the CPU and at float64 the setting changes nothing.

    ``mesh`` (``parallel/sharded.make_mesh``, or ``parallel/distributed.
    global_mesh`` across processes; its shards may repeat one device) runs
    the fit over a mesh: on a dense route K is block-sharded with one K1
    launch per block and every product with K a block product; on the
    streaming route the shards form a ring and each product is D² launches
    of K2's cross entry. X, y, the Krylov basis, Q, c, ŷ and the
    derivatives stay row-sharded throughout, and only k-vectors, k×k
    blocks and scalars cross shards, until the model's numpy fields are
    fetched at the end. ``device`` is then the mesh's first shard.
    ``model.sharding_report`` records each heavy object's layout (the JAX
    keys); the model keeps K block-sharded and the covariance's Q
    row-sharded, which ``summary``, ``predict``, ``save_model`` and
    ``crossvalidate`` take as they are.

    ``checkpoint_dir`` stores the eigendecomposition there and resumes
    from it on a later fit with the same standardized X and eig
    configuration (``checkpoint.py``).

    ``model_subfolder_name`` saves the fitted model to that folder and
    sets ``model.path`` (the reference's save-during-fit option, with an
    integer suffix on collision unless ``overwrite_existing``).

    ``trace_dir`` runs the fit under ``torch.profiler`` (host activity,
    and the card's kernels on a CUDA device) and writes a TensorBoard /
    Chrome trace there, with the fit's spans (``utils/progress``) as
    ranges named ``bigkrls.fit/<phase>/...``.

    Every fit records its spans (``utils.progress.spans()``): the call
    ``fit``, the five phases of ``model.timings`` under it, and inside
    them ``prepare`` and ``k1``; on the adaptive route ``krylov``,
    ``bounds``, ``lambda_search`` and ``check`` per attempt; on the
    streaming route ``krylov`` and ``ritz``."""
    device = kwargs.get("device", "cuda")
    devices = [device]
    if isinstance(kwargs.get("mesh"), Mesh):
        device = kwargs["mesh"].first_device
        devices = kwargs["mesh"].local_devices
    with matmul_precision(precision), trace(trace_dir, device), \
            progress.span("fit", device=progress.one_card(devices)):
        model = _fit_impl(y, X, precision=precision, **kwargs)
    if model_subfolder_name is not None:
        from .persistence import save_model
        model.path = save_model(model, model_subfolder_name,
                                overwrite_existing=overwrite_existing)
    return model


# R-flavored alias matching the reference entry point name
bigKRLS = fit
