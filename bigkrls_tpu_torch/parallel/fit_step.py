"""The fused single-device KRLS fit core and the package's entry points
``entry()`` and ``dryrun_multichip(n)``, ported from
``bigkrls_tpu/parallel/fit_step.py`` and the repository's
``__graft_entry__.py``.

``fit_step`` is the whole post-standardization pipeline at a given λ:
kernel (the dense kernel K1 on an f32 CUDA tensor, its plain version
elsewhere) → ``eigh`` → spectral solve → fitted values → every marginal
effect. The multi-device fit is not a separate program: ``fit(mesh=…)``
shards the one user pipeline, and :func:`dryrun_multichip` drives exactly
that.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.effects import derivatives_all
from ..ops.kernels import kernel_matrix
from ..utils.precision import ieee_fp32


class FitStepResult(NamedTuple):
    coeffs: torch.Tensor
    yfitted: torch.Tensor
    looloss: torch.Tensor
    derivatives: torch.Tensor
    var_avgderiv: torch.Tensor
    eigenvalues: torch.Tensor


def _fit_core(X_std, y_std, lam, sigma: float, binary_mask):
    n = X_std.shape[0]
    K = kernel_matrix(X_std, sigma)
    vals, vecs = torch.linalg.eigh(K)
    vals = vals.flip(0)
    vecs = -vecs.flip(1)

    filt = 1.0 / (vals + lam)
    Qty = vecs.T @ y_std
    coeffs = vecs @ (Qty * filt)
    ginv_diag = (vecs * vecs) @ filt
    loo = torch.sum((coeffs / ginv_diag) ** 2)

    yfitted = K @ coeffs
    resid = y_std - yfitted
    sigmasq = torch.sum(resid * resid) / n
    spectrum = sigmasq * filt * filt

    z0 = torch.amin(X_std, dim=0)
    z1 = torch.amax(X_std, dim=0)
    dres = derivatives_all(X_std, K, coeffs, vecs, spectrum, sigma,
                           binary_mask, z0, z1)
    return FitStepResult(coeffs, yfitted, loo, dres.derivatives,
                         dres.var_avgderiv, vals)


def fit_step(X_std, y_std, lam, binary_mask, sigma: float) -> FitStepResult:
    """The single-device KRLS fit core on standardized inputs (tensors on
    one device), in IEEE fp32 products."""
    with ieee_fp32():
        return _fit_core(X_std, y_std, lam, float(sigma), binary_mask)


def _example_data(n=256, p=8, dtype=torch.float32, device="cuda"):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, p))
    X[:, -1] = (X[:, -1] > 0).astype(float)   # one binary column
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    binary = np.array([np.unique(X[:, j]).size == 2 for j in range(p)])

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return t(X), t(y), t(0.5), t(binary, torch.bool)


def entry(device="cuda", dtype=torch.float32):
    """``(fn, example_args)``: the fit core and its example inputs, so that
    ``fn(*args)`` runs one whole fit at a given λ."""
    import functools
    X, y, lam, mask = _example_data(dtype=dtype, device=device)
    return functools.partial(fit_step, sigma=float(X.shape[1])), (X, y, lam,
                                                                  mask)


def dryrun_multichip(n_devices: int, device="cuda", dtype=None) -> None:
    """Run the user-facing ``fit(mesh=…)`` three times over a mesh of
    ``n_devices`` shards of ``device`` (virtual shards when they repeat
    one device), as the JAX package's ``dryrun_multichip`` does:

    1. the dense route on a 2-D ("i", "j") mesh: X row-sharded, K
       block-sharded, marginal effects for every column incl. a binary one;
    2. the adaptive route under the same mesh at N=2048;
    3. the streaming (kernel-free) route on the ring of the same shards.

    Checks that the heavy objects were laid out over the mesh (the
    ``sharding_report``) and that the estimates are finite and agree."""
    from ..model import fit
    from .sharded import make_mesh

    mesh = make_mesh(devices=[torch.device(device)] * n_devices)
    kw = dict(device=device, noisy=False)
    if dtype is not None:
        kw["dtype"] = dtype
    n, p = 16 * n_devices, 4
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, p))
    X[:, -1] = (X[:, -1] > 0).astype(float)   # one binary column
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)

    m = fit(y, X, mesh=mesh, **kw)
    rep = m.sharding_report
    for name in ("K", "Q", "derivatives"):
        info = rep[name]
        assert not info["replicated"], (name, info)
        if mesh.shape[0] > 1:
            assert info["shard_shape"][0] < info["shape"][0], (name, info)
    assert rep["K"]["devices"] == n_devices, rep["K"]
    assert np.isfinite(m.coeffs).all() and np.isfinite(m.derivatives).all()

    na = 2048
    Xa = rng.normal(size=(na, 3))
    ya = np.sin(Xa[:, 0]) + Xa[:, 1] + 0.2 * rng.normal(size=na)
    ma = fit(ya, Xa, mesh=mesh, eigtrunc=0.001, derivative=False, **kw)
    assert ma.eig_path.startswith("adaptive-krylov"), ma.eig_path
    assert not ma.sharding_report["K"]["replicated"]
    assert not ma.sharding_report["Q"]["replicated"]
    assert np.isfinite(ma.coeffs).all()

    ms = fit(y, X, mesh=mesh, streaming=True, neig=n // 4, **kw)
    assert ms.K is None
    reps = ms.sharding_report
    assert not reps["Q"]["replicated"]
    assert not reps["X_std"]["replicated"]
    assert reps["X_std"]["shard_shape"][0] == n // n_devices
    assert np.isfinite(ms.coeffs).all()
    assert abs(m.R2 - ms.R2) < 0.2, (m.R2, ms.R2)
