"""Arguments and methods of the JAX package that the port refused or
lacked: ``precision=`` on ``fit``/``predict``/``crossvalidate``,
``FactoredCovariance.diag``/``.scaled``, ``lambda_search(device_loop=)``,
``neffective_acf(memory_budget=)`` and the ``kernel_impl`` names "xla"
and "pallas". Float64 (and float32) on the CPU, against the JAX package
where it computes the same thing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu.lambda_search import lambda_search as jax_lambda_search
from bigkrls_tpu.ops.stats import neffective_acf as jax_neffective_acf
from bigkrls_tpu.types import Eigensystem as JaxEig
from bigkrls_tpu.types import FactoredCovariance as JaxFactored
from bigkrls_tpu_torch.lambda_search import lambda_search
from bigkrls_tpu_torch.ops import kernels, matvec
from bigkrls_tpu_torch.ops.eig import eigensystem
from bigkrls_tpu_torch.ops.stats import neffective_acf
from bigkrls_tpu_torch.types import FactoredCovariance
from bigkrls_tpu_torch.utils.precision import reduced
from data_mtcars import mtcars_xy
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)


def _same_model(a, b):
    assert a.lambda_ == b.lambda_
    for name in ("coeffs", "yfitted", "derivatives", "var_avgderivatives"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fit_precision_highest_is_bit_equal(dtype):
    y, X, _ = mtcars_xy()
    kw = dict(device="cpu", dtype=dtype, noisy=False)
    base = bt.fit(y, X, **kw)
    _same_model(bt.fit(y, X, precision="highest", **kw), base)
    # the CPU has no TF32: a reduced setting changes nothing there
    _same_model(bt.fit(y, X, precision="high", **kw), base)
    with pytest.raises(ValueError, match="precision must be one of"):
        bt.fit(y, X, precision="bogus", **kw)


def test_predict_and_crossvalidate_take_precision():
    y, X, _ = mtcars_xy()
    kw = dict(device="cpu", dtype=torch.float64, noisy=False)
    m = bt.fit(y, X, **kw)
    p0 = bt.predict(m, X[:5], se_pred=True)
    p1 = bt.predict(m, X[:5], se_pred=True, precision="highest")
    assert np.array_equal(p0.predicted, p1.predicted)
    assert np.array_equal(p0.se_pred, p1.se_pred)
    cv0 = bt.crossvalidate(y, X, seed=2, ptesting=25, **kw)
    cv1 = bt.crossvalidate(y, X, seed=2, ptesting=25, precision="highest",
                           **kw)
    assert np.array_equal(cv0.tested.predicted, cv1.tested.predicted)


def test_precision_names():
    assert not reduced("highest") and not reduced("float32")
    for name in ("high", "default", "fastest", "tensorfloat32", "bfloat16",
                 "bfloat16_3x"):
        assert reduced(name)


def test_factored_covariance_diag_and_scaled_match_jax(rng):
    Q = np.linalg.qr(rng.normal(size=(30, 7)))[0]
    s = rng.uniform(0.1, 2.0, size=7)
    ft = FactoredCovariance(torch.as_tensor(Q), torch.as_tensor(s), 1.7)
    fj = JaxFactored(jnp.asarray(Q), jnp.asarray(s), 1.7)
    assert np.max(np.abs(ft.diag().numpy() - np.asarray(fj.diag()))) <= 1e-12
    assert np.max(np.abs(ft.diag().numpy()
                         - np.diag(ft.materialize().numpy()))) <= 1e-12
    gt, gj = ft.scaled(0.3), fj.scaled(0.3)
    assert gt.scale == pytest.approx(gj.scale, rel=1e-15)
    assert gt.Q is ft.Q and gt.spectrum is ft.spectrum
    assert np.max(np.abs(gt.materialize().numpy()
                         - np.asarray(gj.materialize()))) <= 1e-12
    y, X, _ = mtcars_xy()
    m = bt.fit(y, X, device="cpu", dtype=torch.float64, noisy=False)
    assert m.vcov_c_factored.diag().shape == (32,)


def test_lambda_search_device_loop_is_accepted(rng):
    """``device_loop=True`` runs the JAX package's device loop (in the
    fit's dtype), ``device_loop=False`` its host loop: each gives its JAX
    counterpart's λ* on the same eigensystem (float64)."""
    X = rng.normal(size=(60, 3))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + 0.2 * rng.normal(size=60)
    y = (y - y.mean()) / y.std(ddof=1)
    K = kernels.gauss_kernel(torch.as_tensor(X), 3.0)
    eig = eigensystem(K)
    ej = JaxEig(values_full=jnp.asarray(eig.values_full.numpy()),
                vectors=jnp.asarray(eig.vectors.numpy()),
                lastkeeper=eig.lastkeeper)
    yt = torch.as_tensor(y)
    for device_loop in (True, False):
        lam_j = float(jax_lambda_search(ej, jnp.asarray(y),
                                        device_loop=device_loop))
        lam = lambda_search(eig, yt, device_loop=device_loop)
        assert lam == pytest.approx(lam_j, rel=1e-15, abs=0), device_loop
    assert lambda_search(eig, yt) == lambda_search(eig, yt, device_loop=True)


def test_neffective_acf_memory_budget_matches_jax(rng):
    """Above 8192 rows the budget sizes the Gram slabs; the statistic is
    the same as the JAX package's under the same budget."""
    X = rng.normal(size=(8500, 3))
    Xs = (X - X.mean(0)) / X.std(0, ddof=1)
    got = neffective_acf(torch.as_tensor(Xs), memory_budget=40 << 20)
    want = float(jax_neffective_acf(jnp.asarray(Xs), memory_budget=40 << 20))
    assert got == pytest.approx(want, rel=1e-10)
    assert got == pytest.approx(neffective_acf(torch.as_tensor(Xs)),
                                rel=1e-12)


@pytest.mark.parametrize("alias,name", [("xla", "plain"), ("pallas", "cuda")])
def test_kernel_impl_aliases(rng, alias, name):
    """The JAX names of the two implementations: "xla" is the plain
    version, "pallas" the hand-written kernel (which a CPU tensor runs as
    its plain version)."""
    assert kernels.resolve_impl(alias) == name
    X = torch.as_tensor(rng.normal(size=(40, 3)))
    V = torch.as_tensor(rng.normal(size=(40, 4)))
    assert torch.equal(matvec.kernel_matmul(X, V, 3.0, impl=alias),
                       matvec.kernel_matmul(X, V, 3.0, impl=name))
    assert torch.equal(kernels.kernel_matrix(X, 3.0, alias),
                       kernels.kernel_matrix(X, 3.0, name))
    assert torch.equal(kernels.cross_kernel_matrix(X[:5], X, 3.0, alias),
                       kernels.cross_kernel_matrix(X[:5], X, 3.0, name))
    y, Xm, _ = mtcars_xy()
    kw = dict(device="cpu", dtype=torch.float64, noisy=False)
    _same_model(bt.fit(y, Xm, kernel_impl=alias, **kw),
                bt.fit(y, Xm, kernel_impl=name, **kw))
    with pytest.raises(ValueError, match="kernel_impl must be one of"):
        kernels.resolve_impl("triton")


def test_jax_fit_takes_the_same_arguments():
    """The repaired calls are the JAX package's own: the same keywords
    run there."""
    y, X, _ = mtcars_xy()
    mj = bk.fit(y, X, precision="highest", kernel_impl="xla", noisy=False)
    mt = bt.fit(y, X, precision="highest", kernel_impl="xla", device="cpu",
                dtype=torch.float64, noisy=False)
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-9)
    assert np.max(np.abs(mt.vcov_c_factored.diag().numpy()
                         - np.asarray(mj.vcov_c_factored.diag()))) <= 1e-10
