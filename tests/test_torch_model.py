"""Port vs JAX end to end: ``fit``, ``predict``, ``summary`` and
``convert`` on the in-repo oracles (the mtcars goldens, the published
numeric-convergence AMEs), float64 on the CPU."""
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu_torch import convert
from bigkrls_tpu_torch import model as tmodel
from bigkrls_tpu_torch.utils.precision import ieee_fp32
from data_mtcars import COROLLA_INDEX, COROLLA_KERNEL_GOLDEN, mtcars_xy
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def rng():
    """The conftest's generator (seed 1234), fresh for this file: the
    session-scoped one's state depends on which files a test worker ran
    before this one, and the tests here read it in file order."""
    return np.random.default_rng(1234)


@pytest.fixture(scope="module")
def mtcars_fits():
    y, X, labs = mtcars_xy()
    mj = bk.fit(y, X, eigtrunc=0.0, xlabs=labs, noisy=False)
    mt = bt.fit(y, X, eigtrunc=0.0, xlabs=labs, noisy=False, **CPU64)
    return mt, mj, y, X


def test_fit_matches_jax(mtcars_fits):
    mt, mj, _, _ = mtcars_fits
    assert mt.eig_path == mj.eig_path == "eigh-fused"
    assert mt.lastkeeper == mj.lastkeeper
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-9)
    for name in ("coeffs", "yfitted", "derivatives", "avgderivatives",
                 "K_eigenvalues"):
        assert np.max(np.abs(getattr(mt, name)
                             - np.asarray(getattr(mj, name)))) <= 1e-10, name
    assert np.allclose(mt.var_avgderivatives, mj.var_avgderivatives,
                       rtol=1e-9)
    for name in ("R2", "R2AME", "neffective", "looe", "sigmasq_std"):
        assert getattr(mt, name) == pytest.approx(getattr(mj, name),
                                                  rel=1e-9), name
    assert list(mt.binaryindicator) == list(mj.binaryindicator)
    assert [t["phase"] for t in mt.timings] == [
        "kernel", "eigendecomposition", "lambda_search", "coefficients",
        "derivatives"]


def test_corolla_kernel_row_golden(mtcars_fits):
    mt = mtcars_fits[0]
    s = mt.K[:, COROLLA_INDEX].numpy()
    assert np.max(np.abs(s - COROLLA_KERNEL_GOLDEN)) < 0.01
    assert s[COROLLA_INDEX] == 1.0


def test_prediction_quantile_golden(mtcars_fits):
    mt, _, y, X = mtcars_fits
    Xnew = X.copy()
    Xnew[:, 2] = 200.0
    assert np.mean(bt.predict(mt, Xnew).predicted < y) == 0.6875


def test_predict_with_se_matches_jax(mtcars_fits):
    mt, mj, _, X = mtcars_fits
    pt = bt.predict(mt, X[:10], se_pred=True)
    pj = bk.predict(mj, X[:10], se_pred=True)
    assert np.max(np.abs(pt.predicted - pj.predicted)) <= 1e-10
    assert np.allclose(pt.se_pred, pj.se_pred, rtol=1e-9)
    assert np.max(np.abs(pt.newdataK - np.asarray(pj.newdataK))) <= 1e-12
    # the dense covariance path and the (N/Neff)^1/4 quirk
    pm = bt.predict(mt, X[:10], se_pred=True, materialize_vcov=True)
    assert np.allclose(pm.se_pred, pt.se_pred, rtol=1e-10)
    raw = bt.predict(mt, X[:10], se_pred=True, correct_SE=False)
    assert np.allclose(pt.se_pred / raw.se_pred,
                       (mt.n / mt.neffective) ** 0.25, rtol=1e-12)
    # the blocked path gives the same numbers and no stored cross kernel
    pb = bt.predict(mt, X[:10], se_pred=True, block_size=3, ytest=X[:10, 0])
    assert pb.newdataK is None
    assert np.max(np.abs(pb.predicted - pt.predicted)) <= 1e-12
    assert np.allclose(pb.se_pred, pt.se_pred, rtol=1e-12)
    assert pb.MSE is not None and pb.pseudoR2 is not None
    # in-sample prediction reproduces the fitted values
    assert np.max(np.abs(bt.predict(mt, X).predicted - mt.yfitted)) < 1e-8


@pytest.mark.parametrize("degrees", ["Neffective", "N", "acf"])
def test_summary_matches_jax(mtcars_fits, degrees):
    mt, mj, _, X = mtcars_fits
    st = bt.summary(mt, degrees=degrees)
    sj = bk.summary(mj, degrees=degrees)
    assert st.labels == sj.labels
    assert st.labels[6].endswith("*") and st.labels[7].endswith("*")
    assert np.allclose(st.ttests, sj.ttests, rtol=1e-8, atol=1e-12)
    assert np.all((st.ttests[:, 3] >= 0) & (st.ttests[:, 3] <= 1))
    assert np.allclose(st.percentiles, sj.percentiles, rtol=1e-9)
    assert "Average Marginal Effects" in str(st)


def test_published_numeric_convergence_ames():
    """The reference's published 7-digit AMEs (set.seed(2018), N=500,
    eigtrunc=0.01) through the port, rel 5e-7 like the JAX oracle."""
    from r_rng import PUBLISHED_AVGDERIVATIVES, numeric_convergence_data
    y, X = numeric_convergence_data()
    m = bt.fit(y, X, eigtrunc=0.01, noisy=False, **CPU64)
    assert m.eig_path == "eigh-fused"
    rel = (np.abs(m.avgderivatives - PUBLISHED_AVGDERIVATIVES)
           / np.abs(PUBLISHED_AVGDERIVATIVES))
    assert np.max(rel) < 5e-7, rel


def test_model_from_reference_predicts_like_jax(mtcars_fits):
    """A JAX fit turned into the port's model predicts (and summarizes)
    exactly as the JAX package does."""
    _, mj, _, X = mtcars_fits
    mc = convert.model_from_reference(mj, device="cpu", dtype=torch.float64)
    assert mc.K is None and isinstance(mc.vcov_c_factored.Q, torch.Tensor)
    Xn = X[:7] + 0.25
    pt = bt.predict(mc, Xn, se_pred=True)
    pj = bk.predict(mj, Xn, se_pred=True)
    assert np.max(np.abs(pt.predicted - pj.predicted)) <= 1e-12
    assert np.allclose(pt.se_pred, pj.se_pred, rtol=1e-12)
    assert np.allclose(bt.summary(mc).ttests, bk.summary(mj).ttests,
                       rtol=1e-10)
    mk = convert.model_from_reference(mj, keep_kernel=True, device="cpu",
                                       dtype=torch.float64)
    assert mk.K.shape == (32, 32)


@pytest.mark.parametrize("kw", [dict(lambda_=0.7), dict(neig=20),
                                dict(L=0.05, U=5.0)])
def test_stepwise_routes_match_jax(rng, kw):
    n, p = 80, 3
    X = rng.normal(size=(n, p))
    y = X @ np.ones(p) + np.sin(X[:, 0]) + 0.2 * rng.normal(size=n)
    mt = bt.fit(y, X, noisy=False, **kw, **CPU64)
    mj = bk.fit(y, X, noisy=False, **kw)
    assert mt.eig_path == mj.eig_path
    assert mt.eig_path.startswith("stepwise")
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-9)
    assert np.max(np.abs(mt.coeffs - mj.coeffs)) <= 1e-8
    assert np.max(np.abs(mt.derivatives - mj.derivatives)) <= 1e-8


def test_noisy_fit_logs_and_matches_quiet(rng):
    n, p = 120, 3
    X = rng.normal(size=(n, p))
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    lines = []
    loud = bt.fit(y, X, noisy=True, log=lines.append, **CPU64)
    quiet = bt.fit(y, X, noisy=False, **CPU64)
    assert loud.lambda_ == quiet.lambda_
    np.testing.assert_array_equal(loud.coeffs, quiet.coeffs)
    joined = "\n".join(lines)
    assert "golden-section iterations" in joined and "L: " in joined


def test_unported_options_raise(rng, tmp_path):
    X = rng.normal(size=(40, 2))
    y = X[:, 0] + 0.1 * rng.normal(size=40)
    # a mesh runs (tests/test_torch_parallel.py); one that is not a Mesh
    # raises
    for kw in (dict(mesh=object()),
               dict(mesh=object(), streaming=True, neig=10)):
        with pytest.raises(TypeError, match="Mesh"):
            bt.fit(y, X, noisy=False, **kw, **CPU64)
    # the streaming route is ported: asked for, or chosen by size, it runs
    for kw in (dict(streaming=True, neig=10),
               dict(neig=10, streaming_threshold=40)):
        assert bt.fit(y, X, noisy=False, **kw, **CPU64).K is None
    # and so is checkpointing (item 15): it runs and resumes
    ck = str(tmp_path / "ckpt")
    assert bt.fit(y, X, noisy=False, checkpoint_dir=ck,
                  **CPU64).eig_path == "stepwise:auto"
    assert bt.fit(y, X, noisy=False, checkpoint_dir=ck,
                  **CPU64).eig_path == "checkpoint"


def test_validation_errors(rng):
    X = rng.normal(size=(20, 3))
    y = rng.normal(size=20)
    Xc = X.copy()
    Xc[:, 1] = 2.0
    with pytest.raises(ValueError, match="constant"):
        bt.fit(y, Xc, noisy=False, **CPU64)
    Xn = X.copy()
    Xn[3, 0] = np.nan
    with pytest.raises(ValueError, match="missing"):
        bt.check_data(y, Xn)
    with pytest.raises(ValueError, match="nrow"):
        bt.fit(y[:10], X, noisy=False, **CPU64)
    with pytest.raises(ValueError, match="vcov_est"):
        bt.fit(y, X, vcov_est=False, noisy=False, **CPU64)
    with pytest.raises(TypeError, match="dtype"):
        bt.fit(y, X, noisy=False, device="cpu", dtype=torch.float16)


def test_default_dtype_and_enable_x64(rng):
    """float32 is the default fit dtype; enable_x64() switches the
    package default (not torch's) to float64."""
    X = rng.normal(size=(50, 2))
    y = X[:, 0] + 0.3 * rng.normal(size=50)
    assert tmodel.DEFAULT_DTYPE == torch.float32
    m32 = bt.fit(y, X, noisy=False, device="cpu")
    assert m32.K.dtype == torch.float32
    try:
        bt.enable_x64()
        m64 = bt.fit(y, X, noisy=False, device="cpu")
        assert m64.K.dtype == torch.float64
        assert torch.get_default_dtype() == torch.float32
    finally:
        tmodel.DEFAULT_DTYPE = torch.float32
    assert m32.lambda_ == pytest.approx(m64.lambda_, rel=1e-3)


def test_ieee_fp32_restores_settings():
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    with ieee_fp32():
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32) == before


def test_sinfx_exact_protocol():
    """The reference's sinfx demo on its exact data (tests/r_rng.py),
    through the port with the JAX test's pins: dy/dx₁ tracks cos(x₁),
    AME(x₂) ≈ 1, R² ≈ 0.93 and the searched λ anchor (CPU f64)."""
    from r_rng import sinfx_data
    y, X = sinfx_data()
    m = bt.fit(y, X, noisy=False, **CPU64)
    truth = np.cos(X[:, 0])
    resid = m.derivatives[:, 0] - truth
    assert np.sqrt(np.mean(resid ** 2)) < 0.35
    assert np.corrcoef(m.derivatives[:, 0], truth)[0, 1] > 0.94
    assert 0.90 < m.avgderivatives[1] < 1.0
    assert 0.90 < m.R2 < 0.96
    assert abs(m.lambda_ - 0.59188) < 5e-4


def test_routing_is_the_jax_lattice():
    """routing.py is a copy: the same decision over the whole lattice."""
    import itertools
    from bigkrls_tpu.routing import select_route as jroute
    from bigkrls_tpu_torch.routing import select_route as troute
    for (n, neig, eigtrunc, method, *flags) in itertools.product(
            (500, 4096), (100, 4096), (0.0, 0.001),
            ("auto", "full", "adaptive", "subspace"),
            *([(False, True)] * 7)):
        kw = dict(zip(("streaming", "mesh_present", "checkpoint_present",
                       "explicit_lambda", "explicit_L", "explicit_U",
                       "adaptive_declined"), flags))
        kw.update(n=n, neig=min(neig, n), eigtrunc=eigtrunc,
                  eig_method=method)
        t, j = troute(**kw), jroute(**kw)
        assert (t.route, t.reason) == (j.route, j.reason)
