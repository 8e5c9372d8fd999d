"""Port vs JAX: the adaptive-truncation route (block-Krylov head, deflated
moments, tail quadrature, completed λ bounds, golden search and solve,
and the f64 host check), float64 on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu.ops import adaptive as ja
from bigkrls_tpu_torch.ops import adaptive as ta

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def synth_spectrum():
    """K = Q diag(exp(-i/15)) Qᵀ at n=1024: lastkeeper(0.001) ≈ 104 lies
    above the initial k₀=64, so the route grows k once."""
    n = 1024
    rng = np.random.default_rng(11)
    lams = np.exp(-np.arange(n) / 15.0)
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    K = (Q * lams) @ Q.T
    K = 0.5 * (K + K.T)
    y = rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    return K, y, n


def test_tail_quadrature_matches_jax():
    theta0 = np.array([0.01, 0.2, 0.5])
    w0 = np.array([100.0, 20.0, 5.0])
    m = np.array([np.sum(w0 * theta0 ** j) for j in range(6)])
    theta, w = ta.tail_quadrature(m, 3)
    assert np.allclose(np.sort(theta), np.sort(theta0), rtol=1e-8)
    assert np.allclose(np.sort(w), np.sort(w0), rtol=1e-8)
    for npts in (1, 2, 3):
        got = ta.tail_quadrature(m[: 2 * npts], npts)
        want = ja.tail_quadrature(m[: 2 * npts], npts)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_device_quadrature_matches_host():
    """The working-precision quadrature (the JAX program's arithmetic) vs
    the f64 host one, on a 3-atom tail and a degenerate 1-atom tail."""
    theta0 = np.array([0.01, 0.2, 0.5])
    w0 = np.array([100.0, 20.0, 5.0])
    m = np.array([np.sum(w0 * theta0 ** j) for j in range(6)])
    th_d, w_d = ta._tail_atoms_device(_t(m[1:]), float(m[0]))
    th_h, w_h = ta._tail_atoms(m)
    assert np.allclose(th_d.numpy(), th_h, rtol=1e-9)
    assert np.allclose(w_d.numpy(), w_h, rtol=1e-9)
    one = np.array([4.0, 2.0, 1.0, 0.5, 0.25, 0.125])   # all mass at 0.5
    th_d, w_d = ta._tail_atoms_device(_t(one[1:]), float(one[0]))
    th_h, w_h = ta._tail_atoms(one)
    assert np.allclose(np.sum(w_d.numpy() * th_d.numpy()),
                       np.sum(w_h * th_h), rtol=1e-9)
    assert np.allclose(np.sum(w_d.numpy()), 4.0, rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_quadrature_of_a_zero_tail_does_not_raise(dtype):
    """Deflated moments of an f32 block-Krylov head on a very low-rank
    kernel: m₁ comes out negative and clamps to 0, so the scaled Hankel
    entries divide by zero. The quadrature must decline (no atoms) as the
    host one and the JAX program do, not raise from ``eigh``."""
    m = torch.tensor([-9.624153, 1715.0643, -20385.127, 1350325.5,
                      -26575304.0], dtype=dtype)
    theta, w = ta._tail_atoms_device(m, 896.0)
    host = ta._tail_atoms(np.concatenate([[896.0],
                                          np.maximum(m.double().numpy(), 0)]))
    assert host[0].size == 0
    assert torch.all(theta == 0) and torch.all(w == 0)


def test_capture_plan_and_extrapolation_match_jax():
    vals = 2.0 * 0.9 ** np.arange(64)
    assert ta._extrapolate_khat(vals, 2.0 * 0.9 ** 100) == \
        ja._extrapolate_khat(vals, 2.0 * 0.9 ** 100)
    assert ta._extrapolate_khat(np.ones(64), 0.5) is None
    for v, k in ((np.exp(-np.arange(128) / 30.0), 128),
                 (np.exp(-np.arange(128) / 10.0), 128),
                 (np.ones(128), 128)):
        assert (ta._capture_plan(v, 0.001, k, 512, n=2048)
                == ja._capture_plan(v, 0.001, k, 512, n=2048))


def test_postkernel_adaptive_matches_jax(synth_spectrum):
    """Identical k (after one grow step), lastkeeper and L/U; λ* rel
    1e-9; coefficients 1e-8; the same completed Neffective."""
    K, y, n = synth_spectrum
    jo, lam_j, Le_j, c_j, spec_j = ja.postkernel_adaptive(
        jnp.asarray(K), jnp.asarray(y), 0.001, n / 1000.0)
    to, lam_t, Le_t, c_t, spec_t = ta.postkernel_adaptive(
        _t(K), _t(y), 0.001, n / 1000.0)
    assert to.k == jo.k > 64
    assert to.eig.lastkeeper == jo.eig.lastkeeper
    assert to.L == jo.L and to.U == jo.U
    assert lam_t == pytest.approx(lam_j, rel=1e-9)
    assert Le_t == pytest.approx(float(Le_j), rel=1e-9)
    assert np.max(np.abs(c_t.numpy() - np.asarray(c_j))) <= 1e-8
    assert np.allclose(spec_t.numpy(), np.asarray(spec_j), rtol=1e-8)
    assert to.neffective(lam_t, n) == pytest.approx(jo.neffective(lam_j, n),
                                                    rel=1e-9)
    # the fused solve equals the stepwise golden search + solve
    lam_r, Le_r, c_r = ta.resume_adaptive(to, _t(y), n / 1000.0)
    assert lam_r == pytest.approx(lam_t, rel=1e-12)
    assert np.max(np.abs(c_r.numpy() - c_t.numpy())) <= 1e-12


def test_postkernel_adaptive_declines_small_n():
    K = torch.eye(200, dtype=torch.float64)
    assert ta.postkernel_adaptive(K, torch.zeros(200, dtype=torch.float64),
                                  0.001, 0.2) is None


def test_adaptive_route_fit_matches_jax():
    """The default route at N=2048 (the data of
    test_numeric_convergence.py's adaptive oracle): same path, lastkeeper
    and λ*, coefficients and derivatives to 1e-8."""
    rng = np.random.default_rng(2018)
    n, p = 2048, 4
    X = rng.normal(size=(n, p))
    X[:, p - 1] = (X[:, p - 1] > 0.12345).astype(float)
    y = np.asarray(X @ rng.uniform(size=p) + rng.normal(size=n))
    mj = bk.fit(y, X, eigtrunc=0.01, noisy=False)
    mt = bt.fit(y, X, eigtrunc=0.01, noisy=False, device="cpu",
                dtype=torch.float64)
    assert mt.eig_path == mj.eig_path
    assert mt.eig_path.startswith("adaptive-krylov")
    assert mt.lastkeeper == mj.lastkeeper
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-9)
    assert np.max(np.abs(mt.coeffs - mj.coeffs)) <= 1e-8
    assert np.max(np.abs(mt.derivatives - mj.derivatives)) <= 1e-8
    assert np.allclose(mt.var_avgderivatives, mj.var_avgderivatives,
                       rtol=1e-8)
    assert mt.neffective == pytest.approx(mj.neffective, rel=1e-9)
    # the atoms come from moments summed in another order: rounding only
    assert np.allclose(mt.eig_tail_theta, np.asarray(mj.eig_tail_theta),
                       rtol=1e-8)


def test_flat_spectrum_falls_back_to_dense():
    """High-dimensional X: the truncation is never captured within N/4,
    so the fit runs the dense core and says so in eig_path, like JAX."""
    rng = np.random.default_rng(3)
    n, p = 512, 100
    X = rng.normal(size=(n, p))
    y = X[:, 0] + 0.3 * rng.normal(size=n)
    kw = dict(noisy=False, eigtrunc=0.001, derivative=False)
    mt = bt.fit(y, X, eig_method="adaptive", device="cpu",
                dtype=torch.float64, **kw)
    mj = bk.fit(y, X, eig_method="adaptive", **kw)
    assert mt.eig_path == mj.eig_path == "eigh-fused(adaptive-fallback)"
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-9)
    assert np.max(np.abs(mt.coeffs - mj.coeffs)) <= 1e-8
