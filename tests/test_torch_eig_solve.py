"""Port vs JAX: the dense eigensolvers, the spectral solve, the λ-search
bounds and golden search, and the fused dense post-kernel core.

float64 on both sides. The iterative solvers are fed the JAX start block
(``jax.random.normal(PRNGKey(0), (n, q))``), so both run the same
arithmetic: eigenvalues agree to 1e-10 and eigenvectors up to column
sign."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu import lambda_search as jls
from bigkrls_tpu.ops import eig as jeig
from bigkrls_tpu.ops import fused as jfused
from bigkrls_tpu.ops import kernels as jk
from bigkrls_tpu.ops import solve as jsolve
from bigkrls_tpu_torch import lambda_search as tls
from bigkrls_tpu_torch.ops import eig as teig
from bigkrls_tpu_torch.ops import fused as tfused
from bigkrls_tpu_torch.ops import solve as tsolve
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    K = np.asarray(jk.gauss_kernel(jnp.asarray(X), float(p)))
    return K, y


def _jax_start(n, q):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, q),
                                        dtype=jnp.float64))


def _same_up_to_sign(A, B, tol):
    s = np.sign(np.sum(A * B, axis=0))
    return np.max(np.abs(A - B * s[None, :])) <= tol


@pytest.mark.parametrize("n,k,iters", [(300, 20, 4), (100, 20, 4)])
def test_subspace_iteration_with_jax_start(n, k, iters):
    """(300, 20): the progressive flow; (100, 20): the stacked-blocks +
    fat-QR flow (width ≥ n)."""
    K, _ = _problem(n, 3, n)
    q, _ = jeig._krylov_geometry(n, k, iters)
    vj, Vj = jeig._subspace_iteration(jnp.asarray(K), jax.random.PRNGKey(0),
                                      k, iters)
    vt, Vt = teig._subspace_iteration(_t(K), k, iters,
                                      start=_t(_jax_start(n, q)))
    assert np.max(np.abs(vt.numpy() - np.asarray(vj))) <= 1e-10
    assert _same_up_to_sign(Vt.numpy(), np.asarray(Vj), 1e-8)


def test_subspace_iteration_default_start_converges():
    """The torch-generator start block reaches the same top eigenpairs."""
    K, _ = _problem(300, 3, 1)
    vt, _ = teig._subspace_iteration(_t(K), 20, 6)
    ref = np.linalg.eigvalsh(K)[::-1][:20]
    assert np.max(np.abs(vt.numpy() - ref)) <= 1e-10


def test_start_block_is_seeded():
    a = teig.start_block(10, 3, torch.float64, "cpu", seed=4)
    b = teig.start_block(10, 3, torch.float64, "cpu", seed=4)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="start block"):
        teig._subspace_iteration(torch.eye(10, dtype=torch.float64), 2, 2,
                                 start=a)


def test_lanczos_with_jax_start():
    n, k = 120, 10
    K, _ = _problem(n, 3, 2)
    vj, Vj = jeig._lanczos(jnp.asarray(K), jax.random.PRNGKey(0), k)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                      dtype=jnp.float64))
    vt, Vt = teig._lanczos(_t(K), k, start=_t(v0))
    assert np.max(np.abs(vt.numpy() - np.asarray(vj))) <= 1e-10
    assert _same_up_to_sign(Vt.numpy(), np.asarray(Vj), 1e-8)


@pytest.mark.parametrize("method,neig,eigtrunc", [
    ("full", None, 0.0), ("full", None, 0.01), ("auto", 20, 0.0),
    ("full", 60, 0.001)])
def test_eigensystem_matches_jax(method, neig, eigtrunc):
    K, _ = _problem(200, 4, 3)
    ej = jeig.eigensystem(jnp.asarray(K), neig=neig, eigtrunc=eigtrunc,
                          method=method)
    et = teig.eigensystem(_t(K), neig=neig, eigtrunc=eigtrunc, method=method)
    assert et.lastkeeper == ej.lastkeeper
    assert np.max(np.abs(et.values_full.numpy()
                         - np.asarray(ej.values_full))) <= 1e-10
    assert _same_up_to_sign(et.vectors.numpy(), np.asarray(ej.vectors), 1e-7)


def test_eigh_desc_convention():
    """Descending values, negated vectors (the reference's sign)."""
    K, _ = _problem(60, 3, 4)
    vals, vecs = teig._eigh_desc(_t(K))
    vj, Vj = jeig._eigh_desc(jnp.asarray(K))
    assert np.all(np.diff(vals.numpy()) <= 0)
    assert np.max(np.abs(vals.numpy() - np.asarray(vj))) <= 1e-12
    assert _same_up_to_sign(vecs.numpy(), np.asarray(Vj), 1e-9)


def test_lastkeeper_rule():
    vals = np.array([10.0, 5.0, 0.02, 0.011, 0.0099, 1e-5])
    for tr in (0.0, 0.001, 0.01, 0.5, 1.0):
        assert (teig.lastkeeper_from_values(vals, tr)
                == jeig.lastkeeper_from_values(vals, tr))


def test_block_orth_cholqr_and_fallback():
    """f32 blocks of ≥ 16384 rows take CholeskyQR² (orthonormal to f32
    accuracy, same span); a rank-deficient block fails its check and
    takes Householder QR."""
    rng = np.random.default_rng(8)
    W = torch.as_tensor(rng.normal(size=(16384, 24)), dtype=torch.float32)
    Q = teig._block_orth(W)
    eye = torch.eye(24)
    assert torch.max(torch.abs(Q.T @ Q - eye)).item() < 1e-5
    assert torch.max(torch.abs(Q @ (Q.T @ W) - W)).item() < 1e-3
    Wd = W.clone()
    Wd[:, 5] = Wd[:, 4]
    Qd = teig._block_orth(Wd)
    assert torch.isfinite(Qd).all()
    assert torch.max(torch.abs(Qd.T @ Qd - eye)).item() < 1e-5


def test_spectral_solve_matches_jax():
    K, y = _problem(150, 3, 5)
    ej = jeig.eigensystem(jnp.asarray(K), eigtrunc=0.001)
    et = teig.eigensystem(_t(K), eigtrunc=0.001)
    lams = [0.01, 0.3, 2.0]
    Qj = jsolve.solve_precompute(ej.vectors, jnp.asarray(y))
    Qt = tsolve.solve_precompute(et.vectors, _t(y))
    cj, gj, lj = jsolve.spectral_solve_batch(ej.vectors, ej.values, *Qj,
                                             jnp.asarray(lams))
    ct, gt, lt = tsolve.spectral_solve_batch(et.vectors, et.values, *Qt,
                                             lams)
    assert np.max(np.abs(ct.numpy() - np.asarray(cj))) <= 1e-10
    assert np.max(np.abs(gt.numpy() - np.asarray(gj))) <= 1e-10
    assert np.allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    Le_t, c_t = tsolve.solve_for_c(et, _t(y), 0.3)
    Le_j, c_j = jsolve.solve_for_c(ej, jnp.asarray(y), 0.3)
    assert float(Le_t) == pytest.approx(float(Le_j), rel=1e-10)
    assert np.max(np.abs(c_t.numpy() - np.asarray(c_j))) <= 1e-10


def test_bounds_and_golden_search_match_jax():
    K, y = _problem(250, 4, 6)
    ej = jeig.eigensystem(jnp.asarray(K), eigtrunc=0.001)
    et = teig.eigensystem(_t(K), eigtrunc=0.001)
    vals = np.asarray(ej.values_full)
    assert tls._upper_bound(vals, 250) == jls._upper_bound(vals, 250)
    assert tls._lower_bound(vals) == jls._lower_bound(vals)
    lam_j = float(jls.lambda_search(ej, jnp.asarray(y)))
    lam_t = tls.lambda_search(et, _t(y))
    assert lam_t == pytest.approx(lam_j, rel=1e-9)
    lam_s, Le_s, c_s = tls.lambda_search_solve(et, _t(y))
    assert lam_s == pytest.approx(lam_j, rel=1e-9)
    Le_j, c_j = jsolve.solve_for_c(ej, jnp.asarray(y), lam_j)
    assert float(Le_s) == pytest.approx(float(Le_j), rel=1e-9)
    assert np.max(np.abs(c_s.numpy() - np.asarray(c_j))) <= 1e-8


def test_noisy_search_logs_reference_brackets():
    K, y = _problem(120, 3, 7)
    et = teig.eigensystem(_t(K))
    lines = []
    lam = tls.lambda_search(et, _t(y), noisy=True, log=lines.append)
    assert lines[0].startswith("L: ") and "S1: " in lines[0]
    assert lines[-1] == f"lambda = {lam:.5f}"
    assert lam == tls.lambda_search(et, _t(y))


def test_golden_section_iteration_cap():
    """A loss that never settles (each evaluation differs from the last
    by ≥ 1 > tol) stops at the 10 000-iteration cap."""
    calls = iter(range(10 ** 6))
    lam, it = tsolve.golden_section(lambda x: float(next(calls)), 0.0, 1.0,
                                    0.5)
    assert it == tsolve.GOLDEN_MAX_ITERS and 0.0 <= lam <= 1.0


@pytest.mark.parametrize("n,p,eigtrunc", [(300, 5, 0.0), (420, 7, 0.001)])
def test_postkernel_device_matches_jax(n, p, eigtrunc):
    """The dense core: identical lastkeeper, λ* rel 1e-9, coefficients
    1e-8, the masked vcov filter and the iteration count."""
    K, y = _problem(n, p, n + p)
    jo = jfused.postkernel_device(jnp.asarray(K), jnp.asarray(y),
                                  jnp.asarray(eigtrunc),
                                  jnp.asarray(1e-3 * n))
    to = tfused.postkernel_device(_t(K), _t(y), eigtrunc, 1e-3 * n)
    assert to[2] == int(jo[2])
    assert to[3] == pytest.approx(float(jo[3]), rel=1e-9)
    assert float(to[4]) == pytest.approx(float(jo[4]), rel=1e-9)
    assert np.max(np.abs(to[5].numpy() - np.asarray(jo[5]))) <= 1e-8
    assert np.allclose(to[6].numpy(), np.asarray(jo[6]), rtol=1e-8, atol=0)
    assert to[7] == int(jo[7])


def test_device_bounds_match_host_bounds():
    """The working-precision bound bisections land on the host's exact
    steps (f64)."""
    K, _ = _problem(200, 3, 9)
    vals = np.linalg.eigvalsh(K)[::-1].copy()
    U = float(tfused._upper_bound_device(_t(vals), 200))
    L = float(tfused._lower_bound_device(_t(vals)))
    assert U == tls._upper_bound(vals, 200)
    assert L == pytest.approx(max(tls._lower_bound(vals), tfused._EPS),
                              rel=1e-12)
