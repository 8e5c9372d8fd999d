"""Port vs JAX: marginal effects and AME variances from one multi-RHS
kernel product, float64 on both sides, plus the exact first-difference
oracle for a binary column."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu.ops import effects as je
from bigkrls_tpu.ops import kernels as jk
from bigkrls_tpu_torch.ops import effects as te
from bigkrls_tpu_torch.ops import kernels as tk
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _setup(n, p, binary_cols, seed):
    """Standardized X with the given binary columns, a kernel, random
    coefficients and a random rank-k covariance factor."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    for j in binary_cols:
        X[:, j] = (X[:, j] > 0.2).astype(float)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    K = np.asarray(jk.gauss_kernel(jnp.asarray(X), float(p)))
    c = rng.normal(size=n)
    Q = np.linalg.qr(rng.normal(size=(n, 12)))[0]
    spec = rng.uniform(0.1, 1.0, size=12)
    bmask = np.zeros(p, dtype=bool)
    bmask[list(binary_cols)] = True
    return X, K, c, Q, spec, bmask


@pytest.mark.parametrize("binary_cols,cols", [((), None), ((1, 3), None),
                                              ((2,), [0, 2])])
def test_derivatives_all_matches_jax(binary_cols, cols):
    n, p = 90, 4
    X, K, c, Q, spec, bmask = _setup(n, p, binary_cols, len(binary_cols))
    cols = list(range(p)) if cols is None else cols
    Xe = X[:, cols]
    z0, z1 = Xe.min(0), Xe.max(0)
    rj = je.derivatives_all(jnp.asarray(Xe), jnp.asarray(K), jnp.asarray(c),
                            jnp.asarray(Q), jnp.asarray(spec), float(p),
                            jnp.asarray(bmask[cols]), jnp.asarray(z0),
                            jnp.asarray(z1))
    rt = te.derivatives_all(_t(Xe), _t(K), _t(c), _t(Q), _t(spec), float(p),
                            torch.as_tensor(bmask[cols]), _t(z0), _t(z1))
    assert np.max(np.abs(rt.derivatives.numpy()
                         - np.asarray(rj.derivatives))) <= TOL
    assert np.allclose(rt.var_avgderiv.numpy(), np.asarray(rj.var_avgderiv),
                       rtol=TOL, atol=0)
    assert np.max(np.abs(rt.yfitted_std.numpy() - K @ c)) <= TOL


def test_binary_derivative_is_exact_first_difference():
    """For a binary column the derivative is (ŷ(x_j=max) − ŷ(x_j=min))/Δ,
    evaluated directly with the cross kernel at toggled inputs."""
    n, p = 70, 3
    X, K, c, Q, spec, bmask = _setup(n, p, (1,), 5)
    z0, z1 = X.min(0), X.max(0)
    rt = te.derivatives_all(_t(X), _t(K), _t(c), _t(Q), _t(spec), float(p),
                            torch.as_tensor(bmask), _t(z0), _t(z1))
    Xt, Xc = X.copy(), X.copy()
    Xt[:, 1], Xc[:, 1] = z1[1], z0[1]
    yt = tk.cross_kernel(_t(Xt), _t(X), float(p)) @ _t(c)
    yc = tk.cross_kernel(_t(Xc), _t(X), float(p)) @ _t(c)
    want = ((yt - yc) / (z1[1] - z0[1])).numpy()
    assert np.max(np.abs(rt.derivatives[:, 1].numpy() - want)) <= TOL


def test_rhs_stack_layout():
    X = _t(np.arange(6.0).reshape(3, 2))
    c = _t([1.0, 2.0, 3.0])
    B = _t([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    V = te._rhs_stack(X, c, B)
    assert V.shape == (3, 2 + 4 * 2)
    assert torch.equal(V[:, 0], c) and torch.all(V[:, 1] == 1.0)
    assert torch.equal(V[:, 2:4], X * c[:, None])
    assert torch.equal(V[:, 8:10], B)
