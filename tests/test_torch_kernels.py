"""Port vs JAX: kernel construction, the K1 wrapper's CPU path, the
kernel build's bookkeeping, and the small statistics helpers.

Inputs are numpy draws handed to both packages in float64. The JAX side of
K1 is its plain reference (XLA ``gauss_kernel``/``cross_kernel``): the
Pallas kernel has no CPU mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu.ops import kernels as jk
from bigkrls_tpu.ops import stats as jstats
from bigkrls_tpu_torch.ops import _build
from bigkrls_tpu_torch.ops import kernels as tk
from bigkrls_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

TOL = 1e-12   # f64: both sides evaluate the same rank-P formula


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _std_rows(rng, n, p):
    X = rng.normal(size=(n, p))
    return (X - X.mean(0)) / X.std(0, ddof=1)


@pytest.mark.parametrize("n,p,explicit", [(50, 3, False), (120, 7, False),
                                          (40, 5, True)])
def test_gauss_kernel_matches_jax(n, p, explicit):
    X = _std_rows(np.random.default_rng(n + p), n, p)
    sigma = float(p)
    Kt = tk.gauss_kernel(_t(X), sigma, explicit=explicit).numpy()
    Kj = np.asarray(jk.gauss_kernel(jnp.asarray(X), sigma, explicit=explicit))
    assert np.max(np.abs(Kt - Kj)) <= TOL
    assert np.array_equal(Kt, Kt.T)                  # symmetrized
    assert np.all(np.diag(Kt) == 1.0)                # exact diagonal


def test_rank_p_matches_explicit_form():
    """The dot form reproduces the difference-sum form on standardized
    inputs (r ≈ P) to 1e-12 in f64."""
    X = _t(_std_rows(np.random.default_rng(3), 90, 6))
    K = tk.gauss_kernel(X, 6.0)
    Ke = tk.gauss_kernel(X, 6.0, explicit=True)
    assert torch.max(torch.abs(K - Ke)).item() <= TOL


def test_cross_kernel_matches_jax():
    rng = np.random.default_rng(5)
    Xo = _std_rows(rng, 80, 4)
    Xn = rng.normal(size=(13, 4))
    Kt = tk.cross_kernel(_t(Xn), _t(Xo), 4.0).numpy()
    Kj = np.asarray(jk.cross_kernel(jnp.asarray(Xn), jnp.asarray(Xo), 4.0))
    assert Kt.shape == (13, 80)
    assert np.max(np.abs(Kt - Kj)) <= TOL


@pytest.mark.parametrize("sym", [True, False])
def test_gauss_tile_cpu_takes_plain_path(sym):
    """On CPU tensors the wrapper runs the plain rank-P version and never
    counts a launch; the result agrees with the JAX reference to 1e-12
    (before the XLA path's symmetrizing step, which moves entries by
    rounding only)."""
    rng = np.random.default_rng(9)
    A = _std_rows(rng, 64, 5)
    B = A if sym else rng.normal(size=(31, 5))
    before = tk.gauss_tile_launches
    K = tk.gauss_tile(_t(A), _t(B), 5.0, sym)
    assert tk.gauss_tile_launches == before == 0
    ref = (jk.gauss_kernel(jnp.asarray(A), 5.0) if sym
           else jk.cross_kernel(jnp.asarray(B), jnp.asarray(A), 5.0).T)
    assert np.max(np.abs(K.numpy() - np.asarray(ref))) <= TOL
    if sym:
        assert np.all(np.diag(K.numpy()) == 1.0)
    plain = tk.gauss_tile_plain(_t(A), _t(B), 5.0, sym)
    assert torch.equal(K, plain)


def test_gauss_tile_rejects_bad_shapes():
    A = torch.zeros((5, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        tk.gauss_tile(A, torch.zeros((5, 4), dtype=torch.float64), 1.0, False)
    with pytest.raises(ValueError):
        tk.gauss_tile(A, torch.zeros((6, 3), dtype=torch.float64), 1.0, True)


@pytest.mark.parametrize("impl", ["auto", "plain", "cuda"])
def test_kernel_matrix_on_cpu(impl):
    """Every impl runs the plain version on a CPU tensor (the CUDA kernel
    is only reached on a CUDA tensor), with no launch counted."""
    X = _t(_std_rows(np.random.default_rng(2), 70, 4))
    K = tk.kernel_matrix(X, 4.0, impl)
    assert tk.gauss_tile_launches == 0
    ref = tk.gauss_kernel(X, 4.0)
    assert torch.max(torch.abs(K - ref)).item() <= TOL
    Kc = tk.cross_kernel_matrix(X[:9], X, 4.0, impl)
    assert torch.max(torch.abs(Kc - tk.cross_kernel(X[:9], X, 4.0))) <= TOL


def test_kernel_matrix_rejects_unknown_impl():
    X = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="kernel_impl"):
        tk.kernel_matrix(X, 2.0, "pallas")


def test_build_digest_tracks_sources(tmp_path):
    """The library name is keyed by the sources' content: the same bytes
    give the same key, an edit gives a new one."""
    a = tmp_path / "a.cu"
    a.write_text("// one\n")
    d1 = _build._digest([a])
    assert _build._digest([a]) == d1
    a.write_text("// two\n")
    assert _build._digest([a]) != d1
    assert _build._sources()[0].name == "gauss_kernel.cu"


def test_standardize_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 3)) * [1.0, 5.0, 0.1] + [0.0, 2.0, -1.0]
    y = rng.normal(size=40) * 3.0 + 1.0
    out_t = tstats.standardize(_t(X), _t(y))
    out_j = jstats.standardize(jnp.asarray(X), jnp.asarray(y))
    for a, b in zip(out_t, out_j):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= TOL


@pytest.mark.parametrize("block", [0, 16])
def test_neffective_acf_matches_jax(block):
    X = _std_rows(np.random.default_rng(6), 50, 4)
    got = tstats.neffective_acf(_t(X), block=block)
    want = float(jstats.neffective_acf(jnp.asarray(X), block=block))
    assert got == pytest.approx(want, rel=1e-12)


def test_neffective_spectral_matches_jax():
    vals = np.sort(np.random.default_rng(7).uniform(size=30))[::-1]
    got = tstats.neffective_spectral(_t(vals), 0.3, 30)
    want = jstats.neffective_spectral(jnp.asarray(vals), 0.3, 30)
    assert got == pytest.approx(want, rel=1e-12)


def test_t_tail_matches_jax():
    """scipy's betainc on the host vs jax.scipy's: 1e-10 relative (two
    independent implementations of the same special function)."""
    t = np.array([-3.0, -0.5, 0.0, 0.7, 2.0, 5.0])
    for df in (3.0, 30.0, 2500.0):
        assert np.allclose(tstats.t_sf(t, df),
                           np.asarray(jstats.t_sf(jnp.asarray(t), df)),
                           rtol=1e-10, atol=0)
        assert np.allclose(tstats.two_sided_p(t, df),
                           np.asarray(jstats.two_sided_p(jnp.asarray(t), df)),
                           rtol=1e-10, atol=0)
