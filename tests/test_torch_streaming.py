"""Port vs JAX: the kernel-free (streaming) slice on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port: the blocked K(X)·V product, the three
``eigensystem_streaming`` flows (fed the JAX start block), the streaming
derivatives product and the whole ``fit(streaming=True)``. float64 on both
sides unless a test says otherwise; each tolerance is stated where it is
used. On the CPU ``kernel_matmul`` runs ``kernel_matmul_plain``, the plain
version of the CUDA kernel (the kernel itself is held against it on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu.ops import effects as jeff
from bigkrls_tpu.ops import eig as jeig
from bigkrls_tpu.ops import kernels as jk
from bigkrls_tpu.ops import matvec as jmv
from bigkrls_tpu_torch import convert
from bigkrls_tpu_torch import lambda_search as tls
from bigkrls_tpu_torch.ops import effects as teff
from bigkrls_tpu_torch.ops import eig as teig
from bigkrls_tpu_torch.ops import matvec as tmv
from bigkrls_tpu_torch.utils.memory import DEFAULT_BUDGET, device_memory_budget
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _std(X):
    return (X - X.mean(0)) / X.std(0, ddof=1)


def _xy(seed, n=96, p=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    X[:, 2] = (X[:, 2] > 0.1).astype(float)
    y = np.sin(X[:, 0]) + X @ np.ones(p) + 0.3 * rng.normal(size=n)
    return y, X


def _same_up_to_sign(A, B, tol):
    s = np.sign(np.sum(A * B, axis=0))
    return np.max(np.abs(A - B * s[None, :])) <= tol


# ---- the product --------------------------------------------------------

@pytest.mark.parametrize("n,p,m,block,epilogue", [
    (53, 3, 2, 16, False),      # N not a multiple of the block
    (100, 5, 7, 32, False),
    (173, 5, 4, 64, True),      # ragged N with init and out_scale
    (200, 4, 3, 1024, True),    # one block wider than N
])
def test_kernel_matmul_plain_matches_jax(n, p, m, block, epilogue):
    """f64, 1e-10: both sum the same N products per entry, in blocks of
    different sizes, so only the summation order differs."""
    rng = np.random.default_rng(n + m)
    X, V, init = (rng.normal(size=s) for s in ((n, p), (n, m), (n, m)))
    kw = dict(init=init, out_scale=-2.5) if epilogue else {}
    want = np.asarray(jmv.kernel_matmul(
        jnp.asarray(X), jnp.asarray(V), float(p),
        **{k: (jnp.asarray(v) if k == "init" else v) for k, v in kw.items()}))
    tkw = {k: (_t(v) if k == "init" else v) for k, v in kw.items()}
    got = tmv.kernel_matmul_plain(_t(X), _t(V), float(p), block=block, **tkw)
    assert np.max(np.abs(got.numpy() - want)) < 1e-10
    # the entry point on a CPU tensor is the plain version
    via = tmv.kernel_matmul(_t(X), _t(V), float(p), block=block, **tkw)
    assert torch.equal(via, got)
    # and it equals the dense (K @ V + init) * out_scale; the product writes
    # no exact-1 diagonal, so K's diagonal is exp(-max(2r - 2x.x, 0)/sigma),
    # which is 1 to rounding
    K = np.asarray(jk.gauss_kernel(jnp.asarray(X), float(p)))
    dense = K @ V
    if epilogue:
        dense = (dense + init) * -2.5
    assert np.max(np.abs(got.numpy() - dense)) < 1e-10


@pytest.mark.parametrize("n,p,m,tm", [(96, 4, 5, 32), (80, 3, 70, 32)])
def test_kernel_matmul_plain_f32_matches_pallas_interpret(n, p, m, tm):
    """f32 plain version vs the Pallas TPU kernel in interpret mode, at the
    JAX suite's shapes (a narrow RHS and one wider than tile_m): 1e-5 of
    max|Y|, the f32 rounding of the length-N sums."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, p))
    V = rng.normal(size=(n, m))
    want = np.asarray(jmv.kernel_matmul_pallas(
        jnp.asarray(X), jnp.asarray(V), float(p), tile_i=32, tile_j=32,
        tile_m=tm, interpret=True))
    got = tmv.kernel_matmul_plain(_t(X, torch.float32), _t(V, torch.float32),
                                  float(p), block=32).numpy()
    assert got.shape == (n, m) and got.dtype == np.float32
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


def test_kernel_matmul_out_may_alias_init_only():
    """``out`` may be the buffer passed as ``init`` (the Chebyshev step's
    in-place form); ``out`` overlapping V or X is refused, as are
    non-contiguous operands and mismatched dtypes."""
    rng = np.random.default_rng(3)
    X, V, init = (_t(rng.normal(size=s)) for s in ((40, 3), (40, 6), (40, 6)))
    want = tmv.kernel_matmul(X, V, 3.0, init=init, out_scale=0.5)
    buf = init.clone()
    got = tmv.kernel_matmul(X, V, 3.0, init=buf, out_scale=0.5, out=buf)
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(got, want)
    sep = torch.empty_like(V)
    assert torch.equal(tmv.kernel_matmul(X, V, 3.0, init=init, out_scale=0.5,
                                         out=sep), want)
    assert torch.equal(init, _t(init.numpy()))      # init left untouched
    with pytest.raises(ValueError, match="alias"):
        tmv.kernel_matmul(X, V, 3.0, out=V)
    big = torch.zeros(41 * 6, dtype=torch.float64)     # a shifted overlap
    with pytest.raises(ValueError, match="alias"):
        tmv.kernel_matmul(X, V, 3.0, init=big[:240].view(40, 6),
                          out=big[6:].view(40, 6))
    with pytest.raises(ValueError, match="contiguous"):
        tmv.kernel_matmul(X, V.T.contiguous().T, 3.0)
    with pytest.raises(TypeError):
        tmv.kernel_matmul(X, V.float(), 3.0)
    with pytest.raises(ValueError, match="sigma"):
        tmv.kernel_matmul(X, V, 0.0)
    with pytest.raises(ValueError, match="kernel_impl"):
        tmv.kernel_matmul(X, V, 3.0, impl="triton")


def test_kernel_matmul_fast_accum_is_a_noop_on_cpu():
    rng = np.random.default_rng(4)
    X, V = _t(rng.normal(size=(64, 3))), _t(rng.normal(size=(64, 5)))
    assert torch.equal(tmv.kernel_matmul(X, V, 3.0, fast_accum=True),
                       tmv.kernel_matmul(X, V, 3.0))
    assert tmv.kernel_matmul_launches == 0    # no kernel launch on the CPU


def test_device_memory_budget_cpu_default():
    assert device_memory_budget("cpu") == DEFAULT_BUDGET
    assert device_memory_budget(None, default=123) == 123


# ---- the eigensolver ----------------------------------------------------

def test_cheb_step_fused_matches_generic_and_jax():
    """The in-place, epilogue-fused Chebyshev step gives the generic step's
    blocks and scale (1e-12: the same terms, summed in another order), and
    both give the JAX step's."""
    rng = np.random.default_rng(5)
    n, p = 160, 4
    X = rng.normal(size=(n, p))
    Yp, Yc = rng.normal(size=(n, 8)), rng.normal(size=(n, 8))
    r, c, sigma = 0.7, 1.3, float(p)
    a = teig._cheb_step(_t(X), _t(Yp), _t(Yc), r, c, sigma, tmv.kernel_matmul)
    Yp_t = _t(Yp)
    b = teig._cheb_step_fused(_t(X), Yp_t, _t(Yc), r, c, sigma,
                              tmv.kernel_matmul)
    assert b[1].data_ptr() == Yp_t.data_ptr()       # U written over Yp
    j = jeig._cheb_step(jnp.asarray(X), jnp.asarray(Yp), jnp.asarray(Yc), r,
                        c, sigma, jmv.kernel_matmul)
    for ai, bi, ji in zip(a, b, j):
        assert np.max(np.abs(np.asarray(ai) - np.asarray(bi))) < 1e-12
        assert np.max(np.abs(np.asarray(ai) - np.asarray(ji))) < 1e-12


def test_cheb_degrees_match_jax():
    for nprod in range(0, 12):
        assert teig._cheb_degrees(nprod) == jeig._cheb_degrees(nprod)


def _jax_start(n, q):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, q),
                                        dtype=jnp.float64))


@pytest.mark.parametrize("flow,n,k,iters,krylov", [
    ("progressive", 300, 20, 4, True),    # (iters+1)·q = 240 ≤ n
    ("stacked", 100, 20, 4, True),        # width ≥ n: fat QR
    ("chebyshev", 300, 20, 6, False),     # constant memory, 4 products + Ritz
])
def test_eigensystem_streaming_matches_jax(flow, n, k, iters, krylov):
    """All three flows, fed the JAX start block, run the JAX solver's
    arithmetic: eigenvalues within 1e-10, eigenvectors within 1e-7 up to
    column sign, the same lastkeeper."""
    rng = np.random.default_rng(n + iters)
    X = _std(rng.normal(size=(n, 3)))
    q, progressive = teig._krylov_geometry(n, k, iters)
    if krylov:
        assert progressive == (flow == "progressive")
    ej = jeig.eigensystem_streaming(jnp.asarray(X), 3.0, neig=k,
                                    eigtrunc=0.01, iters=iters, krylov=krylov)
    et = teig.eigensystem_streaming(_t(X), 3.0, neig=k, eigtrunc=0.01,
                                    iters=iters, krylov=krylov,
                                    start=_t(_jax_start(n, q)))
    assert et.lastkeeper == ej.lastkeeper
    assert np.max(np.abs(et.values_full.numpy()
                         - np.asarray(ej.values_full))) <= 1e-10
    assert _same_up_to_sign(et.vectors.numpy(), np.asarray(ej.vectors), 1e-7)


def test_eigensystem_streaming_default_start_matches_dense_eigh():
    """The torch-generator start block reaches the dense spectrum (the JAX
    suite's pin: rel 1e-6 at iters=30), and a wrong start shape raises."""
    rng = np.random.default_rng(6)
    n, p, k = 120, 4, 12
    X = _std(rng.normal(size=(n, p)))
    K = np.asarray(jk.gauss_kernel(jnp.asarray(X), float(p)))
    ref = np.linalg.eigvalsh(K)[::-1][:k]
    e = teig.eigensystem_streaming(_t(X), float(p), neig=k, iters=30)
    assert np.max(np.abs(e.values_full.numpy() - ref) / ref) < 1e-6
    with pytest.raises(ValueError, match="start block"):
        teig.eigensystem_streaming(_t(X), float(p), neig=k,
                                   start=torch.zeros((n, 3)))


def test_eigensystem_streaming_krylov_override_and_progress():
    """``krylov=True`` and ``krylov=False`` agree on a fast-decaying
    spectrum (1e-6, the JAX suite's pin), and ``progress`` is called once
    per chunk with the running product count."""
    X = _t(np.random.default_rng(12).normal(size=(256, 4)))
    calls = []
    e_k = teig.eigensystem_streaming(X, 4.0, neig=16, iters=6, chunk=4,
                                     krylov=True,
                                     progress=lambda d, t: calls.append((d, t)))
    assert calls == [(4, 6), (6, 6)]
    calls.clear()
    e_p = teig.eigensystem_streaming(X, 4.0, neig=16, iters=20, krylov=False,
                                     progress=lambda d, t: calls.append((d, t)))
    assert [d for d, _ in calls] == list(range(1, 19)) and calls[0][1] == 18
    e_k20 = teig.eigensystem_streaming(X, 4.0, neig=16, iters=20, krylov=True)
    assert np.max(np.abs(e_k20.values_full.numpy()
                         - e_p.values_full.numpy())) < 1e-6
    assert np.max(np.abs(e_k.values_full.numpy()[:4]
                         - e_p.values_full.numpy()[:4])) < 1e-6


@pytest.mark.parametrize("fast_power,krylov,progressive,want", [
    ("auto", True, True, False), ("auto", False, True, True),
    ("auto", False, False, True), ("auto", True, False, True),
    (True, True, True, True), (False, False, True, False)])
def test_resolve_fast_power_policy(fast_power, krylov, progressive, want):
    assert teig._resolve_fast_power(fast_power, krylov, progressive) is want
    assert jeig._resolve_fast_power(fast_power, krylov, progressive) is want


GB = 1024 ** 3


@pytest.mark.parametrize("n,q,iters,budget,want", [
    (50_000, 540, 8, 16 * GB, True),      # ~1.9 GB basis
    (500_000, 248, 24, 16 * GB, False),   # ~23 GB basis
    (500_000, 248, 24, 80 * GB, True),
    (1_000_000, 540, 6, 80 * GB, True),   # ~28 GB, under 60% of 80 GB
    (2_000_000, 540, 6, 80 * GB, False),
])
def test_auto_krylov_memory_selection(caplog, n, q, iters, budget, want):
    """Block-Krylov unless the basis passes 60% of the budget; the switch
    to the constant-memory flow is logged. Same decisions as the JAX rule."""
    with caplog.at_level(logging.WARNING, logger="bigkrls_tpu_torch"):
        assert teig._auto_krylov(n, q, iters, 4, budget=budget) is want
    assert jeig._auto_krylov(n, q, iters, 4, budget=budget) is want
    logged = any("constant-memory" in r.message for r in caplog.records)
    assert logged is (not want)


def test_fast_power_self_correcting():
    """Power products may run at reduced precision because each QR
    re-orthonormalizes and the final Rayleigh–Ritz recomputes K·B with the
    full-precision product. bf16 rounding (harsher than TF32) in the power
    products only: eigenvalues stay within 5e-6 of λ₁ and λ* within 1e-5
    of the exact-power fit; the same noise in the Ritz product is at
    least ten times worse (the JAX suite's pin, same limits)."""
    rng = np.random.default_rng(1234)
    n, p, k = 512, 4, 48
    X = _std(rng.normal(size=(n, p)))
    y = np.sin(X[:, 0]) + X @ np.ones(p) + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    Xd, yd, sigma = _t(X), _t(y), float(p)

    def noisy_matmul(X_, V, s):
        Y = tmv.kernel_matmul(X_, V, s)
        return Y.to(torch.bfloat16).to(Y.dtype)

    e_exact = teig.eigensystem_streaming(Xd, sigma, neig=k)
    e_fast = teig.eigensystem_streaming(Xd, sigma, neig=k,
                                        power_matmul=noisy_matmul)
    v0 = float(e_exact.values_full[0])
    rel = float(torch.max(torch.abs(e_fast.values_full
                                    - e_exact.values_full))) / v0
    assert rel < 5e-6, rel
    lam_exact = tls.lambda_search(e_exact, yd)
    lam_fast = tls.lambda_search(e_fast, yd)
    assert lam_fast == pytest.approx(lam_exact, rel=1e-5)
    e_bad = teig.eigensystem_streaming(Xd, sigma, neig=k, matmul=noisy_matmul)
    rel_bad = float(torch.max(torch.abs(e_bad.values_full
                                        - e_exact.values_full))) / v0
    assert rel_bad > 10 * rel


def test_fast_power_with_caller_matmul_is_logged(caplog):
    """``fast_power=True`` cannot reach a caller-supplied product: it is
    ignored, and says so (the JAX package ignores it silently)."""
    X = _t(np.random.default_rng(8).normal(size=(64, 3)))
    with caplog.at_level(logging.WARNING, logger="bigkrls_tpu_torch"):
        e = teig.eigensystem_streaming(X, 3.0, neig=5, iters=3,
                                       matmul=tmv.kernel_matmul,
                                       fast_power=True)
    assert any("fast_power=True is ignored" in r.message
               for r in caplog.records)
    ref = teig.eigensystem_streaming(X, 3.0, neig=5, iters=3)
    assert torch.equal(e.values_full, ref.values_full)


# ---- the derivatives product ---------------------------------------------

def test_derivatives_streaming_matches_jax():
    """One stacked product, one binary column: derivatives, AME variances
    and the product's first column (K·c) within 1e-10 of the JAX ones."""
    rng = np.random.default_rng(7)
    n, p, k = 90, 4, 12
    X = rng.normal(size=(n, p))
    X[:, 1] = (X[:, 1] > 0).astype(float)
    X = _std(X)
    cols = (0, 1, 3)
    coeffs = rng.normal(size=n) / n
    Q = np.linalg.qr(rng.normal(size=(n, k)))[0]
    spec = rng.uniform(0.1, 1.0, size=k)
    bmask = np.array([False, True, False])
    z0, z1 = X[:, cols].min(0), X[:, cols].max(0)
    rj = jeff.derivatives_streaming(
        jnp.asarray(X), cols, jnp.asarray(coeffs), jnp.asarray(Q),
        jnp.asarray(spec), float(p), jnp.asarray(bmask), jnp.asarray(z0),
        jnp.asarray(z1), matmul=jmv.kernel_matmul)
    rt = teff.derivatives_streaming(
        _t(X), cols, _t(coeffs), _t(Q), _t(spec), float(p),
        torch.tensor(bmask), _t(z0), _t(z1), matmul=tmv.kernel_matmul)
    for a, b in zip(rt, rj):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-10


# ---- the fit --------------------------------------------------------------

@pytest.fixture(scope="module")
def streaming_fits():
    y, X = _xy(1234)
    mt = bt.fit(y, X, neig=40, streaming=True, noisy=False, **CPU64)
    mj = bk.fit(y, X, neig=40, streaming=True, noisy=False)
    return mt, mj, y, X


def test_streaming_fit_matches_jax(streaming_fits):
    """``fit(streaming=True)`` vs the JAX one. The two draw different start
    blocks, but at N=96 the Krylov basis spans the whole space (stacked
    flow), so Rayleigh–Ritz is exact on both sides and the fits agree to
    rounding: λ* rel 1e-8, everything else 1e-8 or tighter."""
    mt, mj, _, _ = streaming_fits
    assert mt.K is None and mj.K is None
    assert mt.eig_path == mj.eig_path == "streaming-krylov"
    assert mt.lastkeeper == mj.lastkeeper
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-8)
    for name in ("coeffs", "yfitted", "derivatives", "avgderivatives",
                 "K_eigenvalues"):
        assert np.max(np.abs(getattr(mt, name)
                             - np.asarray(getattr(mj, name)))) <= 1e-8, name
    assert np.allclose(mt.var_avgderivatives, mj.var_avgderivatives,
                       rtol=1e-7)
    for name in ("R2", "R2AME", "neffective", "looe", "sigmasq_std"):
        assert getattr(mt, name) == pytest.approx(getattr(mj, name),
                                                  rel=1e-8), name
    assert [t["phase"] for t in mt.timings] == [
        "kernel", "eigendecomposition", "lambda_search", "coefficients",
        "derivatives"]


def test_streaming_fit_matches_dense_subspace_fit(streaming_fits):
    """Same truncation, same algorithm family: the kernel-free fit vs the
    port's dense subspace fit (the JAX suite's limits)."""
    mt, _, y, X = streaming_fits
    md = bt.fit(y, X, neig=40, eig_method="subspace", noisy=False, **CPU64)
    assert md.K is not None
    assert abs(md.lambda_ - mt.lambda_) < 1e-5 * md.lambda_
    assert np.max(np.abs(md.coeffs - mt.coeffs)) < 1e-6
    assert np.max(np.abs(md.yfitted - mt.yfitted)) < 1e-6
    assert np.max(np.abs(md.derivatives - mt.derivatives)) < 1e-5
    assert np.allclose(md.var_avgderivatives, mt.var_avgderivatives,
                       rtol=1e-5)
    assert abs(md.R2 - mt.R2) < 1e-8


def test_streaming_is_chosen_by_size(streaming_fits):
    """``streaming=None`` turns the route on from ``streaming_threshold``
    rows when ``neig < n``, and not for a full decomposition."""
    mt, _, y, X = streaming_fits
    auto = bt.fit(y, X, neig=40, streaming_threshold=96, noisy=False, **CPU64)
    assert auto.K is None and auto.eig_path == "streaming-krylov"
    assert auto.lambda_ == mt.lambda_
    dense = bt.fit(y, X, streaming_threshold=96, noisy=False, **CPU64)
    assert dense.K is not None and dense.eig_path != "streaming-krylov"


def test_streaming_yfitted_rides_derivatives_product(streaming_fits,
                                                     monkeypatch):
    """ŷ comes out of the derivatives' stacked product (its first column
    is c), never from a width-1 product of its own; with
    ``derivative=False`` exactly one width-1 product computes it."""
    mt, _, y, X = streaming_fits
    widths = []
    real = tmv.kernel_matmul

    def counting(Xa, V, sigma, **kw):
        widths.append(int(V.shape[1]))
        return real(Xa, V, sigma, **kw)

    monkeypatch.setattr(tmv, "kernel_matmul", counting)
    m = bt.fit(y, X, neig=40, streaming=True, noisy=False, **CPU64)
    assert m.K is None and widths
    assert 1 not in widths, widths
    assert widths[-1] == 2 + 4 * X.shape[1]          # the derivatives stack
    assert np.array_equal(m.yfitted, mt.yfitted)

    widths.clear()
    m2 = bt.fit(y, X, neig=40, streaming=True, noisy=False, derivative=False,
                vcov_est=False, **CPU64)
    assert widths.count(1) == 1 and widths[-1] == 1, widths
    assert np.max(np.abs(m.yfitted - m2.yfitted)) < 1e-8
    assert m2.derivatives is None and m2.vcov_c_factored is None


def test_streaming_noisy_fit_logs_progress(streaming_fits):
    _, _, y, X = streaming_fits
    lines = []
    m = bt.fit(y, X, neig=40, streaming=True, noisy=True, log=lines.append,
               **CPU64)
    joined = "\n".join(lines)
    assert "never materialized" in joined
    assert "subspace power iteration 8/8" in joined
    assert m.lambda_ == streaming_fits[0].lambda_


def test_streaming_requires_truncation():
    y, X = _xy(2, n=40)
    with pytest.raises(ValueError, match="neig"):
        bt.fit(y, X, streaming=True, noisy=False, **CPU64)


def test_streaming_model_predict_summary_vcov(streaming_fits):
    """predict, summary and ``vcov_fitted_diag`` on a model without a
    stored kernel, against the JAX package on its own streaming model."""
    mt, mj, _, X = streaming_fits
    pt = bt.predict(mt, X[:9], se_pred=True)
    pj = bk.predict(mj, X[:9], se_pred=True)
    assert np.max(np.abs(pt.predicted - pj.predicted)) < 1e-8
    assert np.allclose(pt.se_pred, pj.se_pred, rtol=1e-7)
    assert np.max(np.abs(pt.predicted - mt.yfitted[:9])) < 1e-6
    d = mt.vcov_fitted_diag()
    assert d.shape == (96,) and bool((d > 0).all())
    assert np.allclose(d.numpy(), np.asarray(mj.vcov_fitted_diag()),
                       rtol=1e-7)
    assert mt.vcov_est_fitted is None
    assert np.allclose(bt.summary(mt).ttests, bk.summary(mj).ttests,
                       rtol=1e-6, atol=1e-12)


def test_converted_model_vcov_fitted_diag(streaming_fits):
    """``model_from_reference`` keeps no kernel by default; its
    ``vcov_fitted_diag`` recomputes K·Q and matches the JAX dense one."""
    _, _, y, X = streaming_fits
    mj = bk.fit(y, X, noisy=False)
    assert mj.K is not None
    mc = convert.model_from_reference(mj, device="cpu", dtype=torch.float64)
    assert mc.K is None
    assert np.allclose(mc.vcov_fitted_diag().numpy(),
                       np.asarray(mj.vcov_fitted_diag()), rtol=1e-8)
    pc = bt.predict(mc, X[:5], se_pred=True)
    pj = bk.predict(mj, X[:5], se_pred=True)
    assert np.allclose(pc.se_pred, pj.se_pred, rtol=1e-10)
