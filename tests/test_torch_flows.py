"""Port vs JAX on two flows no other port test runs, float64 on the CPU.

1. The constant-memory Chebyshev flow of ``eigensystem_streaming`` over a
   ring (``krylov=False`` with the ring product, which takes the fused
   recurrence step and the product's ``init``/``out_scale`` epilogue), at
   a divisible and a ragged N: against the port's one-device flow and the
   JAX ring flow, from the JAX start block.
2. The streaming route against the adaptive route at the boundary where
   both apply (N=2048, P=7, the bench's low-rank fallback design,
   ``neig = lastkeeper + 64``): each route pinned against JAX on the same
   data. The routes' λ* differ (streaming takes its lower λ bound from its
   ``neig`` values alone), so their gap is recorded and held equal to the
   JAX package's own gap, not asserted small."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu.ops import eig as jeig
from bigkrls_tpu.parallel import ring_kernel as jring
from bigkrls_tpu_torch import bench
from bigkrls_tpu_torch.ops import eig as teig
from bigkrls_tpu_torch.parallel import ring_kernel as tring
from bigkrls_tpu_torch.parallel.sharded import ShardedTensor

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64, noisy=False)
NEIG, ITERS, SHARDS = 16, 8, 4


def _jax_start(n, q, seed=0):
    """The JAX package's start block: a normal draw from PRNGKey(seed)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, q),
                                      dtype=jnp.float64))


def _gathered(v):
    return v.full().numpy() if isinstance(v, ShardedTensor) else v.numpy()


def _same_up_to_sign(A, B, tol):
    s = np.sign(np.sum(A * B, axis=0))
    return np.max(np.abs(A - B * s[None, :])) <= tol


@pytest.fixture(scope="module")
def rings():
    return (jring.make_ring_mesh(jax.devices()[:SHARDS]),
            tring.make_ring_mesh(["cpu"] * SHARDS))


@pytest.mark.parametrize("n", [256, 250])
def test_chebyshev_flow_over_a_ring(rings, n):
    """Eigenvalues within 1e-13 of λ₁ of the one-device flow and of JAX's
    ring flow; eigenvectors within 1e-10, up to sign; the same
    lastkeeper. A divisible N keeps the vectors row-sharded."""
    jr, tr = rings
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    q, _ = teig._krylov_geometry(n, NEIG, ITERS)
    start = torch.tensor(_jax_start(n, q))
    kw = dict(neig=NEIG, eigtrunc=0.01, iters=ITERS, krylov=False)
    ring = teig.eigensystem_streaming(
        torch.tensor(X), 3.0, matmul=tring.make_ring_matmul(tr), mesh=tr,
        start=start, **kw)
    one = teig.eigensystem_streaming(torch.tensor(X), 3.0, start=start, **kw)
    ej = jeig.eigensystem_streaming(
        jnp.asarray(X), 3.0, matmul=jring.make_ring_matmul(jr), mesh=jr,
        **kw)
    assert isinstance(ring.vectors, ShardedTensor) == (n % SHARDS == 0)
    vals, lam1 = ring.values_full.numpy(), one.values_full.numpy()[0]
    assert np.max(np.abs(vals - one.values_full.numpy())) <= 1e-13 * lam1
    assert np.max(np.abs(vals - np.asarray(ej.values_full))) <= 1e-13 * lam1
    assert ring.lastkeeper == one.lastkeeper == ej.lastkeeper
    vecs = _gathered(ring.vectors)
    assert _same_up_to_sign(vecs, one.vectors.numpy(), 1e-10)
    assert _same_up_to_sign(vecs, np.asarray(ej.vectors), 1e-10)


def test_chebyshev_ring_takes_the_fused_step(rings, monkeypatch):
    """Over the ring the flow runs the fused recurrence step (the product's
    epilogue), never the generic one."""
    _, tr = rings
    calls = []
    real = teig._cheb_step_fused
    monkeypatch.setattr(teig, "_cheb_step_fused",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(teig, "_cheb_step", lambda *a: pytest.fail(
        "the generic step ran over the ring"))
    X = torch.tensor(np.random.default_rng(5).normal(size=(64, 3)))
    teig.eigensystem_streaming(X, 3.0, neig=8, iters=ITERS, krylov=False,
                               matmul=tring.make_ring_matmul(tr), mesh=tr)
    # 6 products: degrees 2, 3, 1, each application's first product apart
    assert len(calls) == 3


@pytest.fixture(scope="module")
def boundary_fits():
    """Both routes on both packages, the port fed the JAX start blocks
    (``ops/eig.start_block`` replaced for the fits)."""
    y, X = bench.smoke_data(2048, 7, seed=7)
    real = teig.start_block
    teig.start_block = lambda n, q, dtype, device, seed=0: torch.as_tensor(
        _jax_start(n, q, seed), dtype=dtype, device=device)
    try:
        ta = bt.fit(y, X, eigtrunc=0.001, **CPU64)
        neig = ta.lastkeeper + 64
        ts = bt.fit(y, X, eigtrunc=0.001, neig=neig, streaming=True, **CPU64)
    finally:
        teig.start_block = real
    ja = bk.fit(y, X, eigtrunc=0.001, noisy=False)
    js = bk.fit(y, X, eigtrunc=0.001, neig=neig, streaming=True, noisy=False)
    return {"adaptive": (ta, ja), "streaming": (ts, js)}


@pytest.mark.parametrize("route", ["adaptive", "streaming"])
def test_route_matches_jax_at_the_boundary(boundary_fits, route):
    mt, mj = boundary_fits[route]
    assert mt.eig_path == mj.eig_path
    assert mt.eig_path.startswith("adaptive-krylov" if route == "adaptive"
                                  else "streaming-krylov")
    assert mt.lastkeeper == mj.lastkeeper
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-10)
    for name in ("coeffs", "yfitted", "avgderivatives"):
        assert np.max(np.abs(getattr(mt, name)
                             - np.asarray(getattr(mj, name)))) <= 1e-10, name
    assert mt.neffective == pytest.approx(mj.neffective, rel=1e-10)


def test_gap_between_the_routes_is_jax_gap(boundary_fits):
    """The gap, recorded: λ* 4.8357 (streaming) against 4.3773 (adaptive),
    AMEs 3.7% of max|AME| apart at this design; the port's gap equals the
    JAX package's to 1e-10."""
    (ta, ja), (ts, js) = boundary_fits["adaptive"], boundary_fits["streaming"]

    def gap(a, s):
        return (s.lambda_ / a.lambda_ - 1.0,
                float(np.max(np.abs(np.asarray(s.avgderivatives)
                                    - np.asarray(a.avgderivatives)))
                      / np.max(np.abs(np.asarray(a.avgderivatives)))))

    g_t, g_j = gap(ta, ts), gap(ja, js)
    print(f"streaming vs adaptive at N=2048: lambda {ts.lambda_:.6g} / "
          f"{ta.lambda_:.6g} (rel {g_t[0]:.4f}), AMEs {g_t[1]:.4f} of "
          f"max|AME|; JAX {g_j[0]:.4f}, {g_j[1]:.4f}")
    assert g_t == pytest.approx(g_j, abs=1e-10)
    assert g_t[0] > 0.05     # the routes' λ* really differ here
