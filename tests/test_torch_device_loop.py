"""Port vs JAX: the golden-section λ search as a device loop.

The JAX package runs every golden-section search as one device loop in
the fit's dtype: ``lambda_search._golden_search_device``,
``ops/adaptive._golden_solve`` and the masked loops inside
``ops/fused.postkernel_device`` and ``ops/adaptive._adaptive_fused``. The
port's ``ops/solve.golden_search_device`` runs the same steps in chunks
with one host read each. Both sides get the same basis (numpy, seeded):

* float64: λ* within 1e-15 relative, the same iteration count, Le and the
  coefficients within 1e-12;
* float32: λ* a float32 number, the same iteration count, and within 1
  ulp of JAX's (2 in the loops of the fused programs). XLA on the CPU
  contracts each bracket point a + g·b into one fused multiply-add, and a
  one-ulp difference in a bracket end carries into the next points: JAX's
  λ* is, bit for bit, the port's own steps replayed with every bracket
  point rounded once (:func:`_fma_replay`).

The host loop (``device_loop=False``, ``noisy``) is held to the JAX host
loop in float64.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu_torch as bt
from bigkrls_tpu import lambda_search as jls
from bigkrls_tpu.ops import adaptive as ja
from bigkrls_tpu.ops import fused as jfused
from bigkrls_tpu.ops import solve as jsolve
from bigkrls_tpu.types import Eigensystem as JEig
from bigkrls_tpu_torch import lambda_search as tls
from bigkrls_tpu_torch.ops import fused as tfused
from bigkrls_tpu_torch.ops import solve as tsolve
from bigkrls_tpu_torch.types import Eigensystem as TEig

torch.set_num_threads(1)

SEEDS = range(12)
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}
N, P, K = 600, 3, 120          # the basis problems: N rows, top K pairs
# the JAX dense program's bound bisections, compiled once
_jax_upper = jax.jit(jfused._upper_bound_device, static_argnums=1)
_jax_lower = jax.jit(jfused._lower_bound_device)


def _gauss(X, sigma):
    d = np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
    return np.exp(-d / sigma)


@functools.lru_cache(maxsize=None)
def _kernel_problem(n: int, seed: int):
    """A Gaussian kernel of seeded data and its standardized response."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, P))
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    return _gauss(X, float(P)), (y - y.mean()) / y.std(ddof=1)


@functools.lru_cache(maxsize=None)
def _basis(seed: int):
    """The top K eigenpairs (descending, negated vectors), every
    eigenvalue, and y."""
    Kmat, y = _kernel_problem(N, seed)
    vals, vecs = np.linalg.eigh(Kmat)
    return vals[::-1].copy(), -vecs[:, ::-1][:, :K].copy(), y


def _eigs(seed, dtype):
    """The same basis as a JAX and a port ``Eigensystem`` in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    vals, vecs, y = _basis(seed)
    ej = JEig(values_full=jnp.asarray(vals, jdt),
              vectors=jnp.asarray(vecs, jdt), lastkeeper=K)
    et = TEig(values_full=torch.tensor(vals, dtype=tdt),
              vectors=torch.tensor(vecs, dtype=tdt), lastkeeper=K)
    return ej, et, jnp.asarray(y, jdt), torch.tensor(y, dtype=tdt)


def _bounds(seed, tol=None):
    vals, _, _ = _basis(seed)
    return tls._resolve_bounds(TEig(torch.tensor(vals), None, K), N, None,
                               None, tol)


def _ulps(a: float, b: float) -> int:
    """Distance in float32 steps."""
    ia, ib = (int(np.array(x, np.float32).view(np.int32)) for x in (a, b))
    return abs(ia - ib)


def _fma_replay(steps, it: int) -> float:
    """λ* of the port's branch decisions (``steps``: its state (L, U, X1,
    X2, S1, S2) before the first step and after each), with every bracket
    point computed as XLA's CPU code computes it: a + g·b rounded once
    (exact product and sum in float64, one rounding to float32)."""
    def fma(a, b, c):
        return np.float32(np.float64(a) + np.float64(b) * np.float64(c))

    g = np.float32(tsolve.GOLD)
    L, U = np.float32(steps[0][0]), np.float32(steps[0][1])
    X1, X2 = fma(L, g, U - L), fma(U, -g, U - L)
    for prev in steps[:it]:
        if prev[4] < prev[5]:
            U, X2 = X2, X1
            X1 = fma(L, g, U - L)
        else:
            L, X1 = X1, X2
            X2 = fma(U, -g, U - L)
    last = steps[it]
    return float(X1 if last[4] < last[5] else X2)


def _recording(monkeypatch):
    """Record the state of the port's golden loop before and after every
    step (``golden_chunk`` wrapped); returns the list of numpy rows."""
    real, steps = tsolve.golden_chunk, []

    def spy(state, loo, gold, tol, index, brackets=None):
        if not steps:
            steps.append(state[0].double().numpy())
        seen = []
        out = real(state, loo, gold, tol, index, seen)
        steps.extend(v.double().numpy() for v in seen)
        if brackets is not None:
            brackets.extend(seen)
        return out

    monkeypatch.setattr(tsolve, "golden_chunk", spy)
    return steps


def _same_lambda(lam_t: float, lam_j: float, dtype: str, steps=None,
                 it=None, ulps: int = 1):
    if dtype == "float64":
        assert lam_t == pytest.approx(lam_j, rel=1e-15, abs=0)
        return
    assert float(np.float32(lam_t)) == lam_t, "not a float32 number"
    assert _ulps(lam_t, lam_j) <= ulps, (lam_t, lam_j)
    if steps is not None:
        assert _fma_replay(steps, it) == lam_j


def _same_solution(Le_t, c_t, Le_j, c_j, dtype: str):
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert float(Le_t) == pytest.approx(float(Le_j), rel=tol)
    c_j = np.asarray(c_j, np.float64)
    assert np.max(np.abs(c_t.double().numpy() - c_j)) <= \
        tol * np.max(np.abs(c_j))


def _jax_search(ej, yj, L, U, tol):
    dt = yj.dtype
    Qty, Q2 = jsolve.solve_precompute(ej.vectors, yj)
    lam, it = jls._golden_search_device(
        ej.vectors, ej.values, Qty, Q2, jnp.asarray(L, dt),
        jnp.asarray(U, dt), jnp.asarray(tol, dt))
    return float(lam), int(it)


def _port_search(et, yt, L, U, tol):
    Qty, Q2 = tsolve.solve_precompute(et.vectors, yt)
    lam, it, chunks = tsolve.golden_search_device(et.vectors, et.values,
                                                  Qty, Q2, L, U, tol)
    assert lam.dtype == yt.dtype and lam.dim() == 0
    return float(lam), it, chunks


# ---------------------------------------------------------------------------
# the four JAX loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_golden_search_device_matches_jax(dtype, seed, monkeypatch):
    """``lambda_search._golden_search_device``, no mask."""
    ej, et, yj, yt = _eigs(seed, dtype)
    L, U, tol = _bounds(seed)
    lam_j, it_j = _jax_search(ej, yj, L, U, tol)
    steps = _recording(monkeypatch)
    lam_t, it_t, chunks = _port_search(et, yt, L, U, tol)
    _same_lambda(lam_t, lam_j, dtype, steps, it_t)
    assert it_t == it_j > 0
    assert chunks == max(1, -(-it_t // tsolve.GOLDEN_CHUNK))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_golden_solve_matches_jax(dtype, seed, monkeypatch):
    """``ops/adaptive._golden_solve``: the search and the final solve."""
    ej, et, yj, yt = _eigs(seed, dtype)
    L, U, tol = _bounds(seed)
    jdt = yj.dtype
    lam_j, Le_j, c_j, it_j = ja._golden_solve(
        ej.vectors, ej.values, yj, jnp.asarray(L, jdt), jnp.asarray(U, jdt),
        jnp.asarray(tol, jdt))
    steps = _recording(monkeypatch)
    lam_t, Le_t, c_t, it_t = tsolve.golden_solve(et.vectors, et.values, yt,
                                                 L, U, tol)
    _same_lambda(float(lam_t), float(lam_j), dtype, steps, it_t)
    assert it_t == int(it_j)
    _same_solution(Le_t, c_t, Le_j, c_j, dtype)


@pytest.mark.parametrize("eigtrunc", [0.0, 0.01])
@pytest.mark.parametrize("dtype", DTYPES)
def test_postkernel_device_loop_matches_jax(dtype, eigtrunc, monkeypatch):
    """The masked loop inside ``ops/fused.postkernel_device``, at 12 seeds:
    the port's loop on the JAX program's own eigenbasis, mask and device
    bounds. ``eigtrunc=0`` keeps (nearly) every pair, 0.01 truncates."""
    jdt, tdt = DTYPES[dtype]
    n = 200
    for seed in SEEDS:
        Kmat, y = _kernel_problem(n, seed)
        tol = 1e-3 * n
        yj = jnp.asarray(y, jdt)
        vals, vecs, lk, lam_j, Le_j, c_j, _, it_j = jfused.postkernel_device(
            jnp.asarray(Kmat, jdt), yj, jnp.asarray(eigtrunc, jdt),
            jnp.asarray(tol, jdt))
        U = _jax_upper(vals, n)
        L = jnp.maximum(jnp.asarray(jfused._EPS, jdt), _jax_lower(vals))
        mask = torch.tensor(np.arange(n) < int(lk), dtype=tdt)
        steps = _recording(monkeypatch)
        lam_t, Le_t, c_t, it_t = tsolve.golden_solve(
            torch.tensor(np.asarray(vecs)), torch.tensor(np.asarray(vals)),
            torch.tensor(y, dtype=tdt), torch.tensor(np.asarray(L)),
            torch.tensor(np.asarray(U)), tol, mask=mask)
        _same_lambda(float(lam_t), float(lam_j), dtype, steps, it_t, ulps=2)
        assert it_t == int(it_j), seed
        _same_solution(Le_t, c_t, Le_j, c_j, dtype)


@pytest.mark.parametrize("dtype,eigtrunc", [
    ("float64", 0.001), ("float64", 0.05), ("float32", 0.001),
    ("float32", 0.01)])
def test_adaptive_fused_loop_matches_jax(dtype, eigtrunc, monkeypatch):
    """The masked loop inside ``ops/adaptive._adaptive_fused``, at 12
    seeds: the port's loop on the JAX program's Krylov head, mask and
    completed-spectrum bounds (outputs of the same program). eigtrunc 0.05
    keeps 10 of 64 pairs and puts λ* on the lower bound, where the last
    steps compare losses 3e-6 apart: in float32 that is below what the two
    packages' products agree to (2 of 12 seeds take another step), so that
    case is held in float64, and float32 at 0.01 (27 pairs)."""
    jdt, tdt = DTYPES[dtype]
    n, k, iters = 256, 64, 3
    extra = None if dtype == "float64" else 8
    for seed in SEEDS:
        Kmat, y = _kernel_problem(n, seed)
        tol = 1e-3 * n
        yj = jnp.asarray(y, jdt)
        (vals, vecs, _m, lk, _th, _w, L, U, lam_j, Le_j, c_j, _s,
         it_j) = ja._adaptive_fused(
            jnp.asarray(Kmat, jdt), yj, jax.random.PRNGKey(seed), k, iters,
            jnp.asarray(eigtrunc, jdt), jnp.asarray(tol, jdt), extra)
        mask = torch.tensor(np.arange(k) < int(lk), dtype=tdt)
        steps = _recording(monkeypatch)
        lam_t, Le_t, c_t, it_t = tsolve.golden_solve(
            torch.tensor(np.asarray(vecs)), torch.tensor(np.asarray(vals)),
            torch.tensor(y, dtype=tdt), torch.tensor(np.asarray(L)),
            torch.tensor(np.asarray(U)), tol, mask=mask)
        _same_lambda(float(lam_t), float(lam_j), dtype, steps, it_t, ulps=2)
        assert it_t == int(it_j), seed
        _same_solution(Le_t, c_t, Le_j, c_j, dtype)


def test_a_mask_of_ones_is_no_mask():
    _, et, _, yt = _eigs(0, "float64")
    L, U, tol = _bounds(0)
    a = tsolve.golden_solve(et.vectors, et.values, yt, L, U, tol)
    b = tsolve.golden_solve(et.vectors, et.values, yt, L, U, tol,
                            mask=torch.ones(K, dtype=torch.float64))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert a[3] == b[3]


@pytest.mark.parametrize("seed", SEEDS)
def test_lambda_search_solve_float32_is_jax(seed):
    """The fault the host loop had: it ran the bracket in python float64,
    so an f32 fit reported a λ* that was not the float32 number its
    coefficients were solved at. Now λ* is JAX's float32 number."""
    ej, et, yj, yt = _eigs(seed, "float32")
    lam_j = jls.lambda_search_solve(ej, yj)[0]
    lam_t, Le_t, c_t = tls.lambda_search_solve(et, yt)
    _same_lambda(lam_t, lam_j, "float32")
    Le_at, c_at = tsolve.loo_solver(et.vectors, et.values,
                                    *tsolve.solve_precompute(
                                        et.vectors, yt))(
        torch.tensor(lam_t, dtype=torch.float32))
    assert torch.equal(Le_at, Le_t) and torch.equal(c_at, c_t)


# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_length_changes_no_bit(dtype, monkeypatch):
    """T = 1, 4, 16, 64: the same final state (v, it, running) bit for bit,
    and ⌈iterations / T⌉ chunks, one host read each."""
    _, et, _, yt = _eigs(3, dtype)
    L, U, tol = _bounds(3)
    Qty, Q2 = tsolve.solve_precompute(et.vectors, yt)
    real = tsolve.golden_chunk
    finals = {}
    for T in (1, 4, 16, 64):
        seen = []

        def spy(*a, **kw):
            seen.append(real(*a, **kw))
            return seen[-1]

        monkeypatch.setattr(tsolve, "GOLDEN_CHUNK", T)
        monkeypatch.setattr(tsolve, "golden_chunk", spy)
        lam, it, chunks = tsolve.golden_search_device(
            et.vectors, et.values, Qty, Q2, L, U, tol)
        assert chunks == len(seen) == max(1, -(-it // T))
        finals[T] = (lam, it) + seen[-1]
    ref = finals[1]
    for T, got in finals.items():
        assert got[1] == ref[1]
        for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
            assert torch.equal(a, b), T


@pytest.mark.parametrize("dtype", DTYPES)
def test_tight_tol_needs_several_chunks_and_matches_jax(dtype):
    """A tolerance far under N/1000 (in float32 still 400 ulps of the
    loss, which the two packages' products resolve alike)."""
    ej, et, yj, yt = _eigs(5, dtype)
    L, U, _ = _bounds(5)
    tol = 1e-9 if dtype == "float64" else 1e-2
    lam_j, it_j = _jax_search(ej, yj, L, U, tol)
    lam_t, it_t, chunks = _port_search(et, yt, L, U, tol)
    assert chunks >= 3 and it_t == it_j
    _same_lambda(lam_t, lam_j, dtype)


def test_iteration_cap_matches_jax():
    """tol = −1 never settles: both loops stop at 10 000 iterations. Past
    |λ−λ*| ≈ √ε·λ* the LOO differences are rounding, which torch's and
    XLA's products round differently, so λ* is the JAX loop's to the
    loss's resolution, and the port's host loop's bit for bit (the same
    losses, the same steps)."""
    n, k = 64, 16
    Kmat, y = _kernel_problem(n, 11)
    vals, vecs = np.linalg.eigh(Kmat)
    vals, vecs = vals[::-1].copy(), -vecs[:, ::-1][:, :k].copy()
    ej = JEig(jnp.asarray(vals), jnp.asarray(vecs), k)
    et = TEig(torch.tensor(vals), torch.tensor(vecs), k)
    L, U, _ = tls._resolve_bounds(et, n, None, None, None)
    lam_j, it_j = _jax_search(ej, jnp.asarray(y), L, U, -1.0)
    lam_t, it_t, _ = _port_search(et, torch.tensor(y), L, U, -1.0)
    assert it_t == it_j == tsolve.GOLDEN_MAX_ITERS
    assert lam_t == pytest.approx(lam_j, rel=1e-7, abs=0)
    loo = tsolve.loo_solver(et.vectors, et.values,
                            *tsolve.solve_precompute(et.vectors,
                                                     torch.tensor(y)))
    assert tsolve.golden_section(lambda x: float(loo(x)[0]), L, U, -1.0) \
        == (lam_t, it_t)


# ---------------------------------------------------------------------------
# the host loop, the logs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 4, 9])
def test_lambda_search_host_and_device_loops_match_jax(seed):
    ej, et, yj, yt = _eigs(seed, "float64")
    for device_loop in (True, False):
        lam_j = float(jls.lambda_search(ej, yj, device_loop=device_loop))
        lam_t = tls.lambda_search(et, yt, device_loop=device_loop)
        assert lam_t == pytest.approx(lam_j, rel=1e-15, abs=0), device_loop


def test_device_loop_logs_the_host_loops_brackets():
    """``log`` on the device loop: the host loop's bracket lines, read
    with the chunks' flags; the same λ* as without a log."""
    _, et, _, yt = _eigs(2, "float64")
    L, U, tol = _bounds(2)
    Qty, Q2 = tsolve.solve_precompute(et.vectors, yt)
    dev_lines, host_lines = [], []
    lam, it, _ = tsolve.golden_search_device(et.vectors, et.values, Qty, Q2,
                                             L, U, tol, log=dev_lines.append)
    loo = tsolve.loo_solver(et.vectors, et.values, Qty, Q2)
    lam_h, it_h = tsolve.golden_section(lambda x: float(loo(x)[0]), L, U,
                                        tol, log=host_lines.append)
    assert dev_lines == host_lines and len(dev_lines) == it + 1
    assert float(lam) == lam_h and it == it_h
    quiet = tsolve.golden_search_device(et.vectors, et.values, Qty, Q2, L,
                                        U, tol)
    assert torch.equal(quiet[0], lam)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_heartbeat_ticks_and_matches_quiet(dtype, monkeypatch):
    """Above ``HEARTBEAT_MIN_N`` a noisy fused fit ticks every
    ``HEARTBEAT_EVERY``-th golden-section iteration into its log, from the
    chunks' reads, and gives the quiet fit's λ*; the sink is released."""
    rng = np.random.default_rng(77)
    n = 150
    X = rng.normal(size=(n, 3))
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    monkeypatch.setattr(tfused, "HEARTBEAT_MIN_N", 100)
    lines = []
    kw = dict(device="cpu", dtype=dtype, derivative=False)
    loud = bt.fit(y, X, noisy=True, log=lines.append, **kw)
    quiet = bt.fit(y, X, noisy=False, **kw)
    assert loud.eig_path == "eigh-fused"
    assert loud.lambda_ == quiet.lambda_
    iters = int(next(s for s in lines if "golden-section iterations" in s)
                .split(" selected in ")[1].split()[0])
    ticks = [int(s.rsplit(" ", 1)[1]) for s in lines
             if s.startswith("  golden-section iteration ")]
    assert iters >= 4 and ticks == list(range(4, iters + 1, 4))
    assert tfused._heartbeat_log[0] is print
    monkeypatch.setattr(tfused, "HEARTBEAT_MIN_N", 8192)
    lines.clear()
    bt.fit(y, X, noisy=True, log=lines.append, **kw)
    assert not any(s.startswith("  golden-section iteration ")
                   for s in lines)
