"""The plain reference agrees with the program's CPU float64 fit at small
sizes, on every output the check compares. The reference imports nothing
of the program; this test imports both."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import bigkrls_tpu_torch as bk
from krlsbench import data
from krlsbench.reference import krls


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("route", ["dense", "streaming"])
def test_reference_matches_the_program_in_float64(route):
    torch.set_num_threads(2)
    rng = data.stream(11, 0)
    if route == "dense":
        y, X = data.recipe("low_rank")(rng, 300, 6)
        kw, which, neig = {}, None, None
    else:
        y, X = data.recipe("low_rank")(rng, 900, 6)
        kw = dict(neig=60, streaming=True, which_derivatives=[0, 2, 5])
        which, neig = [0, 2, 5], 60
    m = bk.fit(y, X, device="cpu", dtype=torch.float64, noisy=False, **kw)
    s = bk.summary(m)
    f = krls.prepare(X, y, neig=neig)
    assert f.eig.residual < 1e-9
    assert m.lambda_ == pytest.approx(f.lambda_, rel=1e-10)
    assert m.lastkeeper == f.eig.lastkeeper
    o = krls.outputs(f, m.lambda_, which=which)
    assert m.looe == pytest.approx(o.looe, rel=1e-9)
    assert m.neffective == pytest.approx(o.neffective, rel=1e-10)
    assert m.R2 == pytest.approx(o.R2, abs=1e-10)
    assert _gap(m.coeffs, o.coeffs) < 1e-8
    assert _gap(m.yfitted, o.yfitted) < 1e-8
    assert _gap(m.derivatives, o.derivatives) < 1e-8
    assert _gap(s.ttests[:, 0], o.avgderivatives) < 1e-8
    np.testing.assert_allclose(s.ttests[:, 1], o.se, rtol=1e-8)
    np.testing.assert_allclose(s.ttests[:, 3], o.pvalues, atol=1e-8)
    new = X[:40] + 0.5 * X.std(0, ddof=1)
    p = bk.predict(m, new, se_pred=True)
    yr, ser = krls.predict(f, o, new)
    assert _gap(p.predicted, yr) < 1e-8
    np.testing.assert_allclose(p.se_pred, ser, rtol=1e-8)


def test_truncated_eigensystem_matches_a_full_decomposition():
    y, X = data.recipe("iid_normal")(data.stream(3, 0), 700, 5)
    Xs = torch.as_tensor((X - X.mean(0)) / X.std(0, ddof=1))
    K = krls.kernel(Xs, Xs, 5.0)
    K.fill_diagonal_(1.0)
    top = krls.eig_top(K, 80, 0.001)
    full = krls.eig_full(K, 0.0)
    assert top.residual < krls.KRYLOV_RTOL
    torch.testing.assert_close(top.values, full.values[:80], rtol=1e-10,
                               atol=1e-10 * float(full.values[0]))
    k = top.lastkeeper
    P1 = top.vectors @ top.vectors.T
    P2 = full.vectors[:, :k] @ full.vectors[:, :k].T
    assert float((P1 - P2).abs().max()) < 1e-8


def test_bounds_walk_the_reference_loops():
    vals = np.sort(np.random.default_rng(0).gamma(0.3, 20, size=400))[::-1]
    n = 400
    U = n
    while (vals / (vals + U)).sum() < 1:
        U -= 1
    q = int(np.argmin(np.abs(vals - vals.max() / 1000))) + 1
    k = 0
    while (vals / (vals + krls.EPS + 0.05 * k)).sum() > q:
        k += 1
    assert krls.upper_bound(vals, n) == U
    assert krls.lower_bound(vals) == krls.EPS + 0.05 * k
