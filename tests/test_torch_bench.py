"""The port's benchmark (``bigkrls_tpu_torch/bench.py``) on the CPU, at
small N: its metric names against root ``bench.py``'s (read as text, not
imported), the budget's skip records, the records of a whole run on the
CPU (no streaming secondaries off a CUDA device, as the JAX bench gives
none off a TPU), and the timed regions' λ* and coefficients against the
JAX functions root ``bench.py`` times, on the same K in float64; the
records of a retried secondary, the product secondary's check of the
production product against the plain one, and the launch counts its
streaming records and K2 floor are read from."""
import io
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigkrls_tpu.lambda_search import lambda_search_solve as jsolve
from bigkrls_tpu.ops.adaptive import postkernel_adaptive as jadaptive
from bigkrls_tpu.ops.eig import eigensystem as jeigensystem
from bigkrls_tpu.ops.fused import postkernel_device as jdense
from bigkrls_tpu.ops.kernels import gauss_kernel as jgauss
from bigkrls_tpu_torch import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL_N, SMALL_P = 512, 8      # the adaptive route takes k=128 here
SECONDARIES_3106 = ("krls_postkernel_fit_dense_n3106_s",
                    "krls_postkernel_fit_neig50_n3106_s",
                    "krls_cv_census_ptesting20_neig50_s")


def _root_bench_metrics():
    """Every metric name root ``bench.py`` can print: its literal names,
    and its f-string product metric at each N it is called with."""
    text = (ROOT / "bench.py").read_text()
    names = set(re.findall(r'"(krls_[a-z0-9_]+_s)"', text))
    template = re.search(r'f"(streaming_product_n)\{n2\}(_tflops)"', text)
    for n in re.findall(r"_streaming_roofline\(([0-9_]+),", text):
        names.add(template.group(1) + str(int(n)) + template.group(2))
    return names


def _run(monkeypatch, budget):
    monkeypatch.setattr(bench, "N", SMALL_N)
    monkeypatch.setattr(bench, "P", SMALL_P)
    monkeypatch.setenv("BENCH_BUDGET_S", str(budget))
    out, logged = io.StringIO(), []
    assert bench.main(device="cpu", out=out,
                      log=lambda *a: logged.append(" ".join(map(str, a)))) \
        == 0
    return [json.loads(line) for line in out.getvalue().splitlines()], logged


def test_metric_names_match_root_bench():
    names = _root_bench_metrics()
    assert len(names) == 11
    assert set(bench.METRICS) == names
    assert bench.METRICS[-1] == bench.PRIMARY


def test_zero_budget_skips_every_secondary(monkeypatch):
    recs, logged = _run(monkeypatch, 0)
    assert [r["metric"] for r in recs] == [*SECONDARIES_3106, bench.PRIMARY]
    for r in recs[:-1]:
        assert r["value"] is None and r["skipped"].startswith("budget")
    primary = recs[-1]
    assert primary["reps"] == 9 and primary["value"] > 0
    assert primary["value_min"] <= primary["value_median"]
    assert primary["route"].startswith("adaptive-krylov")
    assert primary["data"] == bench.FALLBACK
    assert primary["device"] == "cpu" and primary["card"] == "cpu"
    # the derivatives secondary has no record, only its skip line
    assert any("skipping derivatives" in line for line in logged)


def test_cpu_run_records(monkeypatch):
    recs, logged = _run(monkeypatch, 10_000)
    assert [r["metric"] for r in recs] == [*SECONDARIES_3106, bench.PRIMARY]
    for r in recs:
        assert isinstance(r["value"], float) and r["value"] > 0, r
        assert "failed" not in r and "skipped" not in r
        assert r["torch"] == torch.__version__ and "power_limit" in r
        assert r["data"] == bench.FALLBACK
    assert recs[1]["value_full_eigh"] > 0
    assert recs[2]["route"].startswith("stepwise")
    assert len(recs[2]["pseudoR2_oos"]) == 2
    assert recs[0]["lambda"] == pytest.approx(recs[-1]["lambda"], rel=1e-4)
    # no streaming secondary off a CUDA device
    assert not any("streaming" in r["metric"] for r in recs)
    assert any("derivatives + AME variances" in line for line in logged)


@pytest.fixture(scope="module")
def same_k():
    """A standardized small fallback design and its K, float64."""
    y, X = bench.smoke_data(SMALL_N, SMALL_P)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = (y - y.mean()) / y.std(ddof=1)
    K = np.asarray(jgauss(jnp.asarray(X), float(SMALL_P)))
    return K, y


def _agree(lam_t, c_t, lam_j, c_j):
    assert lam_t == pytest.approx(float(lam_j), rel=1e-10)
    assert np.max(np.abs(c_t.numpy() - np.asarray(c_j))) <= 1e-10


def test_adaptive_region_matches_jax(same_k):
    K, y = same_k
    eig, lam, c, spectrum, k = bench.postkernel_fit_adaptive(
        torch.tensor(K), torch.tensor(y))
    out, lam_j, _, c_j, spec_j = jadaptive(jnp.asarray(K), jnp.asarray(y),
                                           0.001, 1e-3 * SMALL_N)
    assert (k, eig.lastkeeper) == (out.k, out.eig.lastkeeper)
    _agree(lam, c, lam_j, c_j)
    assert np.allclose(spectrum.numpy(), np.asarray(spec_j), rtol=1e-10)


def test_dense_region_matches_jax(same_k):
    K, y = same_k
    eig, lam, c, _ = bench.postkernel_fit_dense(torch.tensor(K),
                                                torch.tensor(y))
    res = jdense(jnp.asarray(K), jnp.asarray(y), jnp.asarray(0.001),
                 jnp.asarray(1e-3 * SMALL_N))
    assert eig.lastkeeper == int(res[2])
    _agree(lam, c, res[3], res[5])


@pytest.mark.parametrize("method", ["auto", "full"])
def test_neig50_region_matches_jax(same_k, method):
    K, y = same_k
    eig, lam, c = bench.postkernel_fit_neig50(torch.tensor(K),
                                              torch.tensor(y), method)
    eig_j = jeigensystem(jnp.asarray(K), neig=50, eigtrunc=0.01,
                         method=method)
    lam_j, _, c_j = jsolve(eig_j, jnp.asarray(y))
    assert eig.lastkeeper == eig_j.lastkeeper
    _agree(lam, c, lam_j, c_j)


def test_adaptive_region_declines_loudly():
    """A design the adaptive route declines (N too small to truncate)
    raises: the primary never times another route."""
    with pytest.raises(RuntimeError, match="adaptive route declined"):
        bench.postkernel_fit_adaptive(torch.eye(200, dtype=torch.float64),
                                      torch.zeros(200, dtype=torch.float64))


def test_shared_yardsticks():
    """The data recipes and bounds that ``chip_smoke.py`` imports."""
    y, X = bench.smoke_data()
    assert X.shape == (bench.N, bench.P)
    assert set(np.unique(X[:, -1])) == {0.0, 1.0}
    ys, Xs = bench.streaming_data(1000)
    rng = np.random.default_rng(2016)
    Xw = rng.normal(size=(1000, 20))
    yw = np.sin(Xw[:, 0]) + Xw @ (0.2 * np.ones(20)) + rng.normal(size=1000)
    assert np.array_equal(Xs, Xw) and np.array_equal(ys, yw)
    # (50000, 20, 540) precise: operations-bound, 17.86 ms on the H100
    ms, by = bench.k2_bound_ms(50_000, 20, 540, "split")
    assert by == "operations" and ms == pytest.approx(17.86, abs=0.01)
    assert bench.k2_cross_bound_ms(50_000, 50_000, 20, 540, "split") == \
        pytest.approx((ms, by), rel=1e-3)
    ms1, by1 = bench.k1_bound_ms(3106, 3106, 67)
    assert by1 == "operations" and ms1 == pytest.approx(0.0193, abs=1e-4)
    assert bench.k2_tol(4096) == 1e-5
    assert bench.k2_tol(50_000) == pytest.approx(2.47e-5, abs=1e-7)


def test_card_info_on_cpu():
    info = bench.card("cpu")
    assert info == {"device": "cpu", "card": "cpu", "power_limit": None,
                    "torch": torch.__version__, "cuda": torch.version.cuda}


def test_election_csv_shape_is_checked(tmp_path):
    path = tmp_path / "e.csv"
    np.savetxt(path, np.zeros((5, 3)), delimiter=",", header="a,b,c",
               comments="")
    with pytest.raises(ValueError, match="expected"):
        bench.load_election(str(path))
    assert bench.load_election(None)[2] == bench.FALLBACK


def test_retry_records_attempts():
    """A secondary that passes only on a retry says so in its record; one
    that fails every attempt gives a ``failed`` record with its count."""
    run = bench._Run("cpu", 1000.0, lambda *a: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("first try")
        run.record("flaky", 1.0)

    def broken():
        raise ValueError("always")

    assert run.retry("ok", lambda: run.record("ok", 1.0), "ok")
    assert run.retry("flaky", flaky, "flaky")
    assert not run.retry("broken", broken, "broken")
    ok, flaky_rec, broken_rec = run.metrics
    assert ok["attempts"] == 1 and "first_error" not in ok
    assert flaky_rec["attempts"] == 2
    assert "first try" in flaky_rec["first_error"]
    assert broken_rec["attempts"] == bench.RETRIES
    assert broken_rec["value"] is None and "always" in broken_rec["failed"]
    assert run.attempts is None and run.first_error is None
    assert "attempts" not in run.record("after", 1.0)


@pytest.mark.parametrize("plain", [True, False])
def test_product_roofline_holds_k2_to_plain(plain):
    """The product secondary holds the production product against the
    plain one (every row, or the first and last ``CHECK_ROWS``) and
    records the error beside ``k2_tol``."""
    run = bench._Run("cpu", 1000.0, lambda *a: None)
    bench._streaming_roofline(run, 600, reps=1, warmup=0, plain=plain)
    (rec,) = run.metrics
    assert rec["metric"] == "streaming_product_n600_tflops"
    assert rec["checked_rows"] == (600 if plain else 2 * bench.CHECK_ROWS)
    assert rec["max_rel_err"] <= rec["tol"] == bench.k2_tol(600)
    assert (rec["plain_ms"] is not None) == plain


def test_product_roofline_refuses_a_wrong_product(monkeypatch):
    from bigkrls_tpu_torch.ops import matvec
    plain = matvec.kernel_matmul_plain
    monkeypatch.setattr(matvec, "kernel_matmul",
                        lambda X, V, s, **k: plain(X, V, s) * (1 + 1e-3))
    run = bench._Run("cpu", 1000.0, lambda *a: None)
    with pytest.raises(RuntimeError, match="differs from the plain"):
        bench._streaming_roofline(run, 600, reps=1, warmup=0, plain=False)
    assert run.metrics == []


def test_launch_floor_from_the_launch_counts(monkeypatch):
    """The streaming records' K2 launches and floor come from
    ``ops/matvec.kernel_matmul_shapes``, which only a kernel launch
    moves: the plain product on the CPU leaves it unchanged."""
    import collections

    from bigkrls_tpu_torch.ops import matvec
    before = matvec.kernel_matmul_shapes.copy()
    X = torch.randn(64, 3, dtype=torch.float64)
    matvec.kernel_matmul(X, torch.randn(64, 5, dtype=torch.float64), 3.0)
    assert bench._launched(before) == []
    counts = collections.Counter({(50_000, 0, 20, 540, "split"): 7,
                                  (50_000, 0, 20, 22, "split"): 1,
                                  (50_000, 0, 20, 540, "fast"): 2})
    monkeypatch.setattr(matvec, "kernel_matmul_shapes", counts + before)
    launched = bench._launched(before)
    assert launched == [[50_000, 0, 20, 22, "split", 1],
                        [50_000, 0, 20, 540, "fast", 2],
                        [50_000, 0, 20, 540, "split", 7]]
    want = (7 * bench.k2_bound_ms(50_000, 20, 540, "split")[0]
            + bench.k2_bound_ms(50_000, 20, 22, "split")[0]
            + 2 * bench.k2_bound_ms(50_000, 20, 540, "fast")[0]) / 1e3
    assert bench.launch_floor_s(launched) == pytest.approx(want)
    cross = [[12_500, 12_500, 20, 540, "split", 4]]
    assert bench.launch_floor_s(cross) == pytest.approx(
        4e-3 * bench.k2_cross_bound_ms(12_500, 12_500, 20, 540, "split")[0])
