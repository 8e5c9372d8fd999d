"""Port vs JAX: checkpoint and resume, the stand-alone adaptive
eigensolver, the command line, the reducibility test, and the port's
imports, float64 on the CPU."""
import ast
import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu import checkpoint as jckpt
from bigkrls_tpu.ops import adaptive as ja
from bigkrls_tpu.ops.stats import standardize as jstandardize
from bigkrls_tpu_torch import checkpoint as tckpt
from bigkrls_tpu_torch import model as tmodel
from bigkrls_tpu_torch.cli import main
from bigkrls_tpu_torch.ops import adaptive as ta
from _port_threads import one_blas_thread  # noqa: F401

jred = importlib.import_module("bigkrls_tpu.reducibility")
tred = importlib.import_module("bigkrls_tpu_torch.reducibility")

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)
ROOT = Path(__file__).resolve().parent.parent


def _data(seed=0, n=50, p=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    y = np.asarray(X @ np.ones(p) + 0.2 * rng.normal(size=n))
    return y, X


def _adaptive_data(n=512):
    """Three smooth columns: a fast-decaying kernel spectrum, so
    ``eig_method="adaptive"`` captures the truncation at N=512."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 3))
    y = np.asarray(np.sin(X[:, 0]) + X[:, 1] + 0.2 * rng.normal(size=n))
    y2 = np.asarray(np.cos(X[:, 0]) + 0.5 * X[:, 2]
                    + 0.2 * rng.normal(size=n))
    return y, y2, X


ADAPTIVE = dict(noisy=False, eigtrunc=0.001, eig_method="adaptive",
                derivative=False, **CPU64)


# ---------------------------------------------------------------------------
# checkpoint and resume (analogs of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_checkpoint_resume_identical(tmp_path):
    y, X = _data()
    d = str(tmp_path / "ck")
    m1 = bt.fit(y, X, noisy=True, checkpoint_dir=d, log=lambda s: None,
                **CPU64)
    assert m1.eig_path == "stepwise:auto"
    assert os.path.exists(os.path.join(d, "eig_meta.json"))
    logs = []
    m2 = bt.fit(y, X, noisy=True, checkpoint_dir=d, log=logs.append,
                **CPU64)
    assert any("resumed from checkpoint" in s for s in logs)
    assert m2.eig_path == "checkpoint"
    assert m1.lambda_ == m2.lambda_
    assert np.array_equal(m1.coeffs, m2.coeffs)
    assert np.array_equal(m1.derivatives, m2.derivatives)


def test_checkpoint_adaptive_resume_bit_exact(tmp_path):
    """The adaptive route keeps its place under ``checkpoint_dir``: an
    identical refit resumes bit-exact from the stored solution, a changed
    y reuses the eig prefix without rewriting the vectors and stores the
    new solution, and a config change recomputes."""
    y, y2, X = _adaptive_data()
    d = str(tmp_path / "ck")
    m1 = bt.fit(y, X, checkpoint_dir=d, **ADAPTIVE)
    assert m1.eig_path.startswith("adaptive-krylov"), m1.eig_path
    assert os.path.exists(os.path.join(d, "adaptive_meta.json"))
    m2 = bt.fit(y, X, checkpoint_dir=d, **ADAPTIVE)
    assert m2.eig_path == "checkpoint"
    assert m1.lambda_ == m2.lambda_ and m1.looe == m2.looe
    assert np.array_equal(m1.coeffs, m2.coeffs)
    assert m1.neffective == m2.neffective
    assert not m2.spectrum_is_complete and m2.eig_tail_theta.size > 0

    vec = Path(d, "adaptive_vectors.bin")
    stamp = (vec.stat().st_mtime_ns, vec.stat().st_size)
    m4 = bt.fit(y2, X, checkpoint_dir=d, **ADAPTIVE)
    assert (vec.stat().st_mtime_ns, vec.stat().st_size) == stamp
    assert m4.eig_path == "checkpoint"
    m4f = bt.fit(y2, X, **ADAPTIVE)
    assert m4.lambda_ == pytest.approx(m4f.lambda_, rel=1e-9)
    assert np.max(np.abs(m4.coeffs - m4f.coeffs)) < 1e-9
    with open(os.path.join(d, "adaptive_meta.json")) as fh:
        assert json.load(fh)["lam"] == m4.lambda_
    m5 = bt.fit(y2, X, checkpoint_dir=d, **ADAPTIVE)
    assert m5.eig_path == "checkpoint" and m5.lambda_ == m4.lambda_
    assert np.array_equal(m5.coeffs, m4.coeffs)

    m3 = bt.fit(y, X, checkpoint_dir=d, **{**ADAPTIVE, "eigtrunc": 0.002})
    assert m3.eig_path != "checkpoint"


@pytest.mark.parametrize("change", ["data", "config"])
def test_checkpoint_invalidated(tmp_path, change):
    y, X = _data()
    d = str(tmp_path / "ck")
    bt.fit(y, X, noisy=False, checkpoint_dir=d, **CPU64)
    kw = {}
    if change == "data":
        X = X.copy()
        X[0, 0] += 1.0
    else:
        kw["sigma"] = 7.0
    logs = []
    m = bt.fit(y, X, noisy=True, checkpoint_dir=d, log=logs.append, **kw,
               **CPU64)
    assert not any("resumed" in s for s in logs)
    assert m.eig_path != "checkpoint"


def test_torn_checkpoint_overwrite_invalidates(tmp_path, monkeypatch):
    """The meta is unlinked before any array is written, so a crash in a
    different-config overwrite reads as "no checkpoint", never as the old
    meta paired with new arrays."""
    y, X = _data()
    d = str(tmp_path / "ck")
    bt.fit(y, X, noisy=False, checkpoint_dir=d, **CPU64)
    meta_p = os.path.join(d, "eig_meta.json")
    assert os.path.exists(meta_p)

    def boom(*a, **k):
        raise RuntimeError("simulated crash mid-checkpoint")

    monkeypatch.setattr(np, "save", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        bt.fit(y, X, sigma=7.0, noisy=False, checkpoint_dir=d, **CPU64)
    monkeypatch.undo()
    assert not os.path.exists(meta_p)
    m2 = bt.fit(y, X, sigma=7.0, noisy=False, checkpoint_dir=d, **CPU64)
    assert os.path.exists(meta_p) and m2.eig_path != "checkpoint"
    m3 = bt.fit(y, X, sigma=7.0, noisy=False, checkpoint_dir=d, **CPU64)
    assert m3.eig_path == "checkpoint"
    assert np.allclose(m2.coeffs, m3.coeffs)


def test_corrupt_checkpoint_recomputed(tmp_path):
    y, X = _data()
    d = str(tmp_path / "ck")
    m1 = bt.fit(y, X, noisy=False, checkpoint_dir=d, **CPU64)
    p = os.path.join(d, "eig_vectors.bin")
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    m2 = bt.fit(y, X, noisy=False, checkpoint_dir=d, **CPU64)
    assert m2.eig_path != "checkpoint"          # checksum caught it
    assert np.allclose(m1.coeffs, m2.coeffs)


def test_streaming_checkpoint_resume(tmp_path):
    """The streaming route stores its eigensystem too; the resume skips
    eigensystem_streaming and reproduces λ* and the coefficients."""
    y, X = _data(n=300)
    d = str(tmp_path / "ck")
    kw = dict(neig=40, streaming=True, noisy=False, checkpoint_dir=d,
              **CPU64)
    m1 = bt.fit(y, X, **kw)
    m2 = bt.fit(y, X, **kw)
    assert (m1.eig_path, m2.eig_path) == ("streaming-krylov", "checkpoint")
    assert m2.K is None and m1.lambda_ == m2.lambda_
    assert np.array_equal(m1.coeffs, m2.coeffs)


# ---------------------------------------------------------------------------
# interchange with the JAX package's checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fingerprints_match_jax(dtype):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(40, 3)).astype(dtype)
    y = rng.normal(size=40)
    want = jckpt.fingerprint(X, 3.0, 40, 0.001, dtype)
    assert tckpt.fingerprint(X, 3.0, 40, 0.001, dtype) == want
    assert tckpt.fingerprint(torch.as_tensor(X), 3.0, 40, 0.001,
                             getattr(torch, dtype)) == want
    assert tckpt.solution_fingerprint(torch.as_tensor(y), 0.04) == \
        jckpt.solution_fingerprint(y, 0.04)


def test_jax_adaptive_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint written by the JAX package's fit, read by the port's
    ``load_adaptive`` under the JAX fit's fingerprints and run through
    ``resume_adaptive``, gives the JAX fit's λ* and coefficients."""
    y, _, X = _adaptive_data()
    n = X.shape[0]
    d = str(tmp_path / "jck")
    mj = bk.fit(y, X, checkpoint_dir=d, noisy=False, eigtrunc=0.001,
                eig_method="adaptive", derivative=False)
    assert mj.eig_path.startswith("adaptive-krylov")
    X_std, y_std = (np.asarray(a) for a in
                    jstandardize(jnp.asarray(X), jnp.asarray(y))[:2])
    fp = tckpt.fingerprint(X_std, 3.0, n, 0.001, torch.float64)
    sol_fp = tckpt.solution_fingerprint(y_std, n / 1000.0)
    out, sol = tckpt.load_adaptive(d, fp, torch.float64, sol_fp,
                                   device="cpu")
    assert out.k >= 64 and out.eig.lastkeeper == mj.lastkeeper
    assert sol[0] == mj.lambda_
    lam, Le, coeffs = ta.resume_adaptive(out, torch.tensor(y_std),
                                         n / 1000.0)
    assert lam == pytest.approx(mj.lambda_, rel=1e-10)
    assert float(Le) * float(np.std(y, ddof=1)) == pytest.approx(
        mj.looe, rel=1e-10)
    assert np.max(np.abs(coeffs.numpy() - mj.coeffs)) <= 1e-10
    assert tckpt.load_adaptive(d, fp[::-1], torch.float64) is None


# ---------------------------------------------------------------------------
# the stand-alone adaptive eigensolver fed the JAX start block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decaying_kernel():
    """K = Q diag(exp(-i/10)) Qᵀ at n=512: lastkeeper(0.001) ≈ 70 lies past
    the first k=64, so the solver grows k once (to the cap, 128)."""
    n = 512
    rng = np.random.default_rng(11)
    lams = np.exp(-np.arange(n) / 10.0)
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    K = 0.5 * ((Q * lams) @ Q.T + ((Q * lams) @ Q.T).T)
    return K


def _jax_start(n):
    key = jax.random.PRNGKey(0)
    return lambda q: torch.tensor(np.asarray(
        jax.random.normal(key, (n, q), dtype=jnp.float64)))


@pytest.mark.parametrize("eigtrunc", [0.001, 0.01])
def test_adaptive_eigensystem_matches_jax(decaying_kernel, eigtrunc):
    K = decaying_kernel
    n = K.shape[0]
    jo = ja.adaptive_eigensystem(jnp.asarray(K), eigtrunc=eigtrunc)
    to = ta.adaptive_eigensystem(torch.as_tensor(K), eigtrunc=eigtrunc,
                                 start=_jax_start(n))
    assert to.k == jo.k > 64
    assert to.eig.lastkeeper == jo.eig.lastkeeper
    assert to.L == pytest.approx(jo.L, rel=1e-12)
    assert to.U == jo.U
    assert np.allclose(to.eig.values_full.numpy(),
                       np.asarray(jo.eig.values_full), rtol=0, atol=1e-12)
    # same eigenvectors up to the last bits (both negated)
    assert np.max(np.abs(to.eig.vectors.numpy()
                         - np.asarray(jo.eig.vectors))) <= 1e-8
    assert np.allclose(to.tail_theta, jo.tail_theta, rtol=1e-8)
    # the head crosses λ₁/1000 even under the coarse eigtrunc
    vals = to.eig.values_full.numpy()
    assert vals[-1] < vals[0] / 1000.0
    assert to.neffective(0.5, n) == pytest.approx(jo.neffective(0.5, n),
                                                  rel=1e-10)


def test_adaptive_eigensystem_declines_like_jax():
    K = np.eye(200)
    assert ta.adaptive_eigensystem(torch.as_tensor(K), 0.001) is None
    assert ja.adaptive_eigensystem(jnp.asarray(K), 0.001) is None


# ---------------------------------------------------------------------------
# the command line (after tests/test_cli_reducibility.py)
# ---------------------------------------------------------------------------

def _write_csv(path, y, X):
    np.savetxt(path, np.column_stack([y, X]), delimiter=",",
               header="y," + ",".join(f"x{i}" for i in range(X.shape[1])),
               comments="")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_fit_summary_predict_plot_explore(tmp_path, capsys,
                                              monkeypatch):
    # --x64 sets the package's default dtype; put it back afterwards
    monkeypatch.setattr(tmodel, "DEFAULT_DTYPE", tmodel.DEFAULT_DTYPE)
    rng = np.random.default_rng(0)
    n, p = 60, 3
    X = rng.normal(size=(n, p))
    y = X @ np.ones(p) + 0.2 * rng.normal(size=n)
    data = str(tmp_path / "d.csv")
    _write_csv(data, y, X)
    dev = ["--device", "cpu"]
    model_dir = str(tmp_path / "model")
    assert main(["fit", data, "--out", model_dir, "--x64", *dev]) == 0
    rep = _last_json(capsys)
    assert rep["saved"] == model_dir and rep["device"] == "cpu"
    m = bt.load_model(model_dir, device="cpu")
    mj = bk.fit(y, X, noisy=False)
    assert m.lambda_ == pytest.approx(mj.lambda_, rel=1e-9)

    assert main(["summary", model_dir, *dev]) == 0
    assert str(bt.summary(m)) in capsys.readouterr().out

    newdata = str(tmp_path / "new.csv")
    np.savetxt(newdata, X[:7], delimiter=",")
    out_csv = str(tmp_path / "pred.csv")
    assert main(["predict", model_dir, newdata, "--se", "--out", out_csv,
                 *dev]) == 0
    assert _last_json(capsys)["n"] == 7
    pred = np.loadtxt(out_csv, delimiter=",", skiprows=1)
    direct = bt.predict(m, X[:7], se_pred=True)
    assert pred.shape == (7, 2)
    assert np.allclose(pred[:, 0], direct.predicted, atol=1e-12)
    assert np.allclose(pred[:, 1], direct.se_pred, atol=1e-12)

    assert main(["reducibility", model_dir, "--loss", "1", *dev]) == 0
    assert "L1 loss" in capsys.readouterr().out
    assert main(["plot", model_dir, "-o", str(tmp_path / "fx.png"),
                 *dev]) == 0
    assert os.path.exists(tmp_path / "fx.png")
    html = str(tmp_path / "fx.html")
    assert main(["explore", model_dir, "-o", html, "--title", "cli test",
                 *dev]) == 0
    assert "cli test" in open(html).read()


def test_cli_cv_and_no_vcov(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tmodel, "DEFAULT_DTYPE", tmodel.DEFAULT_DTYPE)
    rng = np.random.default_rng(1)
    n, p = 80, 3
    X = rng.normal(size=(n, p))
    y = X @ np.ones(p) + 0.3 * rng.normal(size=n)
    data = str(tmp_path / "d.csv")
    _write_csv(data, y, X)
    out = str(tmp_path / "cv")
    assert main(["cv", data, "--seed", "3", "--kfolds", "2",
                 "--no-derivative", "--x64", "--out", out,
                 "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    cj = bk.crossvalidate(y, X, seed=3, kfolds=2, derivative=False,
                          noisy=False)
    assert str(bk.summary_cv(cj)) in text
    assert np.array_equal(bt.load_model(out, device="cpu").folds, cj.folds)
    m_dir = str(tmp_path / "m")
    assert main(["fit", data, "--out", m_dir, "--no-derivative",
                 "--no-vcov", "--device", "cpu"]) == 0
    m = bt.load_model(m_dir, device="cpu")
    assert m.derivatives is None and m.vcov_c_factored is None
    with pytest.raises(SystemExit):
        main(["fit", data, "--out", str(tmp_path / "m2"), "--no-vcov",
              "--device", "cpu"])


def test_cli_warmup_reports_both_fits(tmp_path, capsys):
    cache = str(tmp_path / "cache")
    assert main(["warmup", "--shapes", "64x4", "--binary-cols", "1",
                 "--cache-dir", cache, "--device", "cpu"]) == 0
    rep = _last_json(capsys)
    assert (rep["n"], rep["p"], rep["device"]) == (64, 4, "cpu")
    assert rep["cache_dir"] == cache
    assert rep["compile_overhead_s"] == pytest.approx(
        rep["first_s"] - rep["steady_s"], abs=2e-3)
    assert {p["phase"] for p in rep["first_timings"]} == \
        {p["phase"] for p in rep["steady_timings"]}


def test_cli_refuses_mesh_runs_bench(tmp_path, capsys, monkeypatch):
    """A mesh the visible devices cannot hold is refused with the JAX
    package's message (virtual shards are API-only), a mesh that is not a
    ``Mesh`` raises, and ``bench`` runs the port's benchmark (here on the
    CPU at a small N, a zero budget): exit 0, the primary printed last."""
    from bigkrls_tpu_torch import bench
    y, X = _data()
    data = str(tmp_path / "d.csv")
    _write_csv(data, y, X)
    with pytest.raises(SystemExit, match="needs 4 devices, only 1 visible"):
        main(["fit", data, "--out", str(tmp_path / "m"), "--mesh", "2x2",
              "--device", "cpu"])
    with pytest.raises(TypeError, match="Mesh"):
        bt.fit(y, X, mesh=object(), **CPU64)
    capsys.readouterr()
    monkeypatch.setattr(bench, "N", 512)
    monkeypatch.setattr(bench, "P", 8)
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    assert main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert recs[-1]["metric"] == bench.PRIMARY and recs[-1]["reps"] == 9
    assert recs[-1]["device"] == "cpu"
    assert all("skipped" in r for r in recs[:-1]) and len(recs) == 4


# ---------------------------------------------------------------------------
# reducibility
# ---------------------------------------------------------------------------

def test_wilcoxon_and_bh_match_jax():
    rng = np.random.default_rng(2)
    for x, y in ((rng.normal(size=200), np.zeros(200)),
                 (rng.normal(size=200) - 1.0, rng.normal(size=200)),
                 (np.round(rng.normal(size=50), 1), np.zeros(50)),
                 (np.zeros(5), np.zeros(5))):
        assert tred.wilcoxon_paired_less(x, y) == \
            jred.wilcoxon_paired_less(x, y)
    for p in (np.array([0.001, 0.002, 0.04, 0.2, 0.9]),
              np.array([0.5, 0.9]), rng.uniform(size=30) ** 3):
        for q in (0.05, 0.2):
            assert np.array_equal(tred.benjamini_hochberg_reject(p, q),
                                  jred.benjamini_hochberg_reject(p, q))


@pytest.mark.parametrize("loss,q", [(2, 0.05), (1, 0.1)])
def test_reducibility_matches_jax(loss, q):
    rng = np.random.default_rng(3)
    n, p = 300, 4
    X = rng.normal(size=(n, p))
    y = X @ np.array([1.0, 2.0, -1.0, 0.5]) + np.sin(2 * X[:, 0]) \
        + 0.3 * rng.normal(size=n)
    mj = bk.fit(y, X, noisy=False)
    mt = bt.fit(y, X, noisy=False, **CPU64)
    rt, rj = tred.reducibility(mt, loss, q), jred.reducibility(mj, loss, q)
    assert rt.labels == rj.labels and (rt.loss, rt.q) == (rj.loss, rj.q)
    assert np.allclose(rt.pvalues, rj.pvalues, rtol=1e-9, atol=1e-15)
    assert np.array_equal(rt.reject, rj.reject)
    assert str(bt.reducibility(mt, loss=loss, q=q)).splitlines()[0] == \
        str(rj).splitlines()[0]


# ---------------------------------------------------------------------------
# the port imports nothing of JAX
# ---------------------------------------------------------------------------

_PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in
                     (ROOT / "bigkrls_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "tools/scale_fits.py", "tools/multi_card.py",
       "tools/golden_loop.py"]


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_imports_no_jax(path):
    """An AST scan: no import of jax, jaxlib or bigkrls_tpu anywhere in
    the port or in chip_smoke.py (the test process itself has JAX loaded,
    so a runtime check could not tell)."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    banned = ("jax", "jaxlib", "bigkrls_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (path, name)


def test_port_scan_covers_bench():
    """The scan above reaches the port's benchmark and its scale check."""
    assert {"bigkrls_tpu_torch/bench.py", "tools/scale_fits.py"} <= \
        set(_PORT_FILES)


def test_port_scan_covers_parallel():
    """The scan above reaches the multi-device package."""
    want = {f"bigkrls_tpu_torch/parallel/{m}.py" for m in
            ("sharded", "ring_kernel", "jacobi", "distributed", "fit_step")}
    assert want <= set(_PORT_FILES)
