"""Port vs JAX: cross-validation, persistence, the native matrix store,
plotting and the effects explorer, float64 on the CPU."""
import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu import persistence as jpersist
from bigkrls_tpu.native import matstore as jmatstore
from bigkrls_tpu_torch import convert
from bigkrls_tpu_torch import model as tmodel
from bigkrls_tpu_torch import persistence as tpersist
from bigkrls_tpu_torch.native import matstore
from data_mtcars import mtcars_xy

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def _close(a, b, tol):
    """Equal, or within ``tol`` relative to max(1, |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.all(np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b)))


@pytest.fixture(scope="module")
def synth():
    """The JAX suite's CV data (N=120, P=4), with one binary column."""
    gen = np.random.default_rng(42)
    n, p = 120, 4
    X = gen.normal(size=(n, p))
    X[:, 3] = (X[:, 3] > 0).astype(float)
    y = np.asarray(X @ np.arange(1, p + 1) + gen.normal(size=n))
    return y, X


@pytest.fixture(scope="module")
def cv_pairs(synth):
    """(port, JAX) CV objects: a ptesting split and a 3-fold run."""
    y, X = synth
    out = {}
    for name, kw in (("ptesting", dict(seed=123, ptesting=20)),
                     ("kfolds", dict(seed=99, kfolds=3))):
        out[name] = (bt.crossvalidate(y, X, noisy=False, **kw, **CPU64),
                     bk.crossvalidate(y, X, noisy=False, **kw))
    return out


@pytest.fixture(scope="module")
def mtcars_pair():
    y, X, labs = mtcars_xy()
    mj = bk.fit(y, X, eigtrunc=0.0, xlabs=labs, noisy=False)
    mt = bt.fit(y, X, eigtrunc=0.0, xlabs=labs, noisy=False, **CPU64)
    return mt, mj, y, X


# ---------------------------------------------------------------------------
# cross-validation
# ---------------------------------------------------------------------------

_PARTITION_DATA = np.random.default_rng(8).normal(size=(53, 3))


@pytest.mark.parametrize("seed", [1, 17, 2016])
@pytest.mark.parametrize("mode", [dict(ptesting=20),
                                  dict(kfolds=5, equalize_folds=False),
                                  dict(kfolds=5, equalize_folds=True)])
def test_partitions_match_jax(mode, seed):
    """Train/test rows, fold assignments and held-out rows identical to the
    JAX package's for the same seed (N=53: N % 5 = 3)."""
    X = _PARTITION_DATA
    y = X @ np.ones(3) + 0.3 * np.sin(7 * X[:, 0])
    kw = dict(seed=seed, noisy=False, derivative=False, **mode)
    ct = bt.crossvalidate(y, X, **kw, **CPU64)
    cj = bk.crossvalidate(y, X, **kw)
    assert ct.type == cj.type
    if "ptesting" in mode:
        for key in ("train_set", "test_set"):
            assert np.array_equal(ct.indices[key], cj.indices[key])
        assert len(ct.indices["test_set"]) == round(53 * 0.2)
    else:
        assert np.array_equal(ct.folds, cj.folds)
        if mode["equalize_folds"]:
            assert np.array_equal(ct.indices["dropped"],
                                  cj.indices["dropped"])
            assert {f.trained.n for f in ct.fold_results} == {40}
        else:
            assert ct.indices is None and cj.indices is None
            assert sorted(int((ct.folds == k).sum())
                          for k in range(5)) == [10, 10, 11, 11, 11]


@pytest.mark.parametrize("name", ["ptesting", "kfolds"])
def test_cv_metrics_match_jax(cv_pairs, name):
    ct, cj = cv_pairs[name]
    assert sorted(ct.metrics) == sorted(cj.metrics)
    for key in ct.metrics:
        assert _close(ct.metrics[key], cj.metrics[key], 1e-9), key
    for ft, fj in zip(ct.fold_results, cj.fold_results):
        assert ft.trained.eig_path == fj.trained.eig_path
        assert _close(ft.tested.predicted, fj.tested.predicted, 1e-9)


@pytest.mark.parametrize("name", ["ptesting", "kfolds"])
def test_summary_cv_text_matches_jax(cv_pairs, name):
    ct, cj = cv_pairs[name]
    st, sj = bt.summary_cv(ct), bk.summary_cv(cj)
    assert str(st) == str(sj)
    assert str(st).startswith("\nOverview of Model Performance")
    assert sorted(st) == sorted(sj)


@pytest.mark.parametrize("kw", [dict(kfolds=3, ptesting=20), dict(),
                                dict(ptesting=0), dict(ptesting=100),
                                dict(kfolds=0), dict(kfolds=1),
                                dict(kfolds=121)])
def test_crossvalidate_argument_errors(synth, kw):
    y, X = synth
    with pytest.raises(ValueError) as et:
        bt.crossvalidate(y, X, seed=1, noisy=False, **kw, **CPU64)
    with pytest.raises(ValueError) as ej:
        bk.crossvalidate(y, X, seed=1, noisy=False, **kw)
    assert str(et.value) == str(ej.value)


def test_equalize_folds_warning_states_parity(synth, caplog):
    y, X = synth
    with caplog.at_level("WARNING", logger="bigkrls_tpu_torch"):
        cv = bt.crossvalidate(y[:103], X[:103], seed=9, kfolds=5,
                              equalize_folds=True, noisy=False,
                              derivative=False, **CPU64)
    assert cv.indices["dropped"].size == 3
    assert "JAX package" in caplog.text and "XLA" not in caplog.text


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def test_save_load_model_roundtrip(tmp_path, mtcars_pair):
    mt, _, _, X = mtcars_pair
    folder = bt.save_model(mt, str(tmp_path / "m"))
    back = bt.load_model(folder, device="cpu")
    assert torch.equal(back.K, mt.K) and back.K.dtype == torch.float64
    for name in ("X", "y", "coeffs", "yfitted", "derivatives",
                 "avgderivatives", "var_avgderivatives", "K_eigenvalues",
                 "x_means", "x_sds", "binaryindicator"):
        assert np.array_equal(getattr(back, name), getattr(mt, name)), name
    for name in ("lambda_", "looe", "R2", "R2AME", "lastkeeper",
                 "neffective", "sigmasq_std", "y_mean", "y_sd", "eig_path"):
        assert getattr(back, name) == getattr(mt, name), name
    assert list(back.xlabs) == list(mt.xlabs) and back.path == folder
    assert torch.equal(back.vcov_c_factored.Q, mt.vcov_c_factored.Q)
    assert back.vcov_c_factored.scale == mt.vcov_c_factored.scale
    a = bt.predict(mt, X[:5], se_pred=True)
    b = bt.predict(back, X[:5], se_pred=True)
    assert np.array_equal(a.predicted, b.predicted)
    assert np.array_equal(a.se_pred, b.se_pred)


def test_save_load_keeps_f32(tmp_path, synth):
    """An f32 fit saves f32 arrays and loads as f32 (dtype=None); an
    explicit dtype converts."""
    y, X = synth
    m = bt.fit(y, X, noisy=False, device="cpu", dtype=torch.float32)
    folder = bt.save_model(m, str(tmp_path / "m32"))
    with np.load(os.path.join(folder, "arrays.npz")) as data:
        assert data["K"].dtype == np.float32
        assert data["vcov_Q"].dtype == np.float32
        assert data["coeffs"].dtype == np.float64
    back = bt.load_model(folder, device="cpu")
    assert back.K.dtype == torch.float32 and torch.equal(back.K, m.K)
    as64 = bt.load_model(folder, device="cpu", dtype=torch.float64)
    assert as64.vcov_c_factored.Q.dtype == torch.float64


def test_save_load_prediction_and_cv(tmp_path, cv_pairs, synth):
    y, X = synth
    ct, _ = cv_pairs["kfolds"]
    folder = bt.save_model(ct, str(tmp_path / "cv"))
    back = bt.load_model(folder, device="cpu")
    assert back.type == "KfoldsCV" and back.kfolds == 3 and back.seed == 99
    assert np.array_equal(back.folds, ct.folds)
    for key in ct.metrics:
        assert np.array_equal(back.metrics[key], ct.metrics[key])
    for fb, fc in zip(back.fold_results, ct.fold_results):
        assert np.array_equal(fb.trained.coeffs, fc.trained.coeffs)
        assert np.array_equal(fb.tested.predicted, fc.tested.predicted)
        assert fb.tested.MSE == fc.tested.MSE
    cp, _ = cv_pairs["ptesting"]
    back = bt.load_model(bt.save_model(cp, str(tmp_path / "cvp")),
                         device="cpu")
    assert np.array_equal(back.indices["test_set"], cp.indices["test_set"])
    pred = bt.predict(cp.trained, X[:9], ytest=y[:9], se_pred=True)
    pb = bt.load_model(bt.save_model(pred, str(tmp_path / "p")))
    for name in ("predicted", "se_pred", "newdata", "newdataK", "ytest"):
        assert np.array_equal(getattr(pb, name), getattr(pred, name)), name
    assert (pb.pseudoR2, pb.MSE) == (pred.pseudoR2, pred.MSE)


def test_save_load_adaptive_tail_roundtrip(tmp_path):
    """An adaptive model's head eigenvalues, tail quadrature and
    ``spectrum_is_complete`` survive the round trip."""
    gen = np.random.default_rng(3)
    n = 512
    X = gen.normal(size=(n, 3))
    y = np.sin(X[:, 0]) + X[:, 1] + 0.2 * gen.normal(size=n)
    m = bt.fit(y, X, eigtrunc=0.001, eig_method="adaptive",
               derivative=False, noisy=False, **CPU64)
    assert m.eig_path.startswith("adaptive-krylov")
    back = bt.load_model(bt.save_model(m, str(tmp_path / "ma")),
                         device="cpu")
    assert not back.spectrum_is_complete
    for name in ("K_eigenvalues", "eig_tail_theta", "eig_tail_w"):
        assert np.array_equal(getattr(back, name), getattr(m, name)), name
    assert back.eig_path == m.eig_path


def test_save_collision_suffix(tmp_path, mtcars_pair):
    mt = mtcars_pair[0]
    f1 = bt.save_model(mt, str(tmp_path / "m"))
    f2 = bt.save_model(mt, str(tmp_path / "m"))
    assert f1 != f2 and f2 == f1 + "1"
    assert bt.save_model(mt, str(tmp_path / "m"),
                         overwrite_existing=True) == f1


def test_jax_folder_loads_in_port(tmp_path, mtcars_pair):
    _, mj, _, X = mtcars_pair
    folder = bk.save_model(mj, str(tmp_path / "jax"))
    mt = bt.load_model(folder, device="cpu")
    assert mt.vcov_c_factored.Q.dtype == torch.float64
    Xn = X[:7] + 0.25
    pt, pj = (bt.predict(mt, Xn, se_pred=True),
              bk.predict(mj, Xn, se_pred=True))
    assert _close(pt.predicted, pj.predicted, 1e-10)
    assert _close(pt.se_pred, pj.se_pred, 1e-10)


def test_port_folder_loads_in_jax(tmp_path, mtcars_pair):
    mt, _, _, X = mtcars_pair
    folder = bt.save_model(mt, str(tmp_path / "port"))
    mj = bk.load_model(folder)
    assert mj.lambda_ == mt.lambda_ and mj.eig_path == mt.eig_path
    Xn = X[:7] + 0.25
    pt, pj = (bt.predict(mt, Xn, se_pred=True),
              bk.predict(mj, Xn, se_pred=True))
    assert _close(pj.predicted, pt.predicted, 1e-10)
    assert _close(pj.se_pred, pt.se_pred, 1e-10)


def test_bin_files_are_the_jax_format(tmp_path, monkeypatch, mtcars_pair):
    """Float64 arrays past ``MMAP_THRESHOLD`` go to raw ``.bin`` files of
    the JAX package's byte format; the port reads a JAX-written one (past
    its header) exactly."""
    mt, mj, _, _ = mtcars_pair
    monkeypatch.setattr(tpersist, "MMAP_THRESHOLD", 1000)
    monkeypatch.setattr(jpersist, "MMAP_THRESHOLD", 1000)
    ft = bt.save_model(mt, str(tmp_path / "port"))
    fj = bk.save_model(mj, str(tmp_path / "jax"))
    with open(os.path.join(ft, "bigmats.json")) as fh:
        assert json.load(fh) == {"K": [32, 32], "vcov_Q": [32, 32]}
    raw_t = open(os.path.join(ft, "K.bin"), "rb").read()
    raw_j = open(os.path.join(fj, "K.bin"), "rb").read()
    assert len(raw_t) == len(raw_j) == 32 + 8 * 32 * 32 + 8
    assert raw_t[:8] == raw_j[:8]                  # the format's magic
    back = bt.load_model(fj, device="cpu")
    assert np.array_equal(back.K.numpy(), np.asarray(mj.K))
    assert np.array_equal(bt.load_model(ft, device="cpu").K.numpy(),
                          mt.K.numpy())


def test_default_placement_is_fits():
    """``convert`` and ``load_model`` put tensors where ``fit`` does by
    default: the card, in the package's default dtype."""
    fit_dev = inspect.signature(tmodel._fit_impl).parameters["device"]
    for fn in (convert.model_from_numpy, convert.model_from_reference,
               bt.load_model):
        assert inspect.signature(fn).parameters["device"].default == \
            fit_dev.default == "cuda"
        assert inspect.signature(fn).parameters["dtype"].default is None
    fields = dict(X=np.ones((2, 1)), y=np.ones(2), coeffs=np.ones(2),
                  vcov_Q=np.eye(2), vcov_spectrum=np.ones(2))
    m = convert.model_from_numpy(fields, device="cpu")
    assert m.vcov_c_factored.Q.dtype == tmodel.DEFAULT_DTYPE == torch.float32
    try:
        bt.enable_x64()
        m = convert.model_from_numpy(fields, device="cpu")
        assert m.vcov_c_factored.Q.dtype == torch.float64
    finally:
        tmodel.DEFAULT_DTYPE = torch.float32


def test_fit_model_subfolder_name(tmp_path, synth):
    y, X = synth
    target = str(tmp_path / "during")
    m = bt.fit(y, X, noisy=False, model_subfolder_name=target, **CPU64)
    assert m.path == target
    assert np.array_equal(bt.load_model(target, device="cpu").coeffs,
                          m.coeffs)
    m2 = bt.fit(y, X, noisy=False, model_subfolder_name=target, **CPU64)
    assert m2.path == target + "1"
    m3 = bt.fit(y, X, noisy=False, model_subfolder_name=target,
                overwrite_existing=True, **CPU64)
    assert m3.path == target


def test_fit_trace_dir_writes_trace(tmp_path, synth):
    y, X = synth
    d = tmp_path / "trace"
    bt.fit(y[:48], X[:48], noisy=False, derivative=False, trace_dir=str(d),
           **CPU64)
    files = list(d.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    # the fit's spans, as ranges named by path
    names = {e.get("name") for e in events}
    assert {"bigkrls.fit", "bigkrls.fit/kernel/prepare",
            "bigkrls.fit/eigendecomposition"} <= names


# ---------------------------------------------------------------------------
# native matrix store
# ---------------------------------------------------------------------------

def test_native_matstore_roundtrip(tmp_path):
    assert matstore.available()
    so = matstore._so_path()
    assert so.parent.name == "_build" and so.exists()
    a = np.random.default_rng(3).normal(size=(64, 48))
    p = str(tmp_path / "a.bin")
    matstore.write_matrix(p, a)
    assert np.array_equal(matstore.read_matrix(p), a)
    assert np.array_equal(np.asarray(matstore.mmap_matrix(p)), a)
    # the same bytes as the JAX package's store
    pj = str(tmp_path / "j.bin")
    jmatstore.write_matrix(pj, a)
    assert open(p, "rb").read() == open(pj, "rb").read()
    # a flipped byte is caught by the checksum
    raw = bytearray(open(p, "rb").read())
    raw[100] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        matstore.read_matrix(p)


def test_native_read_csv(tmp_path):
    a = np.random.default_rng(4).normal(size=(11, 5))
    with_hdr = str(tmp_path / "h.csv")
    np.savetxt(with_hdr, a, delimiter=",", fmt="%.17g",
               header="a,b,c,d,e", comments="")
    got, had = matstore.read_csv(with_hdr)
    assert had and np.array_equal(got, a)
    bare = str(tmp_path / "b.csv")
    np.savetxt(bare, a, delimiter=",", fmt="%.17g")
    got, had = matstore.read_csv(bare)
    assert not had and np.array_equal(got, a)
    from bigkrls_tpu_torch.utils.io import design_from_csv
    from bigkrls_tpu.utils.io import design_from_csv as jdesign
    yt, Xt = design_from_csv(with_hdr, y_col=2)
    yj, Xj = jdesign(with_hdr, y_col=2)
    assert np.array_equal(yt, yj) and np.array_equal(Xt, Xj)
    assert Xt.shape == (11, 4)


# ---------------------------------------------------------------------------
# plotting and the explorer
# ---------------------------------------------------------------------------

def test_plot_and_export_effects(tmp_path, mtcars_pair):
    mt = mtcars_pair[0]
    out = bt.plot_effects(mt, dydx=4, save_to=str(tmp_path / "fx.png"))
    assert os.path.getsize(out) > 0
    assert os.path.exists(bt.plot_effects(mt, save_to=str(tmp_path /
                                                          "all.png")))
    path = bt.export_effects(mt, str(tmp_path / "bundle.npz"))
    with np.load(path) as data:
        assert np.array_equal(data["derivatives"], mt.derivatives)
        assert list(data["xlabs"]) == list(mt.xlabs)


def _payload(doc):
    m = re.search(r"const DATA = (\{.*?\});\n", doc, re.S)
    return json.loads(m.group(1)), doc[:m.start(1)] + doc[m.end(1):]


@pytest.mark.parametrize("max_points", [8000, 16])
def test_effects_explorer_matches_jax(tmp_path, mtcars_pair, max_points):
    """The same page as the JAX package's for the same model (a JAX fit
    and its port conversion). One normalisation: the embedded payload is
    compared as numbers at 1e-10, since the AME table's p-values come from
    two implementations of the t tail."""
    _, mj, _, _ = mtcars_pair
    mc = convert.model_from_reference(mj, device="cpu", dtype=torch.float64)
    kw = dict(max_points=max_points, title="mtcars & <effects>")
    dt = open(bt.effects_explorer(mc, str(tmp_path / "t.html"), **kw),
              encoding="utf-8").read()
    dj = open(bk.effects_explorer(mj, str(tmp_path / "j.html"), **kw),
              encoding="utf-8").read()
    pt, page_t = _payload(dt)
    pj, page_j = _payload(dj)
    assert page_t == page_j
    assert sorted(pt) == sorted(pj)
    for key in pt:
        if key in ("ame", "pct", "X", "D", "lambda", "R2", "R2AME", "dof"):
            assert _close(pt[key], pj[key], 1e-10), key
        else:
            assert pt[key] == pj[key], key
    assert pt["subsampled"] == (max_points < 32)
    # without a title, only the tab title names the package
    d0 = open(bt.effects_explorer(mc, str(tmp_path / "d.html")),
              encoding="utf-8").read()
    assert "<title>bigkrls_tpu_torch — marginal effects explorer</title>" \
        in d0
