"""The port's span recorder (``utils/progress``) on the CPU: the span tree
of a fit on the adaptive and the streaming route and of ``predict`` on
its dense and blocked paths, the ``host_reads`` and byte counters, where
``predict``'s results land (pageable on the CPU; the pinned path's
bookkeeping and its fallback), the log's bound, and the profiler ranges only inside the program's own
``trace``. Imports no JAX."""
import contextlib
import importlib

import numpy as np
import pytest
import torch

import bigkrls_tpu_torch as bt
from bigkrls_tpu_torch import bench
from bigkrls_tpu_torch.utils.progress import PHASES
from bigkrls_tpu_torch.ops import solve
from bigkrls_tpu_torch.parallel.sharded import host_gather, make_mesh, place
from bigkrls_tpu_torch.utils import progress

tpredict = importlib.import_module("bigkrls_tpu_torch.predict")

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64, noisy=False)


def _call(name):
    """The spans of the newest call ``name``, and its root."""
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == name][-1]
    return [s for s in log if s.call == root.call], root


def _assert_tree(spans, root):
    """Each span lies inside its parent, under the root's call id."""
    by_id = {s.id: s for s in spans}
    assert root.id == root.call and spans[-1] is root
    for s in spans:
        assert s.call == root.call and s.t0 <= s.t1
        if s is not root:
            up = by_id[s.parent]
            assert up.t0 <= s.t0 and s.t1 <= up.t1
            assert s.path == f"{up.path}/{s.name}"


@pytest.fixture(scope="module")
def adaptive_fit():
    y, X = bench.smoke_data(512, 6, seed=3)
    m = bt.fit(y, X, eigtrunc=0.01, eig_method="adaptive", **CPU64)
    return m, X, _call("fit")


@pytest.fixture(scope="module")
def streaming_fit():
    y, X = bench.streaming_data(512, 4, seed=5)
    m = bt.fit(y, X, streaming=True, neig=40, **CPU64)
    return m, X, _call("fit")


def test_adaptive_fit_records_its_span_tree(adaptive_fit):
    m, _, (spans, root) = adaptive_fit
    assert m.eig_path.startswith("adaptive-krylov")
    _assert_tree(spans, root)
    assert [t["phase"] for t in m.timings] == list(PHASES)
    phases = [s for s in spans if s.parent == root.id]
    assert [s.name for s in phases] == list(PHASES)
    assert [round(s.seconds, 4) for s in phases] == \
        [t["seconds"] for t in m.timings]
    paths = [s.path for s in spans]
    assert paths[:2] == ["fit/kernel/prepare", "fit/kernel/k1"]
    eig = [p.rsplit("/", 1)[1] for p in paths
           if p.startswith("fit/eigendecomposition/")]
    # one krylov, bounds, lambda_search and check an attempt
    attempts = eig.count("krylov")
    assert attempts >= 1
    assert eig == ["krylov", "bounds", "lambda_search", "check"] * attempts
    assert all(s.device_s is None for s in spans)    # the CPU: host time
    reads = {s.path: s.counters.get("host_reads", 0) for s in spans}
    assert reads["fit/kernel/prepare"] == 5
    assert sum(s.counters.get("host_reads", 0) for s in spans
               if s.name == "check") == attempts


def test_streaming_fit_records_krylov_and_ritz(streaming_fit):
    m, _, (spans, root) = streaming_fit
    assert m.eig_path == "streaming-krylov" and m.K is None
    _assert_tree(spans, root)
    assert [t["phase"] for t in m.timings] == list(PHASES)
    eig = [s.name for s in spans if s.path.startswith(
        "fit/eigendecomposition/")]
    assert eig == ["krylov", "ritz"]
    assert "fit/kernel/k1" not in [s.path for s in spans]
    ritz = [s for s in spans if s.name == "ritz"][0]
    assert ritz.counters["host_reads"] >= 1


@pytest.mark.parametrize("block_size", [None, 7])
def test_predict_records_its_spans_and_bytes(adaptive_fit, block_size,
                                             monkeypatch, caplog):
    m, X, _ = adaptive_fit
    monkeypatch.setattr(tpredict, "_warned_blocked", False)
    monkeypatch.setattr(tpredict, "AUTO_BLOCK_ELEMS", 512 * 18)
    new = X[:20] + 0.1
    for _ in range(2):
        p = bt.predict(m, new, se_pred=True, block_size=block_size)
    spans, root = _call("predict")
    _assert_tree(spans, root)
    blocks = 3 if block_size else 2       # 20 rows: 7 a block, or 18 auto
    assert root.counters["blocked"] == 1
    names = [s.name for s in spans[:-1]]
    assert names == ["prepare"] + ["kernel", "products", "to_host"] * blocks
    returned = [a for a in (p.predicted, p.se_pred, p.newdataK)
                if a is not None]
    assert p.newdataK is None
    total = {k: sum(s.counters.get(k, 0) for s in spans)
             for k in ("bytes_to_host", "bytes_to_device", "host_reads")}
    assert total["bytes_to_host"] == sum(a.nbytes for a in returned)
    assert total["bytes_to_device"] == (X.size + new.size + X.shape[0]) * 8
    assert total["host_reads"] == 3 + 2 * blocks
    warned = [r for r in caplog.records if "blocked path" in r.message]
    assert len(warned) == (0 if block_size else 1)


def test_dense_predict_returns_the_bytes_it_copied(adaptive_fit):
    m, X, _ = adaptive_fit
    p = bt.predict(m, X[:30], se_pred=True)
    spans, root = _call("predict")
    assert root.counters["blocked"] == 0
    assert [s.name for s in spans] == ["prepare", "kernel", "products",
                                       "to_host", "predict"]
    assert p.newdataK.shape == (30, X.shape[0])
    assert sum(s.counters.get("bytes_to_host", 0) for s in spans) == \
        p.predicted.nbytes + p.se_pred.nbytes + p.newdataK.nbytes


@pytest.mark.parametrize("block_size", [None, 7])
def test_predict_returns_float64_c_contiguous_writable_arrays(adaptive_fit,
                                                              block_size):
    """On the CPU the results are read into pageable memory as before:
    float64, C-contiguous, writable, and none of their bytes pinned."""
    m, X, _ = adaptive_fit
    new = X[:20] - 0.2
    p = bt.predict(m, new, se_pred=True, block_size=block_size)
    spans, root = _call("predict")
    shapes = {"predicted": (20,), "se_pred": (20,),
              "newdataK": None if block_size else (20, X.shape[0])}
    for name, shape in shapes.items():
        a = getattr(p, name)
        if shape is None:
            assert a is None
            continue
        assert a.shape == shape and a.dtype == np.float64, name
        assert a.flags.c_contiguous and a.flags.writeable, name
    assert root.counters["blocked"] == int(block_size is not None)
    assert sum(s.counters.get("bytes_to_host_pinned", 0)
               for s in spans) == 0
    assert sum(s.counters.get("bytes_to_host", 0) for s in spans) > 0


def test_predict_falls_back_to_pageable_memory_where_pinning_fails(
        adaptive_fit, monkeypatch):
    """A call that asks for pinned memory where the allocator has none (a
    CPU-only build raises) reads every result as the CPU path does, bit
    for bit, and asks no more in that call."""
    m, X, _ = adaptive_fit
    new = X[5:28] * 1.1
    want = bt.predict(m, new, se_pred=True, block_size=10)
    tries = []
    real = tpredict._ToHost

    def pinned(_):
        tries.append(real(True))
        return tries[-1]
    monkeypatch.setattr(tpredict, "_ToHost", pinned)
    got = bt.predict(m, new, se_pred=True, block_size=10)
    assert len(tries) == 1 and tries[0].pinned is False
    assert np.array_equal(got.predicted, want.predicted)
    assert np.array_equal(got.se_pred, want.se_pred)
    spans, _ = _call("predict")
    assert sum(s.counters.get("host_reads", 0) for s in spans) == 3 + 2 * 3


@pytest.mark.parametrize("vcov", [False, True])
def test_pinned_path_bookkeeping_on_the_cpu(adaptive_fit, monkeypatch, vcov):
    """The pinned path with its pinned allocation stood in for on the
    CPU: the same arrays as the pageable path, bit for bit, C-contiguous
    and writable; one host read a ``to_host`` span; every byte to the host
    counted as pinned."""
    m, X, _ = adaptive_fit
    new = X[40:57] + 0.05
    want = bt.predict(m, new, se_pred=True, materialize_vcov=vcov)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    real = tpredict._ToHost
    monkeypatch.setattr(tpredict, "_ToHost", lambda _: real(True))
    got = bt.predict(m, new, se_pred=True, materialize_vcov=vcov)
    for name in ("predicted", "se_pred", "newdataK", "vcov_est_pred"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None and not vcov
            continue
        assert np.array_equal(a, b), name
        assert a.dtype == np.float64 and a.flags.c_contiguous
        assert a.flags.writeable
    spans, _ = _call("predict")
    to_host = [s for s in spans if s.name == "to_host"]
    assert [s.counters["host_reads"] for s in to_host] == [1]
    copied = (got.predicted, got.vcov_est_pred if vcov else got.se_pred,
              got.newdataK)
    assert to_host[0].counters["bytes_to_host_pinned"] == \
        to_host[0].counters["bytes_to_host"] == sum(a.nbytes for a in copied)


def test_host_reads_counts_each_read():
    rng = np.random.default_rng(8)
    t = torch.as_tensor(rng.normal(size=(16, 3)))
    sharded = place(t, make_mesh(devices=["cpu"] * 4), "row")
    Q = torch.linalg.qr(torch.as_tensor(rng.normal(size=(40, 6))))[0]
    values = torch.linspace(3.0, 0.5, 6, dtype=torch.float64)
    Qty, Q2 = solve.solve_precompute(Q, torch.as_tensor(rng.normal(size=40)))
    with progress.span("probe", device=None) as s:
        host_gather(t)
        host_gather(sharded)
        _, iters, chunks = solve.golden_search_device(
            Q, values, Qty, Q2, 1e-3, 40.0, 1e-9)
    assert iters > solve.GOLDEN_CHUNK and chunks >= 2
    shards = len(list(sharded.keys()))
    assert shards == 2
    assert s.counters["host_reads"] == 1 + shards + chunks
    progress.count("host_reads")     # no span open: counted nowhere
    with progress.span("step") as inert:     # outside a call: inert
        host_gather(t)
    assert inert.call is None and inert.counters == {}
    assert progress.RECORDER._stack() == []


def test_log_holds_its_bound():
    rec = progress.Recorder(size=5)
    for _ in range(3):
        root = rec.open("call", None)
        for name in ("a", "b"):
            rec.close(rec.open(name))
        rec.close(root)
    log = rec.spans()
    assert len(log) == 5
    assert [s.path for s in log] == ["call/b", "call", "call/a", "call/b",
                                     "call"]
    assert log[-1].call == log[-2].call != log[0].call


def test_spans_left_open_by_an_exception_are_dropped():
    rec = progress.Recorder()
    root = rec.open("call", None)
    rec.open("leaked")
    rec.close(rec.open("inner"))
    rec.close(root)
    assert [s.path for s in rec.spans()] == ["call/leaked/inner", "call"]
    assert rec._stack() == []


def test_profiler_ranges_only_inside_the_programs_trace(monkeypatch):
    """Outside the program's ``trace`` a fit opens no profiler range (so
    a benchmark's own profiler sees none); inside it, one a span, named
    by path (``test_fit_trace_dir_writes_trace`` reads them in the written
    trace)."""
    y, X = bench.smoke_data(40, 2, seed=2)
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or
                        contextlib.nullcontext())
    bt.fit(y, X, **CPU64)
    assert opened == []
    monkeypatch.setattr(progress.RECORDER, "profiling", 1)
    bt.fit(y, X, **CPU64)
    spans, _ = _call("fit")
    assert opened[0] == "bigkrls.fit"
    assert sorted(opened) == sorted(f"bigkrls.{s.path}" for s in spans)
