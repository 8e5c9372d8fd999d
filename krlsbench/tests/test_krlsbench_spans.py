"""The readers of the program's own spans and counters (``spans.py`` and
the ``metrics/`` files that use it), over a fabricated run and log; a
program without the log reads nothing; a tiny traced run on the CPU
prints the metrics of the spans it makes."""
from __future__ import annotations

import time
import types

import pytest

from krlsbench import loop, spans, spec
from krlsbench.run import Run
from krlsbench.tests.conftest import tiny_cell


def _span(path, call, t0, seconds, parent=0, **counters):
    return types.SimpleNamespace(path=path, name=path.split("/")[-1],
                                 call=call, parent=parent, t0=t0,
                                 seconds=seconds, counters=counters)


def _run(jobs, traced=()):
    window = loop.Window(jobs=list(jobs), seconds=10.0, failed=0, errors=[],
                         traced=list(traced))
    return Run("cell", "fit", 1.0, window, 0, None)


def _job(i, start, latency):
    return loop.Job(i, latency, start, {})


def _log():
    """Two fits in two jobs (the second adaptive fit took two attempts),
    one fit inside the traced job, and a library span in set-up."""
    return [
        _span("library", 1, 0.5, 0.25, built=1),
        _span("fit/kernel/prepare", 1, 0.51, 0.004, host_reads=3),
        _span("fit/eigendecomposition/krylov", 1, 0.52, 0.020, host_reads=1),
        _span("fit/eigendecomposition/check", 1, 0.54, 0.001, host_reads=1),
        _span("fit", 1, 0.5, 0.06, parent=None, host_reads=4),
        _span("fit/kernel/prepare", 2, 1.01, 0.006, host_reads=3),
        _span("fit/eigendecomposition/krylov", 2, 1.02, 0.020, host_reads=1),
        _span("fit/eigendecomposition/krylov", 2, 1.05, 0.030, host_reads=1),
        _span("fit", 2, 1.0, 0.09, parent=None, host_reads=4),
        _span("fit/kernel/prepare", 3, 2.01, 1.0, host_reads=100),
        _span("fit", 3, 2.0, 1.5, parent=None),
    ]


@pytest.fixture
def fabricated(monkeypatch):
    monkeypatch.setattr(spans, "program_log", _log)
    return _run([_job(0, 0.49, 0.2), _job(1, 0.99, 0.2), _job(2, 1.99, 2.0),
                 _job(3, 5.0, 0.1)], traced=[])


def test_readers_take_the_mean_over_the_jobs_that_made_calls(fabricated):
    run = fabricated
    run.window.traced = [run.window.jobs[2]]
    read = spec.load_reader
    assert read("fit_prepare_ms")(run) == pytest.approx(5.0)
    assert read("fit_prepare_ms.streaming")(run) == pytest.approx(5.0)
    # the second fit's two attempts are summed
    assert read("adaptive_krylov_ms")(run) == pytest.approx(35.0)
    assert read("streaming_krylov_ms")(run) == pytest.approx(35.0)
    # a span only one job has is the mean over the jobs that have it
    assert read("adaptive_check_ms")(run) == pytest.approx(1.0)
    assert read("adaptive_bounds_ms")(run) is None
    # counters are summed over each call, jobs without one counting 0
    assert read("host_reads.fit")(run) == pytest.approx((9 + 9) / 2)
    assert read("setup_library_ms")(run) == pytest.approx(250.0)


def test_predict_readers_sum_the_blocks(monkeypatch):
    log = [_span("predict/prepare", 1, 0.1, 0.001, bytes_to_device=800),
           _span("predict/kernel", 1, 0.11, 0.002),
           _span("predict/products", 1, 0.12, 0.003),
           _span("predict/to_host", 1, 0.13, 0.004, host_reads=2,
                 bytes_to_host=1_000_000),
           _span("predict/kernel", 1, 0.14, 0.002),
           _span("predict/products", 1, 0.15, 0.003),
           _span("predict/to_host", 1, 0.16, 0.004, host_reads=2,
                 bytes_to_host=500_000),
           _span("predict", 1, 0.1, 0.03, parent=None, blocked=1),
           _span("predict/prepare", 2, 0.3, 0.003),
           _span("predict/kernel", 2, 0.31, 0.001),
           _span("predict/products", 2, 0.32, 0.001),
           _span("predict/to_host", 2, 0.33, 0.002, host_reads=3,
                 bytes_to_host=2_000_000),
           _span("predict", 2, 0.3, 0.01, parent=None, blocked=0)]
    monkeypatch.setattr(spans, "program_log", lambda: log)
    run = _run([_job(0, 0.09, 0.1), _job(1, 0.29, 0.1)])
    read = spec.load_reader
    assert read("predict_prepare_ms")(run) == pytest.approx(2.0)
    assert read("predict_device_ms")(run) == pytest.approx((10 + 2) / 2)
    assert read("predict_to_host_ms")(run) == pytest.approx((8 + 2) / 2)
    assert read("predict_to_host_mb")(run) == pytest.approx(1.75)
    assert read("host_reads.predict")(run) == pytest.approx(3.5)


def test_a_program_without_the_log_reads_nothing(monkeypatch):
    import bigkrls_tpu_torch.utils.progress as progress
    monkeypatch.delattr(progress, "spans")
    run = _run([_job(0, time.perf_counter(), 1.0)])
    assert spans.program_log() is None
    for name in ("fit_prepare_ms", "adaptive_lambda_ms", "host_reads.fit",
                 "predict_to_host_mb", "setup_library_ms"):
        assert spec.load_reader(name)(run) is None


def test_a_traced_run_on_the_cpu_prints_the_span_metrics():
    from krlsbench import run
    out = run.execute(tiny_cell("election-dense.predict", n=120, p=4,
                                pool=1), 5, 0.4, True, "cpu",
                      time.time())
    got = out["metrics"]
    for name in ("predict_prepare_ms", "predict_device_ms",
                 "predict_to_host_ms", "predict_to_host_mb",
                 "host_reads.predict"):
        assert got[name]["value"] >= 0, name
    assert got["host_reads.predict"]["value"] >= 2
