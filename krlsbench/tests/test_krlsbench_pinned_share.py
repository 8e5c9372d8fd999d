"""``metrics/predict_pinned_share.py`` over a fabricated log: the mean
over requests of the share of their bytes to the host that landed in
pinned memory; nothing where the program has no such counter."""
from __future__ import annotations

import types

import pytest

from krlsbench import loop, spans, spec
from krlsbench.run import Run


def _span(path, call, t0, parent=0, **counters):
    return types.SimpleNamespace(path=path, name=path.split("/")[-1],
                                 call=call, parent=parent, t0=t0,
                                 seconds=0.001, counters=counters)


def _run(*starts):
    jobs = [loop.Job(i, 0.1, t, {}) for i, t in enumerate(starts)]
    return Run("cell", "predict", 1.0,
               loop.Window(jobs=jobs, seconds=10.0, failed=0, errors=[],
                           traced=[]), 0, None)


def test_share_is_the_mean_over_requests(monkeypatch):
    log = [_span("predict/to_host", 1, 0.11, bytes_to_host=800,
                 bytes_to_host_pinned=800),
           _span("predict", 1, 0.1, parent=None),
           # a blocked request: one block pinned, one not
           _span("predict/to_host", 2, 0.31, bytes_to_host=300,
                 bytes_to_host_pinned=300),
           _span("predict/to_host", 2, 0.32, bytes_to_host=100,
                 bytes_to_host_pinned=0),
           _span("predict", 2, 0.3, parent=None)]
    monkeypatch.setattr(spans, "program_log", lambda: log)
    read = spec.load_reader("predict_pinned_share")
    assert read(_run(0.09, 0.29)) == pytest.approx((100 + 75) / 2)
    assert read(_run(0.09)) == pytest.approx(100)


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    log = [_span("predict/to_host", 1, 0.11, bytes_to_host=800,
                 host_reads=3),
           _span("predict", 1, 0.1, parent=None)]
    monkeypatch.setattr(spans, "program_log", lambda: log)
    assert spec.load_reader("predict_pinned_share")(_run(0.09)) is None
