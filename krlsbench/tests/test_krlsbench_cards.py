"""The window around a job that outlasts it, and a cell on several cards:
the traced part holds one whole job, and the memory peak, the end-of-job
wait and the busy time read every card of the cell."""
from __future__ import annotations

import contextlib
import time
import types

import pytest
import torch

from krlsbench import loop, roofline, run, spec, trace
from krlsbench.tests.conftest import ROOT
from krlsbench.tests.test_krlsbench_harness import _Ev, _profiled

GIB = 2 ** 30


class _Clock:
    """``time.perf_counter`` for ``loop.drive``, moved only by the jobs."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Jobs:
    """Jobs of ``seconds`` each on the clock; with ``fail``, each raises
    at its end."""

    def __init__(self, clock, seconds, fail=False):
        self.clock, self.seconds, self.fail = clock, seconds, fail
        self.starts = []

    def job(self, index):
        start = self.clock.t
        self.starts.append(start)
        self.clock.t += self.seconds
        if self.fail:
            raise RuntimeError("no answer")
        return loop.Job(index, self.seconds, start, {}, None)


@pytest.mark.parametrize("job_s, fail, traced, attempts", [
    (51.0, False, 1, 2),     # one job outlasts the window and the trace part
    (0.07, False, None, None),   # short jobs: the trace opens as before
    (0.5, True, 0, None),    # every job fails: the loop still ends
    (51.0, True, 0, 2),      # a long job that fails is a whole attempt
])
def test_the_trace_holds_one_whole_job_attempt(monkeypatch, job_s, fail,
                                               traced, attempts):
    seconds, trace_s = 30.0, 4.0
    clock = _Clock()
    monkeypatch.setattr(loop, "time", types.SimpleNamespace(
        perf_counter=clock))
    opened = []

    @contextlib.contextmanager
    def on_trace():
        opened.append(clock.t)
        yield

    jobs = _Jobs(clock, job_s, fail)
    w = loop.drive(jobs, seconds, on_trace, trace_s)
    starts = [s - 1000.0 for s in jobs.starts]
    # the trace opens once, at the first attempt that starts at or after
    # seconds - trace_seconds, and every attempt from there is traced
    assert len(opened) == 1
    first = min(s for s in starts if s >= seconds - trace_s)
    assert opened[0] - 1000.0 == first
    in_trace = [i for i, s in enumerate(starts) if s >= first]
    assert in_trace
    # the loop ends at the first attempt that ends at or after the window
    # with one attempt traced, and not before
    ends = [s + job_s for s in starts]
    assert ends[-1] >= seconds and all(e < seconds for e in ends[:-2])
    assert len(ends) == 1 + max(in_trace[0], next(
        i for i, e in enumerate(ends) if e >= seconds))
    assert w.failed == (len(starts) if fail else 0)
    assert [j.index for j in w.traced] == ([] if fail else in_trace)
    if traced is not None:
        assert len(w.traced) == traced
    if attempts is not None:
        assert len(starts) == attempts
    if not fail:
        # without a trace the same jobs run, except a job that the trace
        # part had to wait for
        plain = _Jobs(clock, job_s)
        loop.drive(plain, seconds)
        assert len(plain.starts) == len(starts) - (job_s > trace_s)


def test_trace_reduction_takes_each_card_and_averages():
    t = trace.Tracer(4)
    t.works["k1"] = [(2.0e6, 4.0e6)]       # operations, bytes
    evs = [_Ev("krlsbench.fit", 0, 100, False, note=True),
           _Ev("krlsbench.summary", 100, 120, False, note=True),
           _Ev("void gauss_tile_kernel<64, 64>(...)", 10, 30, True, card=0),
           _Ev("ampere_sgemm", 20, 40, True, card=0),
           _Ev("void gauss_tile_kernel<64, 64>(...)", 0, 130, True, card=1),
           _Ev("Memcpy HtoD", 50, 60, True, card=2),
           # annotations, host ranges shown on the device, of any name are
           # no work
           _Ev("bigkrls.fit/eigendecomposition", 0, 120, True, card=3,
               note=True),
           _Ev("a range", 0, 120, True, card=3, note=True),
           _Ev("krlsbench.fit", 0, 100, True, card=2, note=True)]
    t.prof = _profiled(evs)
    job = loop.Job(0, 1.2e-4, 0.0, {}, [{"phase": "kernel", "seconds": 4e-5},
                                        {"phase": "eigendecomposition",
                                         "seconds": 6e-5}])
    s = t.summary([job])
    assert s.window_s == pytest.approx(120e-6)
    assert s.card_busy_s == pytest.approx([30e-6, 120e-6, 10e-6, 0.0])
    assert s.busy_s == pytest.approx(40e-6)           # their mean
    gaps = dict(s.idle_gaps)
    # each card's gaps by the phase at their middle, averaged over cards:
    # card 0 0-10, 40-120; card 2 0-50, 60-120; card 3 0-120
    assert gaps == pytest.approx({"fit/kernel": 15e-6,
                                  "fit/eigendecomposition": 65e-6})
    assert s.busy_s + sum(gaps.values()) == pytest.approx(s.window_s)
    # kernel time and the roofline's work are summed over the cards
    assert s.kernel_s["k1"] == pytest.approx(140e-6)
    assert s.roofline_pct("k1") == pytest.approx(
        100 * roofline.bound_s(2.0e6, 4.0e6)[0] / 140e-6)


class _CudaCalls:
    """``torch.cuda``'s waits and peaks, recorded by card: each card's
    peak is ``setup`` until its reset and ``window`` after it."""

    def __init__(self, setup, window):
        self.setup, self.window = setup, window
        self.calls = []
        self.was_reset = set()

    @staticmethod
    def card(d):
        return torch.device(d).index or 0

    def synchronize(self, d=None):
        self.calls.append(("synchronize", str(d)))

    def max_memory_allocated(self, d=None):
        self.calls.append(("max_memory_allocated", str(d)))
        c = self.card(d)
        return (self.window if c in self.was_reset else self.setup)[c]

    def reset_peak_memory_stats(self, d=None):
        self.calls.append(("reset_peak_memory_stats", str(d)))
        self.was_reset.add(self.card(d))


class _SlowFits:
    """A kind of traffic whose every job outlasts the window."""
    kind = "fit"

    def __init__(self, program, config, traffic, seed, device, precision,
                 chips):
        self.device, self.chips = device, chips

    def warm_up(self):
        pass

    def job(self, index):
        t0 = time.perf_counter()
        with loop.span("fit"):
            time.sleep(0.25)
        loop.sync(self.device, self.chips)
        t1 = time.perf_counter()
        return loop.Job(index, t1 - t0, t0, {"fit": t1 - t0}, None, {},
                        index)


def _check(runner, jobs, config, traffic, seed, device):
    return {"jobs": float(len(jobs))}


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_of_one_long_job_on_every_card(monkeypatch, chips, traced):
    cards = ["cuda"] if chips == 1 else [f"cuda:{i}" for i in range(chips)]
    cuda = _CudaCalls(setup=[3 * GIB, GIB, GIB, GIB],
                      window=[2 * GIB, 5 * GIB, 4 * GIB, GIB])
    for name in ("synchronize", "max_memory_allocated",
                 "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, getattr(cuda, name))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "a card")
    monkeypatch.setattr(loop, "kind", lambda traffic: types.SimpleNamespace(
        Loop=_SlowFits, check=_check))
    real = trace._events

    def events(prof):
        # each card runs a kernel over the second half of each fit
        out = list(real(prof))
        for a, b, _, name, on_device in list(out):
            if not on_device and name == "krlsbench.fit":
                out += [(0.5 * (a + b), b, c, "kernel", True)
                        for c in range(chips)]
        return out

    monkeypatch.setattr(trace, "_events", events)
    base = spec.cell(spec.load_benchmark(ROOT), "streaming-50k.fit", ROOT)
    cell = spec.Cell("slow.fit", chips, {"limits": {"fit": {"jobs": 2}}},
                     {"kind": "slow", "trace_seconds": 0.05}, base.metrics)
    lines = []
    res = run.execute(cell, 2 ** 31 + 3, 0.1, traced, "cuda", time.time(),
                      log=lines.append)
    # without a trace the window ends with the first job; with one, the
    # second job runs in the trace
    attempts = 1 + traced
    assert res["correct"] and res["attempted"] == attempts
    assert res["device"]["count"] == chips
    # the largest peak of any one card, in set-up or in the window
    assert res["device"]["memory_peak_bytes"] == (3 if chips == 1 else 5) \
        * GIB
    # every card waited for at each job's end and before the window; the
    # peaks read and reset on every card, and with one card on the current
    # card, as calls without an argument do
    for fn in ("synchronize", "max_memory_allocated",
               "reset_peak_memory_stats"):
        assert sorted({d for f, d in cuda.calls if f == fn}) == cards
    waits = [d for f, d in cuda.calls if f == "synchronize"]
    assert all(waits.count(d) == 1 + attempts for d in cards)  # set-up
    if not traced:
        assert res["metrics"]["fit_peak_gib"]["value"] == \
            (2.0 if chips == 1 else 5.0)
        assert "busy_s" not in res["device"]
        return
    assert any(line.endswith("(1 traced)") for line in lines)
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    # each card was busy over half of the traced fit, so half the window
    assert dev["busy_s"] == pytest.approx(0.5 * dev["window_s"], rel=0.1)
    assert "device_idle_pct.streaming" in res["metrics"]


def test_every_k1_launch_is_counted_also_through_an_entry_bound_before(
        monkeypatch):
    """A mesh's cached kernel function holds ``gauss_tile`` from before
    the trace opened; its launches still reach the roofline's work."""
    from bigkrls_tpu_torch.ops import kernels
    launched = []

    def launch(A, B, sigma, symmetric_diag, **kw):
        launched.append((tuple(A.shape), tuple(B.shape)))
        return A.new_empty((A.shape[0], B.shape[0]))

    monkeypatch.setattr(kernels, "_gauss_tile_cuda", launch)
    held = kernels.gauss_tile
    t = trace.Tracer(4)
    # tensors off the host take the kernel's route
    A = torch.empty((300, 20), device="meta")
    B = torch.empty((200, 20), device="meta")
    with t._wrapped():
        held(A, A, 1.0, True)
        held(A, B, 1.0, False)
    held(A, B, 1.0, False)                   # after the window: not counted
    assert launched == [((300, 20), (300, 20)), ((300, 20), (200, 20)),
                        ((300, 20), (200, 20))]
    assert t.works["k1"] == [roofline.k1_work(300, 300, 20),
                             roofline.k1_work(300, 200, 20)]
    assert kernels._gauss_tile_cuda is launch
