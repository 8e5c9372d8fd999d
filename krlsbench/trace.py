"""The traced part of a ``--trace 1`` window: device time, launch shapes,
busy share and idle gaps, on each card of the cell.

``Tracer.window()`` runs its block under ``torch.profiler`` (host and
device activity) and, for that block only, wraps the program's kernel
entries at the names their callers look up to record each CUDA launch's
shapes, which the roofline needs and the program's launch counters do not
keep: ``ops.kernels._gauss_tile_cuda``, which every K1 launch passes (also
one from a mesh's cached kernel function, which holds ``gauss_tile`` from
before the window), and ``ops.matvec.kernel_matmul`` and
``kernel_matmul_cross``. After the run, :meth:`Tracer.summary` reduces the
profiler's raw events (the event tree that ``prof.events()`` builds in
Python takes minutes on the trace of a long fit over several cards): for
each card, the union of its device intervals (kernels, copies, sets;
annotations are no work) inside the traced window and the idle gaps
between them, labelled by the benchmark's host span open at the time
(``fit``, ``summary``, ``predict``) and, inside a fit, the phase of its
``model.timings``; and each kernel's device time by name, summed over the
cards. ``busy_s`` and the gaps are means over the cell's cards.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from . import roofline

# device kernels that belong to each of the program's kernel entries
KERNEL_NAMES = {"k1": ("gauss_tile_kernel", "pad_rows_kernel"),
                "k2": ("kernel_matmul_kernel", "row_sqnorm_kernel")}
SPAN_PREFIX = "krlsbench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]             # "k1"/"k2" -> device seconds
    works: Dict[str, List[Tuple[float, float]]]   # (operations, bytes)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    card_busy_s: List[float]               # cuda:0 first; busy_s their mean

    def roofline_pct(self, kernel: str) -> Optional[float]:
        return roofline.share_pct(self.works.get(kernel, []),
                                  self.kernel_s.get(kernel, 0.0))


def _cuda_f32(t) -> bool:
    return t.device.type == "cuda" and t.dtype == torch.float32


class Tracer:
    def __init__(self, chips: int = 1):
        self.chips = chips
        self.prof = None
        self.works: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)

    @contextlib.contextmanager
    def _wrapped(self):
        from bigkrls_tpu_torch.ops import kernels, matvec
        tile, km, kmc = (kernels._gauss_tile_cuda, matvec.kernel_matmul,
                         matvec.kernel_matmul_cross)
        works = self.works

        def gauss_tile_cuda(A, B, sigma, symmetric_diag, **kw):
            out = tile(A, B, sigma, symmetric_diag, **kw)
            works["k1"].append(roofline.k1_work(
                A.shape[0], B.shape[0], A.shape[1]))
            return out

        def kernel_matmul(X, V, sigma, **kw):
            if _cuda_f32(X) and kw.get("impl", "auto") != "plain":
                works["k2"].append(roofline.k2_work(
                    X.shape[0], X.shape[0], X.shape[1], V.shape[1],
                    kw.get("init") is not None))
            return km(X, V, sigma, **kw)

        def kernel_matmul_cross(Xa, Xb, V, sigma, **kw):
            if _cuda_f32(Xa) and kw.get("impl", "auto") != "plain":
                works["k2"].append(roofline.k2_work(
                    Xa.shape[0], Xb.shape[0], Xa.shape[1], V.shape[1],
                    kw.get("init") is not None))
            return kmc(Xa, Xb, V, sigma, **kw)

        kernels._gauss_tile_cuda = gauss_tile_cuda
        matvec.kernel_matmul = kernel_matmul
        matvec.kernel_matmul_cross = kernel_matmul_cross
        try:
            yield
        finally:
            kernels._gauss_tile_cuda = tile
            matvec.kernel_matmul = km
            matvec.kernel_matmul_cross = kmc

    @staticmethod
    def _activities():
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm_up(self) -> None:
        """Start and stop the profiler once, so that the tracing library
        initializes in set-up and not in the window."""
        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if torch.cuda.is_available()
                        else "cpu").add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        self.prof = torch.profiler.profile(activities=self._activities())
        with self._wrapped(), self.prof:
            yield

    def summary(self, jobs) -> Optional[TraceSummary]:
        """Reduce the trace of the traced ``jobs`` (None without one)."""
        if self.prof is None or not jobs:
            return None
        device, spans = [], []
        for a, b, card, name, on_device in _events(self.prof):
            if on_device:
                device.append((a, b, card, name))
            else:
                spans.append((a, b, name[len(SPAN_PREFIX):]))
        if not spans:
            return None
        spans.sort()
        return _reduce(device, spans, jobs, dict(self.works), self.chips)


def _events(prof):
    """(start, end, card, name, on the device) of the device's work and
    of the benchmark's host spans among the profiler's raw events: times
    in microseconds from the trace's start, device names demangled as
    ``prof.events()`` has them. An annotation, a host range shown on the
    device, is no work, whatever its name."""
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    names: Dict[str, str] = {}
    for e in result.events():
        name = e.name()
        on_device = e.device_type() == cuda
        if not on_device and not name.startswith(SPAN_PREFIX):
            continue
        if getattr(e, "is_hidden_event", bool)():
            continue
        if on_device:
            if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
                continue
            if name not in names:
                names[name] = torch._C._demangle(name) \
                    if len(name) > 1 else name
            name = names[name]
        yield ((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
               e.device_index(), name, on_device)


def _union(intervals, w0, w1):
    """Busy microseconds of ``intervals`` inside [w0, w1], and the gaps."""
    intervals.sort()
    busy = 0.0
    gaps = []
    cursor = w0
    for a, b in intervals:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    return busy, gaps


def _reduce(device, spans, jobs, works, chips: int) -> TraceSummary:
    """The summary of ``device`` intervals (start, end, card, name) and
    sorted host ``spans`` (start, end, name) on a cell of ``chips``."""
    w0 = min(s[0] for s in spans)
    w1 = max(s[1] for s in spans)
    cards = sorted(set(range(chips)) | {d[2] for d in device})
    by_name: Dict[str, float] = collections.Counter()
    on_card: Dict[int, list] = {c: [] for c in cards}
    for a, b, card, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            by_name[name] += (b - a) * 1e-6
            on_card[card].append((a, b))
    phases = _phase_spans(spans, jobs)
    idle: Dict[str, float] = collections.Counter()
    card_busy = []
    for c in cards:
        busy, gaps = _union(on_card[c], w0, w1)
        card_busy.append(busy * 1e-6)
        for a, b in gaps:
            idle[_label(0.5 * (a + b), spans, phases)] += \
                (b - a) * 1e-6 / len(cards)
    kernel_s = {k: sum(s for n, s in by_name.items()
                       if any(p in n for p in pats))
                for k, pats in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=sum(card_busy) / len(cards),
        kernel_s=kernel_s, works=works,
        device_ops=[[n, s] for n, s in top],
        idle_gaps=[[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]],
        card_busy_s=card_busy)


def _phase_spans(spans, jobs):
    """(start, end, phase) of each fit's phases, laid from its ``fit``
    span's start by the durations in its ``model.timings``."""
    fits = [s for s in spans if s[2] == "fit"]
    timed = [j for j in jobs if j.timings]
    out = []
    for (start, _end, _), job in zip(fits, timed):
        t = start
        for ph in job.timings:
            d = ph["seconds"] * 1e6
            out.append((t, t + d, ph["phase"]))
            t += d
    return out


def _at(t, ranges):
    """The name of the range of sorted, disjoint ``ranges`` that holds t."""
    i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return ranges[i][2]
    return None


def _label(t, spans, phases) -> str:
    inner = _at(t, spans)
    if inner is None:
        return "between calls"
    if inner == "fit":
        return f"fit/{_at(t, phases) or 'after phases'}"
    return inner
