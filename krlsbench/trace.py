"""The traced part of a ``--trace 1`` window: device time, launch shapes,
busy share and idle gaps.

``Tracer.window()`` runs its block under ``torch.profiler`` (host and
device activity) and, for that block only, wraps the program's kernel
entries at the names their callers look up (``ops.kernels.gauss_tile``,
``ops.matvec.kernel_matmul`` and ``kernel_matmul_cross``) to record each
CUDA launch's shapes, which the roofline needs and the program's launch
counters do not keep. After the run, :meth:`Tracer.summary` reduces the
trace: the union of device intervals (kernels, copies, sets) inside the
traced window, each kernel's device time by name, and the idle gaps
labelled by the benchmark's host span open at the time (``fit``,
``summary``, ``predict``) and, inside a fit, the phase of its
``model.timings``.
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

    def roofline_pct(self, kernel: str) -> Optional[float]:
        return roofline.share_pct(self.works.get(kernel, []),
                                  self.kernel_s.get(kernel, 0.0))


def _cuda_f32(t) -> bool:
    return t.device.type == "cuda" and t.dtype == torch.float32


class Tracer:
    def __init__(self):
        self.prof = None
        self.works: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)

    @contextlib.contextmanager
    def _wrapped(self):
        from bigkrls_tpu_torch.ops import kernels, matvec
        tile, km, kmc = (kernels.gauss_tile, matvec.kernel_matmul,
                         matvec.kernel_matmul_cross)
        works = self.works

        def gauss_tile(A, B, sigma, symmetric_diag):
            if _cuda_f32(A):
                works["k1"].append(roofline.k1_work(
                    A.shape[0], B.shape[0], A.shape[1]))
            return tile(A, B, sigma, symmetric_diag)

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

        kernels.gauss_tile = gauss_tile
        matvec.kernel_matmul = kernel_matmul
        matvec.kernel_matmul_cross = kernel_matmul_cross
        try:
            yield
        finally:
            kernels.gauss_tile = tile
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
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        # a host range may show on the device as an annotation: not work
        device = [(e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == cuda
                  and not e.name.startswith(SPAN_PREFIX)]
        spans = sorted((e.time_range.start, e.time_range.end,
                        e.name[len(SPAN_PREFIX):])
                       for e in events if e.device_type != cuda
                       and e.name.startswith(SPAN_PREFIX))
        if not spans:
            return None
        w0 = min(s[0] for s in spans)
        w1 = max(s[1] for s in spans)
        by_name: Dict[str, float] = collections.Counter()
        intervals = []
        for a, b, name in device:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                by_name[name] += (b - a) * 1e-6
                intervals.append((a, b))
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
        phases = _phase_spans(spans, jobs)
        idle: Dict[str, float] = collections.Counter()
        for a, b in gaps:
            idle[_label(0.5 * (a + b), spans, phases)] += (b - a) * 1e-6
        kernel_s = {k: sum(s for n, s in by_name.items()
                           if any(p in n for p in pats))
                    for k, pats in KERNEL_NAMES.items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return TraceSummary(
            window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
            kernel_s=kernel_s, works=dict(self.works),
            device_ops=[[n, s] for n, s in top],
            idle_gaps=[[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]])


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
