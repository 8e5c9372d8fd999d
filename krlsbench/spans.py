"""The program's own spans and counters, matched to the window's jobs.

The program keeps a log of the spans of its public calls
(``bigkrls_tpu_torch.utils.progress.spans()``: each span's path such as
``fit/eigendecomposition/krylov``, its call's id, its host start on
``time.perf_counter``, its device interval, its counters). For each job
outside the profiled part of the window (``readings.untraced``), the
spans of the calls whose root span started inside the job, in
``[job.start, job.start + job.latency]`` on the same clock; a reader is
the mean over those jobs of a span's summed device interval, or of a
counter summed over the job's calls. A program without the log (a parent
commit) reads None, and the metric is left out of the line.
"""
from __future__ import annotations

import bisect
import collections
from typing import Callable, List, Optional

import numpy as np

from . import readings


def program_log() -> Optional[list]:
    """Every finished span the program's log holds, or None without one."""
    try:
        from bigkrls_tpu_torch.utils import progress
        return progress.spans()
    except (ImportError, AttributeError):
        return None


def by_job(run) -> Optional[List[list]]:
    """The spans of each untraced job's calls (an empty list for a job
    that made none), or None without a log."""
    log = program_log()
    if not log:
        return None
    calls = collections.defaultdict(list)
    for s in log:
        calls[s.call].append(s)
    roots = sorted((s.t0, s.call) for s in log if s.parent is None)
    starts = [t for t, _ in roots]
    out = []
    for j in readings.untraced(run):
        lo = bisect.bisect_left(starts, j.start)
        hi = bisect.bisect_right(starts, j.start + j.latency)
        out.append([s for _, c in roots[lo:hi] for s in calls[c]])
    return out


def mean(run, value: Callable[[list], Optional[float]]) -> Optional[float]:
    """The mean over jobs with calls of ``value(spans)``, where not None."""
    jobs = by_job(run)
    if jobs is None:
        return None
    vals = [v for v in (value(sp) for sp in jobs if sp) if v is not None]
    return float(np.mean(vals)) if vals else None


def span_ms(run, *paths: str) -> Optional[float]:
    """Mean ms per job of the summed intervals (device, or host where
    there is none) of its spans at ``paths``; jobs without one are left
    out."""
    def value(spans):
        hit = [s.seconds for s in spans if s.path in paths]
        return 1e3 * sum(hit) if hit else None
    return mean(run, value)


def counter(run, key: str, scale: float = 1.0) -> Optional[float]:
    """Mean per job of counter ``key`` summed over its calls' spans."""
    return mean(run, lambda spans: scale * sum(s.counters.get(key, 0)
                                               for s in spans))
