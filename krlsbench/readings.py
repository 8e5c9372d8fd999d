"""Arithmetic shared by the metric readers under ``metrics/``.

Each reader is ``read(run) -> float | None`` over a ``run.Run``: the
window's jobs (latency, host spans, the fit's ``model.timings``), its
length, the device memory peak over it, and with ``--trace 1`` the
summary of its profiled part (``trace.TraceSummary``). A reader that finds
nothing to read returns None and its metric is left out of the line.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np


def untraced(run) -> List:
    """The window's jobs outside its profiled part (every job in a run
    without one), so that profiling costs no per-layer time."""
    traced = {id(j) for j in run.window.traced}
    return [j for j in run.window.jobs if id(j) not in traced] or \
        list(run.window.jobs)


def per_job_s(run) -> Optional[float]:
    """The window's seconds over the jobs it completed."""
    jobs = run.window.jobs
    return run.window.seconds / len(jobs) if jobs else None


def p95(values) -> Optional[float]:
    """The 95th percentile of every value (numpy's linear interpolation
    between order statistics)."""
    return float(np.percentile(values, 95)) if len(values) else None


def phase_ms(run, phase: str) -> Optional[float]:
    """Mean milliseconds of one ``model.timings`` phase per fit."""
    vals = [p["seconds"] for j in untraced(run) if j.timings
            for p in j.timings if p["phase"] == phase]
    return 1e3 * float(np.mean(vals)) if vals else None


def span_ms(run, span: str) -> Optional[float]:
    """Mean milliseconds of one public call per job."""
    vals = [j.spans[span] for j in untraced(run) if span in j.spans]
    return 1e3 * float(np.mean(vals)) if vals else None


def roofline_pct(run, kernel: str) -> Optional[float]:
    return None if run.trace is None else run.trace.roofline_pct(kernel)


def untraced_wall_s(run) -> Optional[float]:
    """The wall time the traced jobs take untraced: for each, the mean
    latency of the untraced jobs that do the same work (the same key),
    or of every untraced job where none does."""
    traced = {id(j) for j in run.window.traced}
    free = [j for j in run.window.jobs if id(j) not in traced]
    if not free or not traced:
        return None
    by_key = collections.defaultdict(list)
    for j in free:
        by_key[j.key].append(j.latency)
    everything = float(np.mean([j.latency for j in free]))
    return sum(float(np.mean(by_key[j.key])) if j.key in by_key
               else everything for j in run.window.traced)


def idle_pct(run) -> Optional[float]:
    """100 x (1 - the traced jobs' device busy time, the mean over the
    cell's cards, over the wall time they take untraced): the profiler's
    own host cost, which stretches the traced part of the window, is left
    out."""
    if run.trace is None:
        return None
    wall = untraced_wall_s(run)
    return None if not wall else 100.0 * (1.0 - run.trace.busy_s / wall)
