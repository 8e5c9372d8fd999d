"""The closed loop that drives a cell's traffic, and what its kinds share.

A traffic mix (``traffic/<mix>.json``) is data: its ``kind`` names the
module ``kinds/<kind>.py`` that makes each job of that kind from the seed
and checks what the jobs produced (``Loop`` and ``check``); the rest of the
mix is that module's parameters. One caller sends a job, waits for its
answer and sends the next (a closed loop of one client). Every job's
latency runs from the call to the moment its answer is on the host and
every card of the cell has finished its work.

A kind's ``Loop`` takes ``(program, config, traffic, seed, device,
precision=None, chips=1)``: ``chips`` is the cell's card count, and
``cards(device, chips)`` the cards it holds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Hashable, List, Optional

import torch

from . import spec


@dataclasses.dataclass
class Job:
    """One completed job or request, and what the check needs of it."""
    index: int
    latency: float
    start: float                  # perf_counter at the call
    spans: Dict[str, float]       # seconds in each public call
    timings: Optional[list] = None    # the fit's model.timings
    out: Optional[dict] = None
    key: Hashable = None          # jobs with one key do the same work


def span(name: str):
    """A profiler range around one public call (free when no profiler
    runs)."""
    return torch.profiler.record_function(f"krlsbench.{name}")


def cards(device, chips: int = 1) -> list:
    """The cards of a cell of ``chips``: ``device`` itself for one, else
    index 0 to ``chips`` - 1 of its type."""
    if chips == 1:
        return [device]
    return [torch.device(torch.device(device).type, i) for i in range(chips)]


def sync(device, chips: int = 1) -> None:
    """Wait until every card of the cell has finished its work."""
    for d in cards(device, chips):
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def fit_options(config: dict, precision: Optional[str] = None) -> dict:
    """The keyword arguments of the configuration's ``fit``."""
    opts = dict(config.get("fit", {}))
    dtype = opts.pop("dtype", "float32")
    opts["dtype"] = getattr(torch, dtype)
    if precision is not None:
        opts["precision"] = precision
    return opts


def fit_outputs(m, s) -> dict:
    """What the check reads of a fitted model and its summary."""
    return {"lambda": m.lambda_, "looe": m.looe, "neffective": m.neffective,
            "coeffs": m.coeffs, "yfitted": m.yfitted, "R2": m.R2,
            "lastkeeper": m.lastkeeper, "eig_path": m.eig_path,
            "eigenvalues": m.K_eigenvalues,
            "derivatives": m.derivatives,
            "which": m.which_derivatives,
            "ame": None if s is None else s.ttests[:, 0],
            "se": None if s is None else s.ttests[:, 1],
            "pvalues": None if s is None else s.ttests[:, 3]}


def kind(traffic: dict):
    """The module of the mix's kind (``kinds/<kind>.py``)."""
    return spec.load_module("kinds", traffic["kind"], "traffic kind")


def make(program, config: dict, traffic: dict, seed: int, device,
         precision: Optional[str] = None, chips: int = 1):
    """The mix's loop over ``program`` (the package under test, or what
    stands in its place) on the cell's ``chips`` cards."""
    return kind(traffic).Loop(program, config, traffic, seed, device,
                              precision, chips)


@dataclasses.dataclass
class Window:
    jobs: List[Job]
    seconds: float                # first call to the last answer
    failed: int
    errors: List[str]
    traced: List[Job]             # the jobs under the profiler


def drive(loop, seconds: float, on_trace: Optional[Callable] = None,
          trace_seconds: float = 0.0) -> Window:
    """Run jobs back to back until ``seconds`` have passed since the
    first call. With ``on_trace`` (a context manager factory), the jobs
    that start in the last ``trace_seconds`` of the window run inside it,
    and the window does not end before the trace has held one whole job
    attempt, completed or failed. So a job that outlasts the trace part,
    or the whole window, runs untraced, the trace opens at its end, and
    the next job runs inside it. Where the jobs are short beside
    ``trace_seconds``, the trace holds many of them and this rule never
    acts."""
    jobs: List[Job] = []
    traced: List[Job] = []
    errors: List[str] = []
    failed = 0
    attempts_traced = 0
    start = time.perf_counter()
    end = start
    index = 0
    tracing = contextlib.ExitStack()
    in_trace = False
    with tracing:
        while True:
            now = time.perf_counter()
            if now - start >= seconds and (on_trace is None
                                            or attempts_traced):
                break
            if on_trace is not None and not in_trace and \
                    now - start >= seconds - trace_seconds:
                tracing.enter_context(on_trace())
                in_trace = True
            try:
                job = loop.job(index)
            except Exception as e:     # a failed job is counted, not fatal
                failed += 1
                errors.append(f"job {index}: {type(e).__name__}: {e}")
                end = time.perf_counter()
            else:
                jobs.append(job)
                if in_trace:
                    traced.append(job)
                end = job.start + job.latency
            attempts_traced += in_trace
            index += 1
    return Window(jobs, end - start, failed, errors, traced)
