"""The closed loop that drives a cell's traffic, and what its kinds share.

A traffic mix (``traffic/<mix>.json``) is data: its ``kind`` names the
module ``kinds/<kind>.py`` that makes each job of that kind from the seed
and checks what the jobs produced (``Loop`` and ``check``); the rest of the
mix is that module's parameters. One caller sends a job, waits for its
answer and sends the next (a closed loop of one client). Every job's
latency runs from the call to the moment its answer is on the host and the
card has finished its work.
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


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
         precision: Optional[str] = None):
    """The mix's loop over ``program`` (the package under test, or what
    stands in its place)."""
    return kind(traffic).Loop(program, config, traffic, seed, device,
                              precision)


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
    first call. With ``on_trace`` (a context manager factory), the last
    ``trace_seconds`` of the window run inside it."""
    jobs: List[Job] = []
    traced: List[Job] = []
    errors: List[str] = []
    failed = 0
    start = time.perf_counter()
    end = start
    index = 0
    tracing = contextlib.ExitStack()
    in_trace = False
    with tracing:
        while True:
            now = time.perf_counter()
            if now - start >= seconds:
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
            index += 1
    return Window(jobs, end - start, failed, errors, traced)
