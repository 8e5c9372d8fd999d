#!/usr/bin/env python3
"""A benchmark cell's traced run, with each card's device work in the
trace held against the launches that asked for it and against the
program's spans.

    python3 tools/mesh_trace_check.py --out mesh_trace.json -- \\
        --workload dense-90k.mesh4 --seed 1 --seconds 30 --trace 1

Run from a tree's root. The arguments after ``--`` go to
``python3 -m krlsbench.run``, which runs in this process as it would
alone; its result line and log are its own. Before the harness reduces
its trace (``krlsbench.trace.Tracer.summary``), this reads the
profiler's raw events once more:

* for each card, inside the traced window (the benchmark's host spans):
  its device events (kernels, copies, sets), their busy union, K1's
  launches (``gauss_tile_kernel``) and their device time, and the five
  kernels that took the most time;
* the host's launch, copy and set calls (CUDA runtime and driver API) by
  name, and those whose correlation id finds no device event: work the
  trace lost.

After the run it adds each span of the last fit (the traced one) with its
host interval, its device interval on each card and its counters, and
writes the JSON to ``--out``. No JAX is used.
"""
import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

API_WORDS = ("Launch", "Memcpy", "Memset")


def _union(intervals):
    busy, cursor = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    return busy


def launches_against_work(prof) -> dict:
    """Each card's device work in ``prof``'s traced window, and the
    host's launch calls that found no device event."""
    import torch
    result = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    device, api, spans = [], [], []
    for e in result.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("krlsbench."):
                continue
            device.append((e.start_ns(), e.end_ns(), e.device_index(), name,
                           e.correlation_id()))
        elif name.startswith("krlsbench."):
            spans.append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu") and any(w in name for w in API_WORDS):
            api.append((name, e.correlation_id()))
    w0, w1 = min(s[0] for s in spans), max(s[1] for s in spans)
    seen = {d[4] for d in device}
    cards = {}
    for card in sorted({d[2] for d in device}):
        mine = [(max(a, w0), min(b, w1), name) for a, b, c, name, _ in device
                if c == card and min(b, w1) > max(a, w0)]
        by_name = collections.Counter()
        for a, b, name in mine:
            by_name[name] += (b - a) * 1e-9
        k1 = [(b - a) * 1e-6 for a, b, name in mine
              if "gauss_tile_kernel" in name]
        cards[card] = {
            "events": len(mine),
            "busy_s": _union([(a, b) for a, b, _ in mine]) * 1e-9,
            "k1_launches": len(k1), "k1_ms": sum(k1),
            "top": [[torch._C._demangle(n)[:100], s]
                    for n, s in by_name.most_common(5)]}
    calls = collections.Counter(name for name, _ in api)
    lost = collections.Counter(name for name, corr in api
                               if corr not in seen)
    return {"window_s": (w1 - w0) * 1e-9, "cards": cards,
            "api_calls": dict(calls), "api_calls_lost": dict(lost)}


def last_fit_spans() -> list:
    from bigkrls_tpu_torch.utils import progress
    log = progress.spans()
    roots = [s for s in log if s.parent is None and s.name == "fit"]
    if not roots:
        return []
    call = roots[-1].call
    return [{"path": s.path, "host_s": s.host_s, "device_s": s.device_s,
             "device_s_by_card": s.device_s_by_card,
             "counters": s.counters} for s in log if s.call == call]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("run_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    run_args = args.run_args[1:] if args.run_args[:1] == ["--"] \
        else args.run_args
    from krlsbench import run, trace
    found = {}
    reduce = trace.Tracer.summary

    def summary(self, jobs):
        if self.prof is not None and jobs:
            try:
                found.update(launches_against_work(self.prof))
            except Exception as e:      # the run's own result comes first
                found["error"] = repr(e)
        return reduce(self, jobs)

    trace.Tracer.summary = summary
    rc = run.main(run_args)
    found["spans"] = last_fit_spans()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(found, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
