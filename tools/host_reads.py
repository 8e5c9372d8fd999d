#!/usr/bin/env python3
"""The program's span log on one card: host reads against the sync debug
mode, the spans of a fit and of a predict, and what the recorder costs.

    python3 tools/host_reads.py [--device cuda] [--parts ...] [--reps 200]

Run from a tree's root. The shapes are the benchmark's four cells: the
default dense fit (``bench.smoke_data()``, N=3106, P=67, float32, the
adaptive route) and the streaming fit (``bench.streaming_data(50000)``,
P=20, ``neig=500``, derivatives of columns 0-4), each fitted twice to warm
up, and ``predict(se_pred=True)`` against each model at three sizes (the
streaming model's largest takes the blocked path). Parts (``--parts``, all
by default):

* ``reads``: one fit and one predict of each size, each under
  ``torch.cuda.set_sync_debug_mode("warn")`` (``golden_loop.count_syncs``:
  the synchronising calls by file and line; an explicit
  ``torch.cuda.synchronize`` is not reported), beside the call's
  ``host_reads`` by span path and its phases and sub-spans in ms;
* ``cost``: fits and requests, each run twice in a row with the recorder
  on and with it swapped for a no-op (``Recorder.open``/``close``/
  ``count``/``settle`` replaced in this process), the order swapped every
  pair, each timed to a synchronize: ``--reps`` pairs of requests at
  each of three sizes (one row, the geometric middle, the largest),
  ``--reps`` / 2 dense and ``--reps`` / 40 streaming fits; and the host
  time of a call of four spans, and of one event record, query and
  elapsed_time.

Prints the card (``nvidia-smi`` name and power limit), then one JSON line.
No JAX is used.
"""
import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from golden_loop import card_line, count_syncs  # noqa: E402

FIT = {"dense": dict(dtype=torch.float32, precision="highest",
                     noisy=False),
       "streaming": dict(dtype=torch.float32, precision="highest",
                         noisy=False, neig=500,
                         which_derivatives=[0, 1, 2, 3, 4])}
SIZES = {"dense": (1, 517, 3106), "streaming": (1, 1000, 5000)}


def data(route: str, n=None):
    from bigkrls_tpu_torch import bench
    if route == "dense":
        return bench.smoke_data(n)
    return bench.streaming_data(n or 50000)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def last_call(name: str):
    """The spans of the newest call ``name`` in the log."""
    from bigkrls_tpu_torch.utils import progress
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == name][-1]
    return [s for s in log if s.call == root.call]


def describe(spans) -> dict:
    """host_reads by path (summed), the total, each path's ms (summed),
    the call's other counters."""
    reads, ms, other = {}, {}, {}
    for s in spans:
        ms[s.path] = ms.get(s.path, 0.0) + 1e3 * s.seconds
        for k, v in s.counters.items():
            if k == "host_reads":
                reads[s.path] = reads.get(s.path, 0) + v
            else:
                other[k] = other.get(k, 0) + v
    return {"host_reads": sum(reads.values()), "by_path": reads,
            "ms": {k: round(v, 4) for k, v in ms.items()},
            "counters": other}


def reads_part(dev, route: str, n) -> dict:
    import bigkrls_tpu_torch as bt
    y, X = data(route, n)
    opts = dict(FIT[route], device=str(dev))
    for _ in range(2):
        m = bt.fit(y, X, **opts)
    out = {"eig_path": m.eig_path}
    cuda = dev.type == "cuda"
    with (count_syncs() if cuda else contextlib.nullcontext({})) as syncs:
        m = bt.fit(y, X, **opts)
    out["fit"] = {"syncs": syncs, **describe(last_call("fit")),
                  "timings": m.timings}
    rng = np.random.default_rng(7)
    for u in SIZES[route]:
        u = min(u, X.shape[0])
        new = X[rng.integers(0, X.shape[0], size=u)]
        bt.predict(m, new, se_pred=True)
        with (count_syncs() if cuda else contextlib.nullcontext({})) as s2:
            p = bt.predict(m, new, se_pred=True)
        arrays = [a for a in (p.predicted, p.se_pred, p.newdataK)
                  if a is not None]
        out[f"predict_{u}"] = {"syncs": s2, **describe(last_call("predict")),
                               "returned_bytes": sum(a.nbytes
                                                     for a in arrays)}
    return out


@contextlib.contextmanager
def recorder_off():
    """The recorder's methods replaced by ones that record nothing: a span
    keeps only its host interval (for ``PhaseTimer``)."""
    from bigkrls_tpu_torch.utils import progress
    R = progress.Recorder
    saved = {k: R.__dict__[k] for k in ("open", "close", "count", "settle")}

    def open_(self, name, device=None):
        s = progress.Span()
        s.name, s.path, s.device_s, s.counters = name, name, None, {}
        s.t0 = time.perf_counter()
        return s

    def close_(self, s):
        s.t1 = time.perf_counter()

    R.open, R.close = open_, close_
    R.count = lambda self, key, n=1: None
    R.settle = staticmethod(lambda s: None)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(R, k, v)


def timed(dev, fn) -> float:
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def _paired(dev, fn, pairs: int) -> dict:
    """``fn`` run twice in a row, recorder on and off, the order swapped
    every pair; each run timed to a synchronize."""
    res = {"on": [], "off": []}
    for i in range(pairs):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            with (recorder_off() if side == "off"
                  else contextlib.nullcontext()):
                res[side].append(timed(dev, fn))
    diff = [a - b for a, b in zip(res["on"], res["off"])]
    return {"median_on_ms": 1e3 * statistics.median(res["on"]),
            "median_off_ms": 1e3 * statistics.median(res["off"]),
            "added_ms": 1e3 * statistics.mean(diff),
            "added_median_ms": 1e3 * statistics.median(diff),
            "added_sem_ms": 1e3 * statistics.stdev(diff) / len(diff) ** 0.5,
            "pairs": pairs}


def cost_part(dev, route: str, n, reps: int) -> dict:
    """Fits, and requests of three sizes (one row, the median of the
    benchmark's log-uniform grid, the largest), recorder on and off."""
    import bigkrls_tpu_torch as bt
    y, X = data(route, n)
    opts = dict(FIT[route], device=str(dev))
    m = bt.fit(y, X, **opts)
    bt.fit(y, X, **opts)
    lo, hi = SIZES[route][0], min(SIZES[route][-1], X.shape[0])
    rng = np.random.default_rng(11)
    out = {"fit": _paired(dev, lambda: bt.fit(y, X, **opts),
                          reps // 2 if route == "dense"
                          else max(2, reps // 40))}
    for u in (lo, int(round((lo * hi) ** 0.5)), hi):
        new = X[rng.integers(0, X.shape[0], size=u)]
        bt.predict(m, new, se_pred=True)
        out[f"request_{u}"] = _paired(
            dev, lambda new=new: bt.predict(m, new, se_pred=True), reps)
    return out


def span_cost(dev, calls: int = 2000) -> dict:
    """Host microseconds of a call of four spans (as a predict has), the
    pool warm, against the same loop with the recorder off; and of one
    event record, query and elapsed_time."""
    from bigkrls_tpu_torch.utils import progress

    def loop():
        t0 = time.perf_counter()
        for _ in range(calls):
            with progress.span("call", device=dev):
                for name in ("a", "b", "c", "d"):
                    with progress.span(name):
                        pass
        return time.perf_counter() - t0

    loop()
    progress.spans()
    on = loop()
    progress.spans()
    with recorder_off():
        off = loop()
    out = {"call_of_4_spans_us": 1e6 * on / calls,
           "call_of_4_spans_off_us": 1e6 * off / calls}
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record(stream)
        b.record(stream)
        sync(dev)
        for name, fn in (("record_us", lambda: a.record(stream)),
                         ("query_us", b.query),
                         ("elapsed_us", lambda: a.elapsed_time(b))):
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name] = 1e6 * (time.perf_counter() - t0) / calls
            b.record(stream)
            sync(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", nargs="+", default=["reads", "cost"])
    ap.add_argument("--routes", nargs="+", default=["dense", "streaming"])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--n", type=int, default=None,
                    help="rows (default the cells'; small on the CPU)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("host_reads: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    smi = card_line(dev)
    print(smi, flush=True)
    res = {"card": smi, "torch": torch.__version__}
    for route in args.routes:
        if "reads" in args.parts:
            res[f"reads_{route}"] = reads_part(dev, route, args.n)
            print(json.dumps({route: res[f"reads_{route}"]}, default=str),
                  flush=True)
        if "cost" in args.parts:
            res[f"cost_{route}"] = cost_part(dev, route, args.n, args.reps)
    if "cost" in args.parts:
        res["span"] = span_cost(dev)
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
