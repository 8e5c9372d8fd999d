"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m krlsbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. In order: it refuses to run without the CUDA
cards the cell asks for (there is no CPU fallback); makes the cell's data
from the seed; warms up the cell's own shapes (set-up, with the program's
kernel library loaded from, or built once into, its fixed directory in the
checkout); drives the cell's traffic for ``--seconds``; checks what the
window produced against the plain reference; and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit (also the last lines of standard error).

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled last part of
the window (``trace_seconds`` of the traffic mix, and at least one whole
job) and from the phases of the jobs before it. The memory peak, the wait
at each job's end and the device's busy time take every card of the
cell.
"""
from __future__ import annotations

import time

T0 = time.time()    # the process's start, for setup_s

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bigkrls_tpu")
CACHE = Path("krlsbench") / "_cache"
# one host thread for the BLAS and OpenMP pools: the host work of a fit or
# a request is small, and idle pool threads spinning beside it made runs
# spread (set before numpy and torch are imported)
THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def use_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = root / CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""
    cell: str
    kind: str
    setup_s: float
    window: object                  # loop.Window
    peak_window_bytes: int          # the largest of any one card
    trace: Optional[object]         # trace.TraceSummary


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def card_peaks(devices, reset: bool = False) -> list:
    """Each card's memory peak since its last reset; with ``reset``, read
    once each card has finished its work, and reset."""
    import torch
    if reset:
        for d in devices:
            torch.cuda.synchronize(d)
    peaks = [torch.cuda.max_memory_allocated(d) for d in devices]
    if reset:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    return peaks


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t0: float, log=None) -> Optional[dict]:
    """Set up, drive and check one cell; the result's dict, or None when
    the run must print no result."""
    import torch

    import bigkrls_tpu_torch as bk

    from . import check, loop as loops
    from .trace import Tracer

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    devices = loops.cards(device, cell.chips)
    runner = loops.make(bk, cell.config, cell.traffic, seed, device,
                        chips=cell.chips)
    tracer = Tracer(cell.chips) if trace else None
    runner.warm_up()
    if tracer is not None:
        tracer.warm_up()
    setup_peaks = card_peaks(devices, reset=True) if cuda else [0]
    setup_s = time.time() - t0
    window = loops.drive(runner, seconds,
                         tracer.window if tracer else None,
                         float(cell.traffic.get("trace_seconds", 3.0)))
    peaks = card_peaks(devices) if cuda else [0]
    peak = max(peaks)
    t_reduce = time.perf_counter()
    summary = tracer.summary(window.traced) if tracer else None
    t_reduce = time.perf_counter() - t_reduce
    run = Run(cell.name, runner.kind, setup_s, window, peak, summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m.kind != kind:
            continue
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    log(f"card: {card_line() if cuda else 'cpu'}")
    log(f"window: {len(window.jobs)} {runner.kind} jobs in "
        f"{window.seconds:.4f} s, {window.failed} failed"
        + (f" ({len(window.traced)} traced)" if trace else ""))
    log(f"memory peaks by card: set-up {setup_peaks}, window {peaks}")
    if summary is not None:
        log(f"trace: busy {summary.card_busy_s} s by card of "
            f"{summary.window_s} s, reduced in {t_reduce:.3f} s")
    for e in window.errors[:5]:
        log(f"failed: {e}")
    # the program's state goes before the reference runs, so that the
    # reference neither reads it nor sets the peak read above
    runner.model = None
    limits = cell.config["limits"][runner.kind]
    try:
        numbers = loops.kind(cell.traffic).check(
            runner, window.jobs, cell.config, cell.traffic, seed, device)
        for name, value in numbers.items():
            if name not in limits:
                log(f"reading (not compared) {name}: {value!r}")
        ok, rows = check.judge(numbers, limits)
    except Exception:
        log(traceback.format_exc())
        ok, rows = False, [(k, float("nan"), float(v))
                           for k, v in limits.items()]
    correct = bool(ok and window.failed == 0 and window.jobs)
    for name, value, limit in rows:
        log(f"check {name}: {value!r} (limit {limit!r})"
            f"{'' if value <= limit else ' FAIL'}")
    result = {
        "correct": correct,
        "attempted": len(window.jobs) + window.failed,
        "failed": window.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": max(setup_peaks + peaks),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded JAX or the JAX package: {bad}")
        return None
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m krlsbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    use_caches(root)
    os.environ.update(THREADS)

    import torch
    torch.set_num_threads(1)

    from . import spec
    try:
        cell = spec.cell(spec.load_benchmark(root), args.workload, root)
    except spec.SpecError as e:
        print(f"krlsbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"krlsbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T0)
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
