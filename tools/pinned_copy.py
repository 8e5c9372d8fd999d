#!/usr/bin/env python3
"""Copies from the card to the host as ``predict`` makes them, pinned
against pageable, and ``predict``'s requests with their results landing
either way.

    python3 tools/pinned_copy.py [--device cuda] [--parts copies requests]
                                 [--reps 20]

Run from a tree's root. Parts (``--parts``, both by default):

* ``copies``: for each size, a float32 result on the card read as the
  pageable path reads it (``.cpu()`` into fresh pageable memory, then
  ``astype(np.float64)`` on the host; each step timed) against the pinned
  path (widened to float64 on the card, then ``copy_`` into a block of
  the caching host allocator: one DMA and one wait for the stream), each
  timed on the host clock; the pinned copy alone between CUDA events (the
  pinned DtoH bandwidth), the widening kernel alone, and the first pinned
  allocation of each size (``cudaHostAlloc``) apart;
* ``requests``: ``predict(se_pred=True)`` against the dense cells' model
  (N=3106, P=67) at 1, 56, 517 and 3106 rows and the streaming cells'
  (N=50,000, P=20, ``neig=500``) at 1, 71, 1000 and 5000 rows (blocked),
  its results landing pinned and pageable (``predict._ToHost`` forced) in
  ``--reps`` pairs, the order swapped every pair, each timed on the host
  clock to a synchronize, with the ``to_host`` spans' device ms.

Prints the card (``nvidia-smi`` name and power limit), then one JSON line.
No JAX is used.
"""
import argparse
import contextlib
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from golden_loop import card_line  # noqa: E402

# float32 results of predict's shapes: (U, N) newdataK of the dense and
# the streaming cells, and the ŷ of a large request
COPY_SHAPES = [(1,), (3106,), (56, 3106), (517, 3106), (3106, 3106),
               (71, 50000), (517, 50000), (1000, 50000)]


def _q(xs):
    """Median and quartiles of ``xs``."""
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def copies_part(dev, reps: int) -> dict:
    stream = torch.cuda.current_stream(dev)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = {}
    for shape in COPY_SHAPES:
        t = torch.rand(shape, device=dev, dtype=torch.float32)
        n64 = t.numel() * 8
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        h = torch.empty(shape, dtype=torch.float64, pin_memory=True)
        first_alloc = time.perf_counter() - t0
        del h
        page, page_cpu, page_widen, pinned, dma, widen = [], [], [], [], [],\
            []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            a = t.cpu().numpy()
            t1 = time.perf_counter()
            b = a.astype(np.float64)
            t2 = time.perf_counter()
            page.append(t2 - t0)
            page_cpu.append(t1 - t0)
            page_widen.append(t2 - t1)
            del a, b
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            h = torch.empty(shape, dtype=torch.float64, pin_memory=True)
            h.copy_(t.to(torch.float64))
            arr = h.numpy()
            pinned.append(time.perf_counter() - t0)
            assert np.array_equal(arr, t.cpu().numpy().astype(np.float64))
            del arr, h
            d = t.to(torch.float64)
            h = torch.empty(shape, dtype=torch.float64, pin_memory=True)
            e0.record(stream)
            h.copy_(d, non_blocking=True)
            e1.record(stream)
            e1.synchronize()
            dma.append(e0.elapsed_time(e1) / 1e3)
            e0.record(stream)
            d = t.to(torch.float64)
            e1.record(stream)
            e1.synchronize()
            widen.append(e0.elapsed_time(e1) / 1e3)
            del d, h
        ms = lambda xs: {k: 1e3 * v for k, v in _q(xs).items()}  # noqa: E731
        out["x".join(map(str, shape))] = {
            "mb_float64": n64 / 1e6,
            "pageable_ms": ms(page), "pageable_cpu_ms": ms(page_cpu),
            "pageable_astype_ms": ms(page_widen),
            "pinned_ms": ms(pinned), "pinned_dma_ms": ms(dma),
            "widen_on_card_ms": ms(widen),
            "pinned_dma_gb_s": n64 / statistics.median(dma) / 1e9,
            "pageable_mb_float32_per_ms":
                n64 / 2e6 / (1e3 * statistics.median(page)),
            "first_pinned_alloc_ms": 1e3 * first_alloc,
        }
        print(json.dumps({"copy": out["x".join(map(str, shape))],
                          "shape": shape}), flush=True)
    return out


@contextlib.contextmanager
def pageable():
    """``predict`` with its results read as on the CPU."""
    tpredict = importlib.import_module("bigkrls_tpu_torch.predict")
    real = tpredict._ToHost
    tpredict._ToHost = lambda _: real(False)
    try:
        yield
    finally:
        tpredict._ToHost = real


def _to_host_ms() -> float:
    from bigkrls_tpu_torch.utils import progress
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == "predict"][-1]
    return 1e3 * sum(s.seconds for s in log
                     if s.call == root.call and s.name == "to_host")


def requests_part(dev, reps: int) -> dict:
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch import bench
    out = {}
    for route, (y, X), opts, sizes in (
            ("dense", bench.smoke_data(), {}, (1, 56, 517, 3106)),
            ("streaming", bench.streaming_data(50000),
             dict(neig=500, which_derivatives=[0, 1, 2, 3, 4]),
             (1, 71, 1000, 5000))):
        m = bt.fit(y, X, device=str(dev), noisy=False, **opts)
        rng = np.random.default_rng(3)
        for u in sizes:
            new = X[rng.integers(0, X.shape[0], size=u)]
            res = {"pinned": [], "pageable": []}
            span = {"pinned": [], "pageable": []}
            for side in ("pinned", "pageable"):      # warm both
                with (pageable() if side == "pageable"
                      else contextlib.nullcontext()):
                    bt.predict(m, new, se_pred=True)
            for i in range(reps):
                for side in (("pinned", "pageable") if i % 2 == 0
                             else ("pageable", "pinned")):
                    with (pageable() if side == "pageable"
                          else contextlib.nullcontext()):
                        torch.cuda.synchronize(dev)
                        t0 = time.perf_counter()
                        bt.predict(m, new, se_pred=True)
                        torch.cuda.synchronize(dev)
                        res[side].append(time.perf_counter() - t0)
                    span[side].append(_to_host_ms())
            out[f"{route}_{u}"] = {
                side: {"ms": {k: 1e3 * v for k, v in _q(res[side]).items()},
                       "to_host_ms": _q(span[side])}
                for side in res}
            out[f"{route}_{u}"]["pinned_wins"] = sum(
                a < b for a, b in zip(res["pinned"], res["pageable"]))
            out[f"{route}_{u}"]["pairs"] = reps
            print(json.dumps({f"{route}_{u}": out[f"{route}_{u}"]}),
                  flush=True)
        del m
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", nargs="+", default=["copies", "requests"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print("pinned_copy: needs a CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    smi = card_line(dev)
    print(smi, flush=True)
    res = {"card": smi, "torch": torch.__version__}
    if "copies" in args.parts:
        res["copies"] = copies_part(dev, args.reps)
    if "requests" in args.parts:
        res["requests"] = requests_part(dev, args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
