#!/usr/bin/env python3
"""The golden-section λ search on one card: host reads, chunk length, the
bench's three post-kernel regions and the workflows beside them.

    python3 tools/golden_loop.py [--device cuda] [--reps 9] [--parts ...]

Run from a tree's root (this one, or a parent commit unpacked beside it
with ``git archive``: ``cd archive_check/parent && python3
../../tools/golden_loop.py``). The data are ``chip_smoke.py``'s default
fit (``bench.smoke_data()``, N=3106, P=67, float32; the adaptive route at
k=256). Parts (``--parts``, all by default):

* ``reads``: the synchronising calls of one warm default fit, as
  ``torch.cuda.set_sync_debug_mode("warn")`` reports them (each a warning
  from the Python line that made it; an explicit
  ``torch.cuda.synchronize``, as the phase timer's, is not reported), in
  all and by file and line;
* ``bench``: the bench's three post-kernel regions
  (``bench.postkernel_fit_adaptive``, ``postkernel_fit_dense``,
  ``postkernel_fit_neig50(method="auto")``) on the same K, one warm-up,
  then min and median of ``--reps`` synchronised runs each;
* ``dense-loops`` (not by default): ``loops`` on the dense region's full
  N×N eigenbasis (``ops/fused.postkernel_device``'s inputs);
* ``loops`` (a tree with ``ops/solve.golden_search_device`` only): on the
  default fit's own masked basis (``ops/adaptive._adaptive_fused``), the
  device loop against the host loop (λ*, Le, coefficients, times) and
  the chunk length ``GOLDEN_CHUNK`` swept;
* ``workflows`` (not by default): :func:`workflows`, the CV protocols, a
  resume and fits of new row counts, with the golden searches each made
  and the CUDA graphs it captured.

Prints the card (``nvidia-smi`` name and power limit), then one JSON line.
``chip_smoke.py`` imports :func:`count_syncs`, :func:`host_golden_solve`,
:func:`bench_regions` and :func:`loop_basis` from here. No JAX is used.
"""
import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

# the warning each synchronising call gives in "warn" mode (the mode's own
# "prototype feature" notice is not one)
SYNC_WARNING = "synchronizing CUDA operation"


def now(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def min_median(times):
    return {"min": min(times), "median": statistics.median(times),
            "n": len(times)}


@contextlib.contextmanager
def count_syncs():
    """Records every synchronising CUDA call made inside: yields a dict
    ``{"total": n, "by_site": {"file.py:line": n}}`` filled on exit."""
    out = {"total": 0, "by_site": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if SYNC_WARNING in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            out["by_site"][site] = out["by_site"].get(site, 0) + 1
            out["total"] += 1
    out["by_site"] = dict(sorted(out["by_site"].items(),
                                 key=lambda kv: -kv[1]))


def host_golden_solve(vectors, values, y_std, L, U, tol, mask=None,
                      log=None, progress=None):
    """The golden search as the port ran it before the device loop: the
    host loop (``ops/solve.golden_section``, python floats, one LOO read
    a step, the bounds read first), then the solve at that λ. Same
    signature and outputs as ``ops/solve.golden_solve``."""
    from bigkrls_tpu_torch.ops.solve import (golden_section, loo_solver,
                                             solve_precompute)
    Qty, Q2 = solve_precompute(vectors, y_std)
    loo = loo_solver(vectors, values, Qty, Q2, mask)
    lam, it = golden_section(lambda x: float(loo(x)[0]), float(L),
                             float(U), float(tol), log=log)
    lam = torch.full((), lam, dtype=values.dtype, device=values.device)
    Le, coeffs = loo(lam)
    return lam, Le, coeffs, it


@contextlib.contextmanager
def host_loop_in_regions():
    """The fit's adaptive and dense regions with the host loop in place of
    the device loop (what the port ran before)."""
    from bigkrls_tpu_torch.ops import adaptive, fused
    saved = adaptive.golden_solve, fused.golden_solve
    adaptive.golden_solve = fused.golden_solve = host_golden_solve
    try:
        yield
    finally:
        adaptive.golden_solve, fused.golden_solve = saved


def default_data(dev, n=None, p=None):
    """chip_smoke's default fit data: (y, X) on the host and the
    standardized (K, y) on ``dev`` as the bench makes them."""
    from bigkrls_tpu_torch.bench import smoke_data
    from bigkrls_tpu_torch.ops.kernels import kernel_matrix
    y, X = smoke_data(n, p)
    Xs = (X - X.mean(0)) / X.std(0, ddof=1)
    ys = (y - y.mean()) / y.std(ddof=1)
    Xd = torch.as_tensor(Xs, dtype=torch.float32, device=dev)
    K = kernel_matrix(Xd, float(X.shape[1]))
    return y, X, K, torch.as_tensor(ys, dtype=torch.float32, device=dev)


def bench_regions(K, yd, reps: int = 9):
    """The bench's three post-kernel regions on ``K``: one warm-up, then
    min and median of ``reps`` synchronised runs each, in seconds."""
    from bigkrls_tpu_torch import bench
    regions = {
        "krls_postkernel_fit_n3106_p67_s":
            lambda: bench.postkernel_fit_adaptive(K, yd),
        "krls_postkernel_fit_dense_n3106_s":
            lambda: bench.postkernel_fit_dense(K, yd),
        "krls_postkernel_fit_neig50_n3106_s":
            lambda: bench.postkernel_fit_neig50(K, yd, "auto"),
    }
    out = {}
    for name, fn in regions.items():
        fn()
        times = []
        for _ in range(reps):
            t = now(K.device)
            fn()
            times.append(now(K.device) - t)
        out[name] = min_median(times)
    return out


def loop_basis(K, yd):
    """The default fit's golden-search inputs: ``_adaptive_fused``'s
    Krylov head (k=256 at N=3106 in f32), its lastkeeper mask, its device
    bounds and tol = N/1000."""
    from bigkrls_tpu_torch.ops import adaptive
    n = int(K.shape[0])
    k = min(adaptive._round64(max(64, n / 16.0)), (n // 4 // 64) * 64)
    out = adaptive._adaptive_fused(K, yd, k, 3, 0.001, 1e-3 * n, 8)
    vals, vecs, lk, L, U = out[0], out[1], out[3], out[6], out[7]
    mask = (torch.arange(k, device=K.device) < lk).to(yd.dtype)
    return dict(vectors=vecs, values=vals, y_std=yd, L=L, U=U,
                tol=1e-3 * n, mask=mask)


def dense_basis(K, yd):
    """The dense region's golden-search inputs (``ops/fused.
    postkernel_device``): the full N×N eigenbasis, its lastkeeper mask at
    eigtrunc 0.001 and the device bounds."""
    from bigkrls_tpu_torch.ops import fused
    from bigkrls_tpu_torch.ops.eig import _eigh_desc
    n = int(K.shape[0])
    values, vectors = _eigh_desc(K)
    idx = torch.arange(n, device=K.device)
    keep = values >= 0.001 * values[0]
    lk = torch.clamp_min(torch.max(torch.where(keep, idx, -1)) + 1, 1)
    return dict(vectors=vectors, values=values, y_std=yd,
                L=torch.clamp_min(fused._lower_bound_device(values),
                                  fused._EPS),
                U=fused._upper_bound_device(values, n), tol=1e-3 * n,
                mask=(idx < lk).to(yd.dtype))


def _timed(fn, dev, reps):
    fn()
    times = []
    for _ in range(reps):
        t = now(dev)
        fn()
        times.append(now(dev) - t)
    return min_median(times)


def loops(basis, reps: int):
    """Device loop against host loop, and the chunk sweep."""
    from bigkrls_tpu_torch.ops import solve
    dev = basis["values"].device
    res = {}
    lam_d, Le_d, c_d, it_d = solve.golden_solve(**basis)
    lam_h, Le_h, c_h, it_h = host_golden_solve(**basis)
    res["device_vs_host"] = {
        "lambda": [float(lam_d), float(lam_h)], "iterations": [it_d, it_h],
        "lambda_rel": abs(float(lam_d) - float(lam_h)) / abs(float(lam_h)),
        "Le_rel": abs(float(Le_d) - float(Le_h)) / abs(float(Le_h)),
        "coeffs_rel": float((c_d - c_h).abs().max() / c_h.abs().max()),
        "device_s": _timed(lambda: solve.golden_solve(**basis), dev, reps),
        "host_s": _timed(lambda: host_golden_solve(**basis), dev, reps)}
    Qty, Q2 = solve.solve_precompute(basis["vectors"], basis["y_std"])
    args = (basis["vectors"], basis["values"], Qty, Q2, basis["L"],
            basis["U"], basis["tol"])
    sweep = {}
    saved = solve.GOLDEN_CHUNK
    try:
        for T in (4, 8, 16):
            solve.GOLDEN_CHUNK = T
            lam, it, chunks = solve.golden_search_device(
                *args, mask=basis["mask"])
            sweep[T] = {"iterations": it, "chunks": chunks,
                        "lambda_bits_equal": torch.equal(lam, lam_d),
                        "search_s": _timed(lambda: solve.golden_search_device(
                            *args, mask=basis["mask"]), dev, reps)}
    finally:
        solve.GOLDEN_CHUNK = saved
    res["chunk_sweep"] = sweep
    return res


@contextlib.contextmanager
def counting_searches():
    """Counts the golden searches made inside (device loop and host loop
    alike, in whichever this tree has) and the CUDA graphs captured
    (``torch.cuda.CUDAGraph.capture_begin`` calls, none in this tree):
    yields ``{"searches": n, "captures": n}``."""
    from bigkrls_tpu_torch import lambda_search
    from bigkrls_tpu_torch.ops import solve
    out = {"searches": 0, "captures": 0}
    saved = []

    def wrap(mod, name, key):
        fn = getattr(mod, name, None)
        if fn is None:
            return

        def counted(*a, **kw):
            out[key] += 1
            return fn(*a, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    for mod in (solve, lambda_search):
        wrap(mod, "golden_search_device", "searches")
        wrap(mod, "golden_section", "searches")
    graph = getattr(torch.cuda, "CUDAGraph", None)
    if graph is not None:
        begin = graph.capture_begin

        def counted_begin(self, *a, **kw):
            out["captures"] += 1
            return begin(self, *a, **kw)
        graph.capture_begin = counted_begin
    try:
        yield out
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        if graph is not None:
            graph.capture_begin = begin


def workflows(y, X, dev, reps: int):
    """The fits a user makes beside the bench's repeated one, in this
    process after ``reps`` warm default fits: ``crossvalidate(ptesting=20,
    neig=50)`` for seeds 1-3 (``chip_smoke.py``'s census protocol),
    5-fold CV, a checkpointed fit and its resume, and a fit of each of two
    row counts not fitted before (N−106, N−206). Each: seconds (CUDA
    synchronised), golden searches and CUDA graphs captured."""
    import tempfile

    import bigkrls_tpu_torch as bt
    kw = dict(device=dev.type, noisy=False)
    out = {}

    def run(name, fn):
        with counting_searches() as c:
            t = now(dev)
            fn()
            c["seconds"] = now(dev) - t
        out[name] = c
        print(f"  {name}: {c['seconds']:.6f} s, {c['searches']} searches, "
              f"{c['captures']} graph captures", flush=True)

    times = []
    for _ in range(reps):
        t = now(dev)
        bt.fit(y, X, **kw)
        times.append(now(dev) - t)
    out["warm_default_fit_s"] = min_median(times)
    for seed in (1, 2, 3):
        run(f"census_cv_seed{seed}", lambda: bt.crossvalidate(
            y, X, seed=seed, ptesting=20, neig=50, **kw))
    run("kfold5", lambda: bt.crossvalidate(y, X, seed=1, kfolds=5, **kw))
    with tempfile.TemporaryDirectory() as ck:
        run("checkpointed_fit", lambda: bt.fit(y, X, checkpoint_dir=ck,
                                               **kw))
        run("dense_resume", lambda: bt.fit(y, X, checkpoint_dir=ck, **kw))
    n = X.shape[0]
    for rows in (n - 106, n - 206):
        run(f"new_shape_fit_n{rows}", lambda: bt.fit(y[:rows], X[:rows],
                                                     **kw))
    return out


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--parts", nargs="+", default=["reads", "bench",
                                                   "loops"])
    ap.add_argument("--n", type=int, default=None,
                    help="rows (default the bench's N; small on the CPU)")
    ap.add_argument("--p", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("golden_loop: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.ops import solve
    smi = card_line(dev)
    print(smi, flush=True)
    res = {"card": smi, "tree": os.getcwd(), "torch": torch.__version__,
           "device_loop": hasattr(solve, "golden_search_device"),
           "golden_chunk": getattr(solve, "GOLDEN_CHUNK", None)}
    y, X, K, yd = default_data(dev, args.n, args.p)
    fit_kw = dict(device=args.device, noisy=False)
    if "reads" in args.parts:
        bt.fit(y, X, **fit_kw)
        bt.fit(y, X, **fit_kw)
        if dev.type == "cuda":
            with count_syncs() as reads:
                m = bt.fit(y, X, **fit_kw)
            res["reads"] = reads
        else:
            m = bt.fit(y, X, **fit_kw)
        res["fit"] = {"eig_path": m.eig_path, "lambda": m.lambda_,
                      "lastkeeper": m.lastkeeper}
    if "bench" in args.parts:
        res["bench"] = bench_regions(K, yd, args.reps)
    if "loops" in args.parts and res["device_loop"]:
        res["loops"] = loops(loop_basis(K, yd), args.reps)
    if "workflows" in args.parts:
        res["workflows"] = workflows(y, X, dev, args.reps)
    if "dense-loops" in args.parts and res["device_loop"]:
        res["dense_loops"] = loops(dense_basis(K, yd), args.reps)
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
