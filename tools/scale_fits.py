#!/usr/bin/env python3
"""The streaming fit at scale, on one CUDA card: a check and a record.

    python3 tools/scale_fits.py [--check-n 500000] [--big-n 1000000]

Run from a tree's root. Both fits use the port's benchmark recipe
(``bigkrls_tpu_torch/bench.py``: the JAX bench's seeded data, P=20,
``neig=500``, five derivative columns, the package's default flow).

1. The check: the fit at ``--check-n`` rows through K2 (the CUDA product
   kernel) and again through the plain PyTorch product, both float32,
   held against each other within the end-to-end limits of PERF.md §2
   (λ*, LOO error, Neff, lastkeeper, R², AMEs within 1e-2 of max|AME|,
   predictions of 10 rows within 1e-3 of sd(y));
2. the record: one fit at ``--big-n`` rows, with its λ*, lastkeeper, R²,
   ``eig_path``, its phase times, wall time, K2 launches and peak memory
   (``torch.cuda.max_memory_allocated``);
3. the indexing at that size: one K2 product of the fit's block width
   (540 columns) at ``--big-n`` rows, its first and last 256 rows held
   against the plain product of the same rows (``kernel_matmul_plain``
   with ``Xb``) within ``bench.k2_tol``. Past about 994,000 rows an
   output row's byte offset passes 2³¹.

Prints the card (``nvidia-smi`` name and power limit), a line per fit, and
one JSON line; exits 1 if a check fails or no CUDA device is present.
``--device cpu`` at a small N rehearses the script on the CPU, where both
products are the plain one. No JAX is used.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))


def timed_fit(y, X, device, **kw):
    """(model, synced wall seconds, peak GiB, K2 launches) of one fit."""
    from bigkrls_tpu_torch import bench, fit
    from bigkrls_tpu_torch.ops import matvec
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    launches = matvec.kernel_matmul_launches
    t0 = time.perf_counter()
    m = fit(y, X, neig=bench.STREAM_NEIG, streaming=True, noisy=False,
            which_derivatives=bench.STREAM_DERIVATIVES, device=dev, **kw)
    if cuda:
        torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    return m, sec, peak, matvec.kernel_matmul_launches - launches


def describe(tag, m, sec, peak, launches):
    rec = {"fit": tag, "n": m.n, "wall_s": sec, "lambda": m.lambda_,
           "lastkeeper": m.lastkeeper, "R2": m.R2, "looe": m.looe,
           "neffective": m.neffective, "eig_path": m.eig_path,
           "timings": {d["phase"]: d["seconds"] for d in m.timings},
           "k2_launches": launches, "peak_gib": peak}
    print(json.dumps(rec), flush=True)
    return rec


def end_rows(X, device, failures, rows: int = 256):
    """K2 at all of X's rows against the plain product of its first and
    last ``rows`` rows; returns the relative error and the product's ms."""
    from bigkrls_tpu_torch import bench
    from bigkrls_tpu_torch.ops import matvec
    dev = torch.device(device)
    n, p = X.shape
    Xd = torch.as_tensor((X - X.mean(0)) / X.std(0, ddof=1),
                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    V = torch.randn((n, bench.STREAM_Q), generator=gen, device=dev)
    t0 = time.perf_counter()
    Y = matvec.kernel_matmul(Xd, V, float(p))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    idx = torch.cat([torch.arange(rows), torch.arange(n - rows, n)]).to(dev)
    ref = matvec.kernel_matmul_plain(Xd[idx].contiguous(), V, float(p), Xb=Xd)
    err = ((Y[idx] - ref).abs().max() / ref.abs().max()).item()
    tol = bench.k2_tol(n)
    print(f"N={n} K2 product ({ms:.1f} ms): rows 0-{rows - 1} and "
          f"{n - rows}-{n - 1} vs the plain product, max|d|/max|Y| "
          f"{err:.3e} (limit {tol:.1e})", flush=True)
    if not err <= tol:
        failures.append(f"N={n} K2 end rows: {err} > {tol}")
    return {"n": n, "ms": ms, "max_rel_err": err, "limit": tol}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-n", type=int, default=500_000)
    ap.add_argument("--big-n", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("scale_fits: no CUDA device", file=sys.stderr)
        return 1
    from bigkrls_tpu_torch import bench, predict
    from bigkrls_tpu_torch.ops import _build
    info = bench.card(dev)
    print(f"{info['card']}, {info['power_limit']}; torch {info['torch']}, "
          f"CUDA {info['cuda']}", flush=True)
    if dev.type == "cuda":
        _build.library()
        print(f"kernel library build {_build.last_build_seconds:.1f} s",
              flush=True)

    failures = []
    n = args.check_n
    y, X = bench.streaming_data(n)
    fits = {}
    for impl in ("auto", "plain"):
        m, sec, peak, launches = timed_fit(y, X, dev, kernel_impl=impl)
        fits[impl] = (m, describe(f"N={n} {impl}", m, sec, peak, launches))
    m_k2, m_plain = fits["auto"][0], fits["plain"][0]
    print(f"N={n}: the fit through K2 against the fit through the plain "
          f"product (both f32):", flush=True)
    bench.compare_fits(m_k2, m_plain,
                       predict(m_k2, X[:10], se_pred=True),
                       predict(m_plain, X[:10], se_pred=True), y, failures)
    if dev.type == "cuda" and fits["auto"][1]["k2_launches"] == 0:
        failures.append("the K2 fit launched no K2 kernel")
    check = [fits["auto"][1], fits["plain"][1]]
    del fits, m_k2, m_plain
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    n = args.big_n
    y, X = bench.streaming_data(n)
    big = describe(f"N={n}", *timed_fit(y, X, dev))
    ok = (np.isfinite(big["R2"]) and np.isfinite(big["lambda"])
          and big["eig_path"] == "streaming-krylov")
    if not ok:
        failures.append(f"N={n} fit: {big}")
    rows = end_rows(X, dev, failures)
    print(json.dumps({"card": info, "check": check, "big": big,
                      "end_rows": rows, "failures": failures}), flush=True)
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
