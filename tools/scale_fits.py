#!/usr/bin/env python3
"""The streaming fit at scale, on one CUDA card: checks and records.

    python3 tools/scale_fits.py [--check-n 500000] [--big-n 1000000]
                                [--constant-memory [--auto-n 2000000]]
                                [--only check|big|auto]

Run from a tree's root. Every fit uses the port's benchmark recipe
(``bigkrls_tpu_torch/bench.py``: the JAX bench's seeded data, P=20,
``neig=500``, five derivative columns).

The parts (``--only`` runs one of them):

1. check: the fit at ``--check-n`` rows through K2 (the CUDA product
   kernel) and again through the plain PyTorch product, both float32,
   held against each other within the end-to-end limits of PERF.md §2
   (λ*, LOO error, Neff, lastkeeper, R², AMEs within 1e-2 of max|AME|,
   predictions of 10 rows within 1e-3 of sd(y));
2. big: the record of one fit at ``--big-n`` rows; then one K2 product of
   the fit's block width (540 columns) at that size, its first and last
   256 rows held against the plain product of the same rows
   (``kernel_matmul_plain`` with ``Xb``) within ``bench.k2_tol``. Past
   about 994,000 rows an output row's byte offset passes 2³¹.

Without ``--constant-memory`` the fits take the flow the package picks on
this card (progressive block-Krylov up to about N=1.7M on 80 GB) and the
product is precise. With it, parts 1 and 2 run the constant-memory
(Chebyshev) flow, which ``fit`` picks by itself under the 8 GiB the JAX
package plans against on its chip (``bench.planning_budget``, restored
after each fit; ``--planning-budget`` sets another). The check then
compares the LOO errors at the K2 fit's λ* (each reference refitted
there) and adds the progressive fit of the same data under the card's
own budget, with the gap; ``--f64`` adds the same fit in float64 on the
device, ``--fast-eig-power`` sets the fits' ``fast_eig_power``. The big
fit runs cold and warm, and the product is the one the flow's recurrence
step runs: fast mode with ``init`` and ``out`` over it, its end rows held
against the plain cross product under TF32 and against the same rounding
with IEEE sums (``kernel_matmul_split_plain(fast=True)``), both within
``bench.K2_FAST_TOL`` (precise mode's ``k2_tol`` printed beside), and
each of the three against the same rows in float64. A third part runs:

3. auto: the fit at ``--auto-n`` rows with nothing patched, which must
   take the constant-memory flow by itself (6 K2 launches), then
   ``summary`` and ``predict`` of 10 rows with SEs; one fit, cold.

Each fit's record (a JSON line) gives the card and power limit, the wall
time, the phases, K2's launches by shape and mode
(``ops/matvec.kernel_matmul_shapes``), the floor at K2's bound
(``bench.launch_floor_s``), the peak memory
(``torch.cuda.max_memory_allocated``, and above what was allocated as the
fit started), the memory allocated as each K2 launch starts, λ* and the
search's bounds, R², lastkeeper, and the branches ``_block_orth`` took
(``ops/eig.block_orth_counts``: whether CholeskyQR²'s check failed and
Householder QR ran). The last line is one JSON object of every record;
exits 1 if a check fails or no CUDA device is present. ``--device cpu``
at a small N rehearses the script on the CPU, where every product is the
plain one. No JAX is used.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))

END_ROWS = 256


def _spy_products(matvec, log):
    """Replace ``matvec.kernel_matmul`` by a wrapper that appends the
    memory allocated (GiB) as each product starts to ``log``."""
    real = matvec.kernel_matmul

    def spying(X, V, sigma, **kw):
        if X.device.type == "cuda":
            log.append(round(torch.cuda.memory_allocated(X.device) / 2 ** 30,
                             3))
        return real(X, V, sigma, **kw)

    matvec.kernel_matmul = spying
    return real


def timed_fit(tag, y, X, device, budget=None, **kw):
    """One fit (the bench recipe), under ``bench.planning_budget(budget)``
    where given: its model and record, printed as a JSON line."""
    from bigkrls_tpu_torch import bench, fit, lambda_search
    from bigkrls_tpu_torch.ops import eig, matvec
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    shapes = matvec.kernel_matmul_shapes.copy()
    orth = getattr(eig, "block_orth_counts", None)
    orth = None if orth is None else orth.copy()
    live = []
    real = _spy_products(matvec, live)
    scope = (bench.planning_budget(budget) if budget is not None
             else contextlib.nullcontext())
    try:
        with scope:
            t0 = time.perf_counter()
            m = fit(y, X, neig=bench.STREAM_NEIG, streaming=True,
                    noisy=False, which_derivatives=bench.STREAM_DERIVATIVES,
                    device=dev, **kw)
            if cuda:
                torch.cuda.synchronize(dev)
            sec = time.perf_counter() - t0
    finally:
        matvec.kernel_matmul = real
    launched = sorted([*key, c] for key, c in
                      (matvec.kernel_matmul_shapes - shapes).items())
    values = np.asarray(m.K_eigenvalues, dtype=np.float64)
    rec = {"fit": tag, "n": m.n, "wall_s": sec,
           "planning_budget_gib": None if budget is None
           else budget / 2 ** 30,
           "lambda": m.lambda_,
           "lambda_bounds": [lambda_search._lower_bound(values),
                             lambda_search._upper_bound(values, m.n)],
           "eigenvalues_head_tail": [values[:3].tolist(),
                                     values[-3:].tolist()],
           "lastkeeper": m.lastkeeper, "R2": m.R2,
           "looe": m.looe, "neffective": m.neffective,
           "eig_path": m.eig_path,
           "timings": {d["phase"]: d["seconds"] for d in m.timings},
           "k2_launches": sum(r[-1] for r in launched),
           "k2_fast_launches": sum(r[-1] for r in launched
                                   if r[4] == "fast"),
           "k2_products": launched,
           "product_floor_s": bench.launch_floor_s(launched),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
           if cuda else None,
           "peak_above_start_gib": (torch.cuda.max_memory_allocated(dev)
                                    - base) / 2 ** 30 if cuda else None,
           "allocated_gib_at_products": live,
           "block_orth": None if orth is None
           else dict(eig.block_orth_counts - orth)}
    print(json.dumps(rec), flush=True)
    return m, rec


def plan(n, constant_memory):
    """K2's launches of one fit by [N, Nb, P, m, mode, count]: the
    constant-memory flow's 4 fast power products (two Chebyshev
    applications of degree 2), its precise Ritz product and the
    derivatives' product; or the progressive flow's 6 power products and
    the last block's Ritz product, all precise, and the derivatives'."""
    from bigkrls_tpu_torch import bench
    p, q = bench.STREAM_P, bench.STREAM_Q
    stack = 2 + 4 * len(bench.STREAM_DERIVATIVES)
    if constant_memory:
        return sorted([[n, 0, p, q, "fast", 4], [n, 0, p, q, "split", 1],
                       [n, 0, p, stack, "split", 1]])
    return sorted([[n, 0, p, q, "split", 7], [n, 0, p, stack, "split", 1]])


def expect_plan(rec, constant_memory, failures):
    if rec["k2_launches"] == 0:          # the CPU: the plain product only
        return
    want = plan(rec["n"], constant_memory)
    if rec["k2_products"] != want:
        failures.append(f"{rec['fit']}: K2 launches {rec['k2_products']}, "
                        f"expected {want}")


def gap(m, ref):
    """The constant-memory fit ``m`` against the progressive fit ``ref``
    of the same data: λ* rel, R² abs, AMEs of max|AME|, lastkeepers."""
    ame = np.asarray(ref.avgderivatives)
    return {"lambda_rel": abs(m.lambda_ - ref.lambda_) / abs(ref.lambda_),
            "R2_abs": abs(m.R2 - ref.R2),
            "ame_of_max": float(np.max(np.abs(m.avgderivatives - ame))
                                / np.max(np.abs(ame))),
            "lastkeeper": [m.lastkeeper, ref.lastkeeper]}


def check_part(n, dev, budget, failures, f64=False, fast_power=None):
    """The fit through K2 against the fit through the plain product; with
    ``f64`` each of them also against the same fit in float64 on the
    device (the plain product, the f32 fits' ``eig_iters=6``).
    ``fast_power`` is passed to every fit as ``fast_eig_power`` (None: the
    package's default). In the constant-memory flow λ* sits on the
    search's lower bound, which each fit sets from its own trailing
    eigenvalues: there each reference is refitted at the K2 fit's λ*
    (``lambda_=``), and the LOO errors are compared at that common λ
    (``bench.compare_fits(looe_ref_at_lambda=)``)."""
    from bigkrls_tpu_torch import bench, predict
    y, X = bench.streaming_data(n)
    constant_memory = budget is not None
    kw = {} if fast_power is None else {"fast_eig_power": fast_power}
    runs = [("auto", dict(kernel_impl="auto")),
            ("plain", dict(kernel_impl="plain"))]
    if f64:
        # at the f32 fits' Krylov depth (float64 defaults to 8)
        runs.append(("f64", dict(dtype=torch.float64, eig_iters=6)))
    fits, recs, preds = {}, [], {}
    for name, extra in runs:
        m, rec = timed_fit(f"N={n} {name}", y, X, dev, budget, **kw, **extra)
        fits[name], preds[name] = m, predict(m, X[:10], se_pred=True)
        recs.append(rec)
    if constant_memory:
        _, warm = timed_fit(f"N={n} auto, warm", y, X, dev, budget, **kw)
        recs.insert(1, warm)
    out = {"fits": recs}
    at = {}
    if constant_memory:
        out["looe_at_k2_lambda"] = {}
        for name, extra in runs[1:]:
            m_at, rec = timed_fit(f"N={n} {name} at the K2 fit's lambda", y,
                                  X, dev, budget, lambda_=fits["auto"].lambda_,
                                  **kw, **extra)
            at[name] = m_at.looe
            out["looe_at_k2_lambda"][name] = m_at.looe
            del m_at
    pairs = [("auto", "plain")] + ([("auto", "f64"), ("plain", "f64")]
                                   if f64 else [])
    for a, b in pairs:
        print(f"N={n}: the fit through {a} against the fit through {b}:",
              flush=True)
        bench.compare_fits(fits[a], fits[b], preds[a], preds[b], y,
                           failures, looe_ref_at_lambda=at.get(b)
                           if a == "auto" else None)
    if dev.type == "cuda" and recs[0]["k2_launches"] == 0:
        failures.append("the K2 fit launched no K2 kernel")
    if fast_power is None:
        expect_plan(recs[0], constant_memory, failures)
    m_k2 = fits["auto"]
    del fits, preds
    _free(dev)
    if constant_memory:
        m_prog, rec = timed_fit(f"N={n} progressive (the card's budget)",
                                y, X, dev)
        expect_plan(rec, False, failures)
        out["progressive"] = rec
        out["gap_to_progressive"] = gap(m_k2, m_prog)
        print(f"N={n} constant-memory vs progressive: "
              f"{json.dumps(out['gap_to_progressive'])}", flush=True)
    return out


def big_part(n, dev, budget, failures):
    from bigkrls_tpu_torch import bench
    y, X = bench.streaming_data(n)
    constant_memory = budget is not None
    _, big = timed_fit(f"N={n}", y, X, dev, budget)
    recs = [big]
    if constant_memory:
        _free(dev)
        recs.append(timed_fit(f"N={n} warm", y, X, dev, budget)[1])
    for rec in recs:
        ok = (np.isfinite(rec["R2"]) and np.isfinite(rec["lambda"])
              and rec["eig_path"] == "streaming-krylov")
        if not ok:
            failures.append(f"N={n} fit: {rec}")
        expect_plan(rec, constant_memory, failures)
    _free(dev)
    rows = end_rows(X, dev, failures, epilogue=constant_memory)
    return {"fits": recs, "end_rows": rows}


def auto_part(n, dev, failures):
    """The fit at ``n`` rows with the flow ``fit`` picks by itself, then
    summary and predict."""
    from bigkrls_tpu_torch import bench, predict, summary
    from bigkrls_tpu_torch.ops import kernels
    y, X = bench.streaming_data(n)
    m, rec = timed_fit(f"N={n} (flow picked by fit)", y, X, dev)
    expect_plan(rec, True, failures)
    k1 = kernels.gauss_tile_launches
    t0 = time.perf_counter()
    s = summary(m)
    t_summary = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = predict(m, X[:10], se_pred=True)
    t_predict = time.perf_counter() - t0
    rec.update(summary_s=t_summary, predict_s=t_predict,
               k1_launches_predict=kernels.gauss_tile_launches - k1,
               predicted=pred.predicted.tolist(),
               se_pred=pred.se_pred.tolist(),
               ame=np.asarray(m.avgderivatives).tolist())
    ok = (np.isfinite(m.R2) and np.all(np.isfinite(m.coeffs))
          and np.all(np.isfinite(m.derivatives))
          and s.ttests.shape == (len(bench.STREAM_DERIVATIVES), 4)
          and np.all(np.isfinite(pred.predicted))
          and np.all(np.isfinite(pred.se_pred)) and np.all(pred.se_pred > 0))
    print(f"N={n}: summary {t_summary:.3f} s, predict(10 rows, SEs) "
          f"{t_predict:.3f} s ({rec['k1_launches_predict']} K1 launch); "
          f"finite and of their shapes: {bool(ok)}", flush=True)
    print(summary(m), flush=True)
    if not ok:
        failures.append(f"N={n}: fit, summary or predict not finite")
    return {"fits": [rec]}


def end_rows(X, device, failures, epilogue: bool = False):
    """K2 at all of X's rows against the plain product of its first and
    last ``END_ROWS`` rows; precise, or (``epilogue``) fast with ``init``
    and ``out`` over it, as the constant-memory flow's recurrence step.
    Returns the errors and the product's ms."""
    from bigkrls_tpu_torch import bench
    from bigkrls_tpu_torch.ops import matvec
    dev = torch.device(device)
    n, p = X.shape
    Xd = torch.as_tensor((X - X.mean(0)) / X.std(0, ddof=1),
                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    V = torch.randn((n, bench.STREAM_Q), generator=gen, device=dev)
    idx = torch.cat([torch.arange(END_ROWS),
                     torch.arange(n - END_ROWS, n)]).to(dev)
    sigma, tol = float(p), bench.k2_tol(n)
    kw, scale, init_rows = {}, None, None
    if epilogue:
        init = torch.randn((n, bench.STREAM_Q), generator=gen, device=dev)
        init_rows, scale = init[idx].clone(), -2.5
        kw = dict(init=init, out=init, out_scale=scale, fast_accum=True)
    t0 = time.perf_counter()
    Y = matvec.kernel_matmul(Xd, V, sigma, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    Y = Y[idx]
    del kw
    rec = {"n": n, "ms": ms, "mode": "fast, init, out over init"
           if epilogue else "precise", "rows": 2 * END_ROWS}
    Xs = Xd[idx].contiguous()
    if epilogue:
        ref = matvec.kernel_matmul_plain(Xs, V, sigma, Xb=Xd,
                                         init=init_rows, out_scale=scale,
                                         fast_accum=True)
        top = ref.abs().max()
        err = ((Y - ref).abs().max() / top).item()
        emu = matvec.kernel_matmul_split_plain(
            Xs, V, sigma, Xb=Xd, init=init_rows, out_scale=scale, fast=True,
            block=8192)
        err_emu = ((Y - emu).abs().max() / top).item()
        # each of the three against the same rows in float64
        ref64 = matvec.kernel_matmul_plain(
            Xs.double(), V.double(), sigma, Xb=Xd.double(),
            init=init_rows.double(), out_scale=scale)
        vs64 = {name: ((t.double() - ref64).abs().max() / top).item()
                for name, t in (("k2_fast", Y), ("plain_tf32", ref),
                                ("tf32_emulation", emu))}
        rec.update(max_rel_err_vs_plain_tf32=err,
                   max_rel_err_vs_tf32_emulation=err_emu,
                   max_rel_err_vs_f64=vs64,
                   limit=bench.K2_FAST_TOL, precise_limit=tol)
        print(f"N={n} K2 fast product with the epilogue ({ms:.1f} ms): rows "
              f"0-{END_ROWS - 1} and {n - END_ROWS}-{n - 1}, max|d|/max|Y| "
              f"vs the plain product under TF32 {err:.3e}, vs its rounding "
              f"in plain f32 {err_emu:.3e} (limit {bench.K2_FAST_TOL:g}; "
              f"precise mode's k2_tol {tol:.1e}); each vs float64: "
              f"{json.dumps(vs64)}", flush=True)
        for what, e in (("plain TF32", err), ("TF32 emulation", err_emu)):
            if not e <= bench.K2_FAST_TOL:
                failures.append(f"N={n} K2 fast end rows vs {what}: {e} > "
                                f"{bench.K2_FAST_TOL}")
        return rec
    ref = matvec.kernel_matmul_plain(Xs, V, sigma, Xb=Xd)
    err = ((Y - ref).abs().max() / ref.abs().max()).item()
    rec.update(max_rel_err=err, limit=tol)
    print(f"N={n} K2 product ({ms:.1f} ms): rows 0-{END_ROWS - 1} and "
          f"{n - END_ROWS}-{n - 1} vs the plain product, max|d|/max|Y| "
          f"{err:.3e} (limit {tol:.1e})", flush=True)
    if not err <= tol:
        failures.append(f"N={n} K2 end rows: {err} > {tol}")
    return rec


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-n", type=int, default=500_000)
    ap.add_argument("--big-n", type=int, default=1_000_000)
    ap.add_argument("--auto-n", type=int, default=2_000_000)
    ap.add_argument("--constant-memory", action="store_true")
    ap.add_argument("--planning-budget", type=int, default=None,
                    help="bytes the forced constant-memory fits plan against "
                         "(default: bench.JAX_CHIP_BUDGET, 8 GiB); a small "
                         "one rehearses them at a small N")
    ap.add_argument("--only", choices=("check", "big", "auto"))
    ap.add_argument("--f64", action="store_true",
                    help="the check also holds both f32 fits against the "
                         "same fit in float64 on the device")
    ap.add_argument("--fast-eig-power", choices=("on", "off"),
                    help="fast_eig_power of the check's fits (default: "
                         "the package's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.only == "auto" and not args.constant_memory:
        ap.error("--only auto goes with --constant-memory")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("scale_fits: no CUDA device", file=sys.stderr)
        return 1
    from bigkrls_tpu_torch import bench
    from bigkrls_tpu_torch.ops import _build
    info = bench.card(dev)
    print(f"{info['card']}, {info['power_limit']}; torch {info['torch']}, "
          f"CUDA {info['cuda']}", flush=True)
    if dev.type == "cuda":
        _build.library()
        print(f"kernel library build {_build.last_build_seconds:.1f} s",
              flush=True)

    cm = args.constant_memory
    budget = None
    if cm:
        budget = args.planning_budget or bench.JAX_CHIP_BUDGET
    parts = [args.only] if args.only else (
        ["check", "big", "auto"] if cm else ["check", "big"])
    failures, result = [], {"card": info, "constant_memory": cm}
    for part in parts:
        if part == "check":
            fast = {None: None, "on": True, "off": False}[
                args.fast_eig_power]
            result["check"] = check_part(args.check_n, dev, budget, failures,
                                         f64=args.f64, fast_power=fast)
        elif part == "big":
            result["big"] = big_part(args.big_n, dev, budget, failures)
        else:
            result["auto"] = auto_part(args.auto_n, dev, failures)
        _free(dev)
    result["failures"] = failures
    print(json.dumps(result), flush=True)
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
