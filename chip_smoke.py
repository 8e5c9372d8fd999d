#!/usr/bin/env python3
"""Drive the PyTorch port (``bigkrls_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions; exits non-zero without a CUDA device;
2. builds the CUDA kernels from ``bigkrls_tpu_torch/csrc`` and prints the
   build time;
3. holds the Gaussian tile kernel (K1) against its plain PyTorch version
   on the card at the fit's and predict's shapes (max |Δ| ≤ 1e-5 in f32,
   bit-symmetric, exact diagonal), and against the frozen first design of
   the kernel (``tools/gauss_kernel_first.cu``, built here as an oracle):
   the same bits at every shape and three bandwidths; times the two side
   by side (first / new / new / first, single launches, 20 in a loop, and
   a replayed CUDA graph of 20) and the plain version;
4. runs the default ``fit`` at N=3106, P=67 (the election data's width)
   on a seeded low-rank design whose kernel spectrum decays like the
   election data's, so the fit takes the adaptive route through K1; then
   ``summary`` and ``predict(se_pred=True)``; checks the launch count, and
   holds the result against the port's own float64 fit on the CPU; then
   the golden-section λ search as a device loop on that data: a warm fit
   with every chunk of the loop under ``set_sync_debug_mode("error")``,
   the synchronising calls of one warm fit with the device loop and with
   the host loop in its place (the golden loop's at most ⌈iterations /
   T⌉ + 1), the two loops on the fit's own basis (λ* within 1e-6, both
   within §2 of the CPU fit), the adaptive region's time each way, and
   the bench's three post-kernel metrics (min and median of 9;
   ``tools/golden_loop.py``);
5. holds the kernel-free product kernel (K2) against its plain PyTorch
   version on the card at the streaming fit's shapes and at ragged ones:
   precise mode (the split-TF32 tensor-core product), the
   ``init``/``out_scale`` epilogue, ``out`` aliasing ``init``, fast (TF32)
   mode, and once against ``gauss_tile(X, X) @ V``. Precise mode must pass
   a gate at every shape: (a) inside ``k2_tol`` of the plain f32 version,
   and (b) no further from the plain version in float64 than twice the
   kernel's IEEE fp32 FMA pass is; both errors are printed. The plain
   emulation of the split (``kernel_matmul_split_plain``) is held against
   the kernel too;
6. runs the streaming fit at N=50,000, P=20, ``neig=500`` (the route is
   chosen by size, K is never built), checks the K2 launch count and the
   widths of its products, then ``summary``, ``predict(se_pred=True)`` and
   ``vcov_fitted_diag``; holds the result against the same fit through the
   plain product (f32) and in float64, both on the card;
7. holds a streaming fit against the dense subspace fit at N=8192 (and
   prints its gap to the adaptive route's fit of the same data), and the
   constant-memory Chebyshev eigensolver (fast K2 and its epilogue)
   against its plain run and against a dense ``eigvalsh``; checks that
   ``fit`` takes the constant-memory flow by itself at N=2,000,000 on this
   card; then runs that flow through ``fit`` at N=200,000 under the JAX
   chip's 8 GiB planning budget (``bench.planning_budget``): its 6 K2
   launches by shape and mode (4 fast, 2 of them through the
   ``init``/``out`` epilogue), ``summary`` and ``predict``, held against
   the same fit through the plain product (the LOO errors at a common λ:
   λ* sits on the search's lower bound, set by each fit's trailing
   eigenvalues) and printed beside the
   progressive flow's fit of the same data; and holds K2's cross entry in
   fast mode with ``init`` and ``out`` over it at 2,000,000 output rows
   (byte offsets past 2³¹) against its plain version on every row, the
   aliased call bit-equal to the unaliased one; and holds fast mode over a
   sum of 1,000,000 products (the cross entry, 512 rows) to a gate: no
   further from float64 than twice the same TF32 rounding with IEEE sums;
8. runs the workflows on the card: the census replication protocol
   ``crossvalidate(ptesting=20, neig=50)`` for three seeds (stepwise
   route) and 5-fold CV (fused route) at N=3106, P=67, each held against
   the port's CPU float64 run; ``save_model``/``load_model`` of the dense
   and the streaming model and of a CV object, with predictions after the
   round trip bit-equal; checkpoint and resume of the dense adaptive fit
   and of the N=50,000 streaming fit (the native store, one K2 launch on
   the resume, λ* and coefficients bit-equal); the command line as
   subprocesses; a ``trace_dir`` trace that names K1;
9. the mesh phase (``parallel/``), every mesh of virtual shards of the one
   card: K2's cross entry (one ring step) against its plain version at a
   ring step of the N=50,000 fit, a ragged shape and in fast mode, with the
   square entry bit-equal to the cross entry with Xa = Xb, timed beside its
   bound; the N=50,000 streaming fit over a ring of 4 shards (16 K2 cross
   launches a product) held against the single-device streaming fit; the
   default fit at N=3106, P=67 over a 2×2 mesh (the adaptive route, one K1
   launch per block) held against the single-device fit; both mesh fits
   under the gather log (``parallel/sharded.record_gathers``): no N×N
   object and no N-row object off ``GATHER_ALLOWED`` may be gathered, and
   their warm times and peak memory are printed beside a single-device
   warm fit's of the same run; a full-spectrum fit by block Jacobi at
   N=1024 held against the gathered ``eigh``; a one-rank NCCL process
   group, joined once with explicit arguments and once through a
   launcher's environment (``LOCAL_RANK=0``, ``LOCAL_WORLD_SIZE=1``,
   ``env://``); where the machine has 2 or more cards, the N=3106 fit
   over a mesh of distinct cards (one K1 launch on each), held against
   the single-device fit and compared bit for bit with the same fit over
   virtual shards;
10. holds K2 against its plain version at the shapes the benchmark's
    run below gives it and ``check_k2`` does not (N=100,000 at m=540 and
    22, the fast-power fit's 3780-wide Ritz product); then runs the port's
    benchmark, ``python -m bigkrls_tpu_torch bench``, as a subprocess with
    ``BENCH_BUDGET_S=240`` (everything through N=100,000 and the
    fast-power fit; the N=500,000 and N=1,000,000 parts give ``skipped``
    records): every metric name of root ``bench.py``, no ``failed``
    record and none that needed a retry, the primary last, the card's
    name in every record, the N=50,000 and N=100,000 R² the JAX bench's
    to three digits, each streaming fit's K2 launches (8, 6 of them fast
    in the fast-power fit) and the N=100,000 product's own check against
    the plain product;
11. prints one JSON line for the kernels (with the cards each ran on),
    then the result line.

Any failed check exits non-zero without the result line. No JAX is used.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bigkrls_tpu_torch.bench import (K2_FAST_TOL, METRICS, N, P, PRIMARY,
                                     SEED, TOL_LAMBDA_REL, k1_bound_ms,
                                     k2_bound_ms, k2_cross_bound_ms, k2_tol,
                                     rel, smoke_data)
from bigkrls_tpu_torch.bench import compare_fits as compare
from bigkrls_tpu_torch.bench import streaming_data as bench_streaming_data

# K1 shapes (M, N, P, symmetric): the fit's kernel, ragged and wide-N
# symmetric cases, and predict's cross-kernel shape
K1_SHAPES = [(N, N, P, True), (1000, 1000, 5, True), (4097, 4097, 3, True),
             (16384, 16384, 20, True), (517, N, P, False)]
K1_TOL = 1e-5   # f32 rank-P cancellation at r ≈ P, damped by exp()
# beside sigma = P, the bandwidths at which K1 must reproduce the bits of
# its frozen first design (tools/gauss_kernel_first.cu)
K1_SIGMAS = (0.7131, 1e-3)
# (M, N, P, same rows, symmetric_diag), for the bit comparison only
K1_BIT_SHAPES = [(130, 130, 200, True, True), (1, 70, 2, False, False),
                 (N, N, P, True, False)]

# The data recipes, the H100's peaks, the kernels' bounds and the
# end-to-end limits of a card fit against its reference fit (``compare``)
# are the port's benchmark's (``bigkrls_tpu_torch/bench.py``).


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def looped_ms(fn, reps: int = 20) -> float:
    """``reps`` launches inside one pair of events, per launch: the larger
    of the host's and the device's time per call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """``reps`` launches captured into one CUDA graph and replayed, per
    launch: the device's time without the host's share of a call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_operands(m, n, p, sym, X_std, gen):
    if (m, n, p) == (N, N, P):
        A = X_std
    else:
        A = torch.randn((m, p), generator=gen, device="cuda")
    B = A if sym else torch.randn((n, p), generator=gen, device="cuda")
    if (m, n, p) == (517, N, P):
        B = X_std
    return A, B


def check_k1(X_std, k1_first, failures):
    """K1 vs its plain version at every shape, and vs ``k1_first``, the
    frozen first design of the kernel: bit-equal, and timed side by side
    (first / new / new / first). Returns the numbers of the kernels line."""
    from bigkrls_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst, out = 0.0, {}
    for m, n, p, sym in K1_SHAPES:
        A, B = k1_operands(m, n, p, sym, X_std, gen)
        sigma = float(p)
        K = kernels.gauss_tile(A, B, sigma, sym)
        ref = kernels.gauss_tile_plain(A, B, sigma, sym)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(K - ref)).item()
        worst = max(worst, err)
        sym_ok = (not sym) or (torch.equal(K, K.T)
                               and bool(torch.all(torch.diagonal(K) == 1.0)))
        del ref
        bits = {s: torch.equal(kernels.gauss_tile(A, B, s, sym),
                               k1_first(A, B, s, sym))
                for s in (sigma, *K1_SIGMAS)}
        del K

        def new():
            return kernels.gauss_tile(A, B, sigma, sym)

        def first():
            return k1_first(A, B, sigma, sym)

        t = [cuda_ms(first), cuda_ms(new), cuda_ms(new), cuda_ms(first)]
        t_p = cuda_ms(lambda: kernels.gauss_tile_plain(A, B, sigma, sym))
        loop, loop_first = looped_ms(new), looped_ms(first)
        dev, dev_first = graph_ms(new), graph_ms(first)
        bound, by = k1_bound_ms(m, n, p)
        print(f"K1 ({m},{n},P={p},sym={sym}): max|d|={err:.3e} vs plain, "
              f"symmetric/diag ok={sym_ok}, bit-equal to the first design at "
              f"sigma {list(bits)}: {all(bits.values())}; single launches "
              f"first/new/new/first {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / "
              f"{t[3]:.4f} ms; looped new {loop:.4f}, first {loop_first:.4f}; "
              f"graph new {dev:.4f}, first {dev_first:.4f}; plain {t_p:.4f} "
              f"ms; bound {bound:.4f} ms ({by})", flush=True)
        if not err <= K1_TOL:
            failures.append(f"K1 {m}x{n} P={p}: max|d| {err} > {K1_TOL}")
        if not sym_ok:
            failures.append(f"K1 {m}x{n} P={p}: not bit-symmetric with "
                            "an exact diagonal")
        if not all(bits.values()):
            failures.append(f"K1 {m}x{n} P={p}: differs from the first "
                            f"design's bits at sigma "
                            f"{[s for s, ok in bits.items() if not ok]}")
        if (m, n, p, sym) == (N, N, P, True):
            out.update(ms=(t[1] + t[2]) / 2, ms_pr3=(t[0] + t[3]) / 2,
                       plain_ms=t_p, bound_ms=bound, bound_by=by,
                       ms_looped=loop, ms_looped_pr3=loop_first,
                       ms_graph=dev, ms_graph_pr3=dev_first)
        if (m, n, p) == (16384, 16384, 20):
            out.update(ms_16384_20=(t[1] + t[2]) / 2,
                       ms_pr3_16384_20=(t[0] + t[3]) / 2,
                       ms_graph_16384_20=dev, bound_ms_16384_20=bound)
        del A, B

    # shapes past the fit's: a wide P in slices, a one-row cross call, and
    # the same rows without the exact-1 diagonal (the diagonal is computed)
    for m, n, p, sym, diag in K1_BIT_SHAPES:
        A, B = k1_operands(m, n, p, sym, X_std, gen)
        bits = {s: torch.equal(kernels.gauss_tile(A, B, s, diag),
                               k1_first(A, B, s, diag))
                for s in (float(p), *K1_SIGMAS)}
        print(f"K1 ({m},{n},P={p},same rows={sym},diag={diag}): bit-equal "
              f"to the first design at sigma {list(bits)}: "
              f"{all(bits.values())}", flush=True)
        if not all(bits.values()):
            failures.append(f"K1 {m}x{n} P={p} diag={diag}: differs from "
                            "the first design's bits")
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# K2 and the streaming slice
# ---------------------------------------------------------------------------

SN, SP, SNEIG = 50_000, 20, 500        # the streaming fit
SQ = SNEIG + 40                        # its Krylov block width
# K2 shapes (N, P, m): the fit's power block, its derivatives stack
# (2 + 4·5 columns) and a single column; ragged N, P and m; an m several
# m-tiles wide
K2_SHAPES = [(SN, SP, SQ), (SN, SP, 22), (SN, SP, 1), (4097, 3, 5),
             (1000, 67, 130), (8192, 20, 1100)]




def streaming_data(n: int):
    """The JAX bench's 50k streaming recipe (iid normal X, y = sin(x₀) +
    0.2·ΣX + noise, seed 2016), with column 4 made binary afterwards so
    that the first-difference half of the derivatives product runs."""
    y, X = bench_streaming_data(n, SP)
    X[:, 4] = (X[:, 4] > 0)
    return y, X


# the split's |Δ| per tile entry against the IEEE tile, relative: hi + lo
# keeps 21 of the entry's 24 mantissa bits
SPLIT_TILE_REL = 2.0 ** -21


def check_k2(failures):
    """K2 vs its plain version at every shape, with the gate that lets the
    split-TF32 product be precise mode; returns the numbers of the fit's
    power-block shape for the kernels line."""
    from bigkrls_tpu_torch.ops import kernels, matvec
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {}
    print("K2 precise mode: split-TF32 (3 tensor-core passes, mma.sync "
          "m16n8k8; m=540 runs as pairs of 320-wide blocks); gate (a) vs plain f32 within k2_tol, (b) error vs "
          "plain f64 no more than twice the IEEE-FMA pass's")
    for n, p, m in K2_SHAPES:
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        init = torch.randn((n, m), generator=gen, device="cuda")
        sigma, tol = float(p), k2_tol(n)
        Y = matvec.kernel_matmul(X, V, sigma)
        ref = matvec.kernel_matmul_plain(X, V, sigma)
        ref64 = matvec.kernel_matmul_plain(X.double(), V.double(), sigma)
        Yfma = matvec._kernel_matmul_cuda(X, V, sigma, None, None, False,
                                          None, mode="fma")
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (Y - ref).abs().max().item()
        err64 = (Y - ref64).abs().max().item() / scale
        fma64 = (Yfma - ref64).abs().max().item() / scale
        fma32 = (Yfma - ref).abs().max().item() / scale
        del ref64, Yfma
        # the epilogue, and out aliasing init (same bits as the unaliased run)
        Ye = matvec.kernel_matmul(X, V, sigma, init=init, out_scale=-2.5)
        ref_e = matvec.kernel_matmul_plain(X, V, sigma, init=init,
                                           out_scale=-2.5)
        err_e = (Ye - ref_e).abs().max().item() / ref_e.abs().max().item()
        buf = init.clone()
        Ya = matvec.kernel_matmul(X, V, sigma, init=buf, out_scale=-2.5,
                                  out=buf)
        alias_ok = Ya.data_ptr() == buf.data_ptr() and torch.equal(Ya, Ye)
        big = n >= 8192
        reps, warm = (5, 1) if big else (20, 3)
        if (n, p, m) == (SN, SP, SQ):
            reps, warm = 20, 2
        t_k = cuda_ms(lambda: matvec.kernel_matmul(X, V, sigma), reps, warm)
        t_p = cuda_ms(lambda: matvec.kernel_matmul_plain(X, V, sigma), reps,
                      warm)
        print(f"K2 ({n},P={p},m={m}): gate (a) max|d|/max|Y| vs plain f32 "
              f"{err / scale:.3e} (limit {tol:.1e}; IEEE-FMA pass "
              f"{fma32:.3e}); gate (b) vs plain f64: split {err64:.3e}, "
              f"IEEE-FMA pass {fma64:.3e}; epilogue {err_e:.3e}, alias ok="
              f"{alias_ok}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
              flush=True)
        if not err <= tol * scale:
            failures.append(f"K2 ({n},{p},{m}) gate (a): {err / scale} > "
                            f"{tol}")
        if not err64 <= 2 * fma64:
            failures.append(f"K2 ({n},{p},{m}) gate (b): split {err64} vs "
                            f"f64 > 2 x the IEEE-FMA pass's {fma64}")
        if not err_e <= tol:
            failures.append(f"K2 ({n},{p},{m}) epilogue: {err_e} > {tol}")
        if not alias_ok:
            failures.append(f"K2 ({n},{p},{m}): out aliasing init differs")
        if (n, p, m) == (SN, SP, SQ):
            bound, by = k2_bound_ms(n, p, m, "split")
            t_fma = cuda_ms(lambda: matvec._kernel_matmul_cuda(
                X, V, sigma, None, None, False, None, mode="fma"), 5, 1)
            out.update(max_abs_err=err, max_rel_err=err / scale, ms=t_k,
                       plain_ms=t_p, bound_ms=bound, bound_by=by,
                       precise_mode="split-tf32", err_vs_f64=err64,
                       fma_err_vs_f64=fma64, fma_ms=t_fma,
                       fma_bound_ms=k2_bound_ms(n, p, m, "fma")[0])
            # fast mode against the plain version under TF32
            Yf = matvec.kernel_matmul(X, V, sigma, fast_accum=True)
            ref_f = matvec.kernel_matmul_plain(X, V, sigma, fast_accum=True)
            torch.cuda.synchronize()
            err_f = (Yf - ref_f).abs().max().item()
            t_kf = cuda_ms(lambda: matvec.kernel_matmul(
                X, V, sigma, fast_accum=True), reps, warm)
            t_pf = cuda_ms(lambda: matvec.kernel_matmul_plain(
                X, V, sigma, fast_accum=True), reps, warm)
            print(f"K2 fast ({n},P={p},m={m}): max|d|/max|Y|="
                  f"{err_f / scale:.3e} (limit {K2_FAST_TOL:g}); vs precise "
                  f"{(Yf - Y).abs().max().item() / scale:.3e}; kernel "
                  f"{t_kf:.4f} ms, plain {t_pf:.4f} ms; IEEE-FMA pass "
                  f"{t_fma:.4f} ms", flush=True)
            if not err_f <= K2_FAST_TOL * scale:
                failures.append(f"K2 fast: {err_f / scale} > {K2_FAST_TOL}")
            out.update(fast_max_abs_err=err_f, fast_ms=t_kf,
                       fast_plain_ms=t_pf,
                       fast_bound_ms=k2_bound_ms(n, p, m, "fast")[0])
            del Yf, ref_f
        del X, V, init, Y, ref, Ye, ref_e, buf, Ya

    # against the dense kernel: on the IEEE-FMA pass K2's on-chip tile is
    # K1's tile bit for bit (unit columns of V pick entries of K out
    # unchanged); the split's hi + lo keeps each entry to 2^-21 relative;
    # K2(X, V) agrees with gauss_tile(X, X) @ V like with the plain
    # version; and the plain emulation of the split agrees with the kernel
    # to the rounding of two differently ordered f32 sums
    n = 8192
    X = torch.randn((n, SP), generator=gen, device="cuda")
    V = torch.randn((n, 64), generator=gen, device="cuda")
    K = kernels.gauss_tile(X, X, float(SP), False)
    E = torch.zeros((n, 64), device="cuda")
    E[torch.arange(64), torch.arange(64)] = 1.0
    bit_ok = torch.equal(matvec._kernel_matmul_cuda(
        X, E, float(SP), None, None, False, None, mode="fma"), K[:, :64])
    tile_rel = ((matvec.kernel_matmul(X, E, float(SP)) - K[:, :64]).abs()
                / K[:, :64]).max().item()
    ref = K @ V
    Y = matvec.kernel_matmul(X, V, float(SP))
    err = (Y - ref).abs().max().item() / ref.abs().max().item()
    emu = matvec.kernel_matmul_split_plain(X, V, float(SP))
    err_emu = (Y - emu).abs().max().item() / ref.abs().max().item()
    print(f"K2 vs gauss_tile(X,X) @ V at N={n}: {err:.3e} (limit "
          f"{k2_tol(n):.1e}); vs its plain emulation {err_emu:.3e}; tile "
          f"bit-equal to K1's on the IEEE-FMA pass: {bit_ok}; split tile "
          f"max rel |d| {tile_rel:.3e} (limit 2^-21 = {SPLIT_TILE_REL:.3e})",
          flush=True)
    if not err <= k2_tol(n):
        failures.append(f"K2 vs K1 @ V: {err} > {k2_tol(n)}")
    if not err_emu <= k2_tol(n):
        failures.append(f"K2 vs its plain emulation: {err_emu} > {k2_tol(n)}")
    if not bit_ok:
        failures.append("K2's IEEE-FMA tile differs from K1's")
    if not tile_rel <= SPLIT_TILE_REL:
        failures.append(f"K2's split tile is {tile_rel} from K1's, over "
                        f"{SPLIT_TILE_REL}")
    return out


class Counts:
    """Set the kernels' launch counters to 0, read them later."""

    def __init__(self):
        from bigkrls_tpu_torch.ops import kernels, matvec
        self.k, self.m = kernels, matvec
        kernels.gauss_tile_launches = 0
        matvec.kernel_matmul_launches = 0
        matvec.kernel_matmul_fast_launches = 0
        matvec.kernel_matmul_cross_launches = 0

    def cross(self):
        return self.m.kernel_matmul_cross_launches

    def read(self):
        return (self.k.gauss_tile_launches, self.m.kernel_matmul_launches,
                self.m.kernel_matmul_fast_launches)


def streaming_phase(bt, failures):
    """The slice at full size. Returns K2's launch count in the fit."""
    from bigkrls_tpu_torch.ops import matvec
    y, X = streaming_data(SN)
    kw = dict(neig=SNEIG, which_derivatives=[0, 1, 2, 3, 4], device="cuda")

    # record the width of every product the fit asks for
    widths, real = [], matvec.kernel_matmul

    def recording(Xa, V, sigma, **k):
        widths.append(int(V.shape[1]))
        return real(Xa, V, sigma, **k)

    counts = Counts()
    matvec.kernel_matmul = recording
    try:
        t0 = time.perf_counter()
        m = bt.fit(y, X, **kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        matvec.kernel_matmul = real
    _, k2_fit, k2_fast = counts.read()
    print(f"cold streaming fit N={SN} P={SP} neig={SNEIG}: {fit_s:.3f} s, "
          f"eig_path {m.eig_path}, K is None: {m.K is None}, lambda "
          f"{m.lambda_:.6g}, lastkeeper {m.lastkeeper}, Neff "
          f"{m.neffective:.4f}, R2 {m.R2:.6f}; K2 launches {k2_fit} "
          f"(fast {k2_fast}), product widths {widths}", flush=True)
    if m.eig_path != "streaming-krylov" or m.K is not None:
        failures.append(f"N={SN} fit took {m.eig_path!r} (K stored: "
                        f"{m.K is not None}), not the streaming route")
    # progressive flow at f32: 6 power products and the last block's Ritz
    # product (width q each), then the derivatives stack (2 + 4·5), which
    # also yields ŷ: no width-1 product
    if widths != [SQ] * 7 + [22] or k2_fit != 8 or k2_fast != 0:
        failures.append(f"streaming fit: K2 launches {k2_fit} (fast "
                        f"{k2_fast}), widths {widths}; expected 8 precise "
                        f"launches of widths {[SQ] * 7 + [22]}")
    s = bt.summary(m)
    pred = bt.predict(m, X[:10], se_pred=True)
    vdiag = m.vcov_fitted_diag()
    k1_s, k2_s, _ = counts.read()
    ok = (np.all(np.isfinite(m.coeffs)) and m.coeffs.shape == (SN,)
          and m.derivatives.shape == (SN, 5)
          and np.all(np.isfinite(m.derivatives))
          and np.all(np.isfinite(pred.predicted))
          and np.all(np.isfinite(pred.se_pred)) and np.all(pred.se_pred > 0)
          and s.ttests.shape == (5, 4) and s.labels[4].endswith("*")
          and vdiag.shape == (SN,) and bool(torch.isfinite(vdiag).all())
          and bool((vdiag > 0).all())
          and k1_s == 1 and k2_s == k2_fit + 1)
    print(f"summary, predict(10 rows, SEs), vcov_fitted_diag: ok={ok}; K1 "
          f"launches {k1_s} (predict), K2 launches {k2_s} (fit + "
          f"vcov_fitted_diag)")
    if not ok:
        failures.append("streaming fit/summary/predict/vcov_fitted_diag "
                        "outputs not finite, of the wrong shape, or not "
                        "through the kernels")

    t0 = time.perf_counter()
    m_warm = bt.fit(y, X, noisy=False, **kw)
    warm_s = time.perf_counter() - t0
    print(f"warm streaming fit: {warm_s:.3f} s, timings "
          f"{json.dumps(m_warm.timings)}")
    print(f"peak device memory so far: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    t0 = time.perf_counter()
    m_plain = bt.fit(y, X, noisy=False, kernel_impl="plain", **kw)
    pred_plain = bt.predict(m_plain, X[:10], se_pred=True)
    print(f"same fit, plain product (f32): {time.perf_counter() - t0:.3f} s, "
          f"timings {json.dumps(m_plain.timings)}")
    print("card f32 K2 vs card f32 plain product:")
    compare(m, m_plain, pred, pred_plain, y, failures)

    t0 = time.perf_counter()
    m64 = bt.fit(y, X, noisy=False, dtype=torch.float64, **kw)
    pred64 = bt.predict(m64, X[:10], se_pred=True)
    print(f"same fit, float64 on the card (plain product): "
          f"{time.perf_counter() - t0:.2f} s, timings "
          f"{json.dumps(m64.timings)}")
    print("card f32 K2 vs card f64:")
    compare(m, m64, pred, pred64, y, failures)
    del m_plain, m64, m_warm
    torch.cuda.empty_cache()
    return k2_fit, m, warm_s


def streaming_vs_dense(bt, failures):
    """fit(streaming=True) against the dense subspace fit, same neig and
    the same Krylov depth (the dense solver's 8), both f32 on the card."""
    n, k = 8192, 200
    y, X = streaming_data(n)
    kw = dict(neig=k, which_derivatives=[0, 1, 2, 3, 4], device="cuda",
              noisy=False)
    ms = bt.fit(y, X, streaming=True, eig_iters=8, **kw)
    md = bt.fit(y, X, eig_method="subspace", **kw)
    print(f"N={n} neig={k}: streaming ({ms.eig_path}, K is None: "
          f"{ms.K is None}) vs dense ({md.eig_path}): lambda "
          f"{ms.lambda_:.6g} / {md.lambda_:.6g}, Neff {ms.neffective:.4f} / "
          f"{md.neffective:.4f}")
    compare(ms, md, bt.predict(ms, X[:10], se_pred=True),
            bt.predict(md, X[:10], se_pred=True), y, failures)
    if ms.K is not None or md.K is None:
        failures.append("streaming vs dense: wrong routes")
    # the default dense route on the same data, beside the streaming fit:
    # the two routes' λ bounds differ (streaming takes L from its neig
    # values alone), so the gap is printed, not held to a limit
    ma = bt.fit(y, X, eig_method="adaptive", device="cuda", noisy=False,
                which_derivatives=[0, 1, 2, 3, 4])
    ame = float(np.max(np.abs(ms.avgderivatives - ma.avgderivatives))
                / np.max(np.abs(ma.avgderivatives)))
    print(f"  the same data on the adaptive route ({ma.eig_path}): lambda "
          f"{ma.lambda_:.6g}, lastkeeper {ma.lastkeeper}, R2 {ma.R2:.6f}; "
          f"gap to streaming: lambda rel {rel(ms.lambda_, ma.lambda_):.3e}, "
          f"AME / max|AME| {ame:.3e}, R2 abs {abs(ms.R2 - ma.R2):.3e}")
    if not (np.isfinite(ma.lambda_) and np.all(np.isfinite(ma.coeffs))):
        failures.append("streaming vs dense: the adaptive fit is not finite")


# Chebyshev flow, top-neig eigenvalues. Against its plain run, of λ₁: the
# same flow with TF32 power products rounded differently; the Ritz product
# is full precision on both sides, so the values differ only by the
# subspaces' TF32-level difference entering at second order. Against dense
# eigvalsh, relative: 4 filter products leave the tail of the 200 values
# partly unconverged (1.4e-4 at this shape when this limit was set; the
# JAX suite allows 0.15 for this flow on a slower-decaying spectrum); the
# top 20 are converged to f32 rounding.
CHEB_VS_PLAIN = 1e-5
CHEB_VS_DENSE_MAXREL = 5e-3
CHEB_HEAD_REL = 1e-4


def chebyshev_phase(failures):
    """The constant-memory flow through fast K2 and its fused epilogue."""
    from bigkrls_tpu_torch.ops import eig, kernels, matvec
    n, k = 8192, 200
    _, X = streaming_data(n)
    Xd = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    X_std = ((Xd - Xd.mean(0)) / Xd.std(0, correction=1)).contiguous()
    sigma = float(SP)
    counts = Counts()
    e = eig.eigensystem_streaming(X_std, sigma, neig=k, iters=6, krylov=False)
    _, launches, fast = counts.read()
    e_plain = eig.eigensystem_streaming(X_std, sigma, neig=k, iters=6,
                                        krylov=False, impl="plain")
    dense = torch.linalg.eigvalsh(
        kernels.gauss_tile(X_std, X_std, sigma, True)).flip(0)[:k]
    v, vp = e.values_full, e_plain.values_full
    lam1 = dense[0].item()
    d_plain = (v - vp).abs().max().item() / lam1
    d_rel = ((v - dense).abs() / dense).max().item()
    d_head = ((v[:20] - dense[:20]).abs() / dense[:20]).max().item()
    print(f"Chebyshev flow N={n} neig={k}: K2 launches {launches} (fast "
          f"{fast}); vs plain run {d_plain:.3e} of lambda_1 (limit "
          f"{CHEB_VS_PLAIN:g}); vs dense eigvalsh max-rel {d_rel:.3e} "
          f"(limit {CHEB_VS_DENSE_MAXREL:g}), top-20 {d_head:.3e} (limit "
          f"{CHEB_HEAD_REL:g})", flush=True)
    # 4 filter products in fast mode, then the full-precision Ritz product
    if (launches, fast) != (5, 4):
        failures.append(f"Chebyshev flow: K2 launches {launches}, fast "
                        f"{fast}; expected 5 and 4")
    if not (d_plain <= CHEB_VS_PLAIN and d_rel <= CHEB_VS_DENSE_MAXREL
            and d_head <= CHEB_HEAD_REL):
        failures.append(f"Chebyshev flow eigenvalues: vs plain {d_plain}, "
                        f"vs dense {d_rel}, head {d_head}")

    # which flow fit() picks by itself on this card
    total = torch.cuda.mem_get_info()[1]
    flip = next(nn for nn in range(100_000, 10_000_001, 100_000)
                if 2 * nn * 7 * SQ * 4 > 0.6 * total)
    picks_1m = eig._auto_krylov(1_000_000, SQ, 6, 4, device="cuda")
    print(f"_auto_krylov on this card ({total / 2**30:.1f} GiB): at N=1M, "
          f"neig={SNEIG}, f32 the basis needs "
          f"{2 * 1_000_000 * 7 * SQ * 4 / 2**30:.1f} GiB -> block-Krylov: "
          f"{picks_1m}; the constant-memory flow is first chosen at "
          f"N={flip}")
    if not picks_1m:
        failures.append("_auto_krylov: expected block-Krylov at N=1M")
    picks_2m = eig._auto_krylov(2_000_000, SQ, 6, 4, device="cuda")
    print(f"_auto_krylov at N=2M ({2 * 2_000_000 * 7 * SQ * 4 / 2**30:.1f} "
          f"GiB of basis): block-Krylov {picks_2m}, so a fit there takes the "
          f"constant-memory flow by itself")
    if picks_2m:
        failures.append("_auto_krylov: expected the constant-memory flow at "
                        "N=2M")


# the constant-memory fit: N rows under the JAX chip's planning budget,
# where fit() takes that flow by itself
CM_N = 200_000
# and its K2 launches by (N, Nb, P, m, mode): two Chebyshev applications of
# degree 2 (a start product, then a recurrence step through the init/out
# epilogue), all fast; the precise Ritz product; the derivatives' product
# (2 + 4·5 columns), which also gives ŷ
CM_PLAN = {(CM_N, 0, SP, SQ, "fast"): 4, (CM_N, 0, SP, SQ, "split"): 1,
           (CM_N, 0, SP, 22, "split"): 1}
# the progressive flow on the same data: 6 power products and the last
# block's Ritz product, precise, then the derivatives' product
PROGRESSIVE_PLAN = {(CM_N, 0, SP, SQ, "split"): 7,
                    (CM_N, 0, SP, 22, "split"): 1}
# K2's cross entry with an output whose byte offsets pass 2^31 (from row
# 2^31 / (4·m) = 994,205 at m = 540): (Na, Nb, P, m), fast mode, init given
# and out over it, as the recurrence step runs
CM_EPILOGUE = (2_000_000, 2048, SP, SQ)


def constant_memory_phase(bt, failures):
    """The constant-memory (Chebyshev) streaming fit through ``fit()`` at
    N=200,000 under the JAX chip's 8 GiB planning budget
    (``bench.planning_budget``, restored after): its 6 K2 launches, summary
    and predict, the same flow through the plain product within PERF.md
    §2's limits (the LOO errors at a common λ), and the gap to the
    progressive flow on the same data (the card's own budget). Returns
    the numbers for the kernels line."""
    from bigkrls_tpu_torch import bench, lambda_search
    from bigkrls_tpu_torch.ops import eig, matvec
    y, X = bench_streaming_data(CM_N, SP)
    kw = dict(neig=SNEIG, which_derivatives=[0, 1, 2, 3, 4], device="cuda")
    orth = eig.block_orth_counts.copy()
    with bench.planning_budget(bench.JAX_CHIP_BUDGET):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = Counts()
        before = matvec.kernel_matmul_shapes.copy()
        t0 = time.perf_counter()
        m = bt.fit(y, X, noisy=False, **kw)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launched = dict(matvec.kernel_matmul_shapes - before)
        s = bt.summary(m)
        pred = bt.predict(m, X[:10], se_pred=True)
        k1, k2, k2_fast = counts.read()
        taken = dict(eig.block_orth_counts - orth)
        _, warm_s, _ = warm_fit(bt, y, X, **kw)
        t0 = time.perf_counter()
        m_plain = bt.fit(y, X, noisy=False, kernel_impl="plain", **kw)
        plain_s = time.perf_counter() - t0
        pred_plain = bt.predict(m_plain, X[:10], se_pred=True)
        # λ* sits on the search's lower bound L, which each fit sets from
        # its own trailing eigenvalues: the LOO errors are compared at the
        # K2 fit's λ*, the λ*s apart by the λ check
        looe_at = bt.fit(y, X, noisy=False, kernel_impl="plain",
                         lambda_=m.lambda_, **kw).looe
    print(f"constant-memory fit N={CM_N} P={SP} neig={SNEIG} (planning "
          f"budget {bench.JAX_CHIP_BUDGET / 2**30:.0f} GiB): cold {cold_s:.3f}"
          f" s, warm {warm_s:.3f} s, plain product {plain_s:.3f} s; peak "
          f"{peak:.2f} GiB; lambda {m.lambda_:.6g}, lastkeeper "
          f"{m.lastkeeper}, R2 {m.R2:.6f}; K2 launches {k2} (fast "
          f"{k2_fast}) {sorted(launched.items())}; K1 launches {k1} "
          f"(predict); _block_orth branches {taken}", flush=True)
    check(failures, "constant-memory fit K2 launches by shape and mode",
          launched == CM_PLAN and (k2, k2_fast) == (6, 4),
          f"{sorted(launched.items())} (expected {sorted(CM_PLAN.items())})")
    ok = (np.isfinite(m.R2) and m.coeffs.shape == (CM_N,)
          and np.all(np.isfinite(m.coeffs))
          and m.derivatives.shape == (CM_N, 5)
          and np.all(np.isfinite(m.derivatives))
          and np.all(np.isfinite(pred.predicted))
          and np.all(np.isfinite(pred.se_pred)) and np.all(pred.se_pred > 0)
          and s.ttests.shape == (5, 4) and k1 == 1)
    check(failures, "constant-memory fit, summary, predict(10 rows, SEs)",
          ok, f"finite, of their shapes, predict through K1 ({k1} launch)")
    bounds = [lambda_search._lower_bound(np.asarray(f.K_eigenvalues,
                                                    np.float64))
              for f in (m, m_plain)]
    print(f"constant-memory fit, card f32 K2 vs card f32 plain product "
          f"(lambda* / the search's lower bound: {m.lambda_:.6g} / "
          f"{bounds[0]:.6g} and {m_plain.lambda_:.6g} / {bounds[1]:.6g}):")
    compare(m, m_plain, pred, pred_plain, y, failures,
            looe_ref_at_lambda=looe_at)
    del m_plain
    torch.cuda.empty_cache()

    before = matvec.kernel_matmul_shapes.copy()
    t0 = time.perf_counter()
    m_prog = bt.fit(y, X, noisy=False, **kw)
    torch.cuda.synchronize()
    prog_s = time.perf_counter() - t0
    prog = dict(matvec.kernel_matmul_shapes - before)
    check(failures, "progressive fit (the card's budget) K2 launches",
          prog == PROGRESSIVE_PLAN, f"{sorted(prog.items())}")
    ame = float(np.max(np.abs(m.avgderivatives - m_prog.avgderivatives))
                / np.max(np.abs(m_prog.avgderivatives)))
    gap = {"lambda_rel": rel(m.lambda_, m_prog.lambda_),
           "R2_abs": abs(m.R2 - m_prog.R2), "ame_of_max": ame,
           "lastkeeper": [m.lastkeeper, m_prog.lastkeeper]}
    print(f"  the progressive flow on the same data: {prog_s:.3f} s, lambda "
          f"{m_prog.lambda_:.6g}, lastkeeper {m_prog.lastkeeper}, R2 "
          f"{m_prog.R2:.6f}; gap of the constant-memory fit: "
          f"{json.dumps(gap)}",
          flush=True)
    del m, m_prog
    torch.cuda.empty_cache()
    return {"constant_memory_launches": k2,
            "constant_memory_fast_launches": k2_fast,
            "constant_memory_k1_launches": k1,
            "constant_memory_products": sorted([*key, c] for key, c
                                               in launched.items()),
            "constant_memory_gap": gap,
            "epilogue_2g": check_k2_epilogue_2g(failures),
            "fast_sum_gate": check_k2_fast_sum(failures)}


# K2's fast mode over a long sum: the cross entry's Na rows against Nb
# rows, (Na, Nb, P, m); each output sums Nb products
FAST_SUM = (512, 1_000_000, SP, SQ)


def check_k2_fast_sum(failures):
    """The fast-mode gate: K2's cross entry in fast mode at ``FAST_SUM``,
    against the plain product in float64, may be no further from it than
    twice the same TF32 rounding with IEEE sums
    (``kernel_matmul_split_plain(fast=True)``) is. The tensor cores add
    into their fp32 accumulator by truncation, which over Nb / 8 steps
    outgrows the rounding of the operands; the plain product under TF32 is
    printed beside."""
    from bigkrls_tpu_torch.ops import matvec
    na, nb, p, m = FAST_SUM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    Xa = torch.randn((na, p), generator=gen, device="cuda")
    Xb = torch.randn((nb, p), generator=gen, device="cuda")
    V = torch.randn((nb, m), generator=gen, device="cuda")
    sigma = float(p)
    Y = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, fast_accum=True)
    ref64 = matvec.kernel_matmul_plain(Xa.double(), V.double(), sigma,
                                       Xb=Xb.double())
    emu = matvec.kernel_matmul_split_plain(Xa, V, sigma, Xb=Xb, fast=True)
    tf32 = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb, fast_accum=True)
    top = ref64.abs().max().item()
    errs = {name: (t.double() - ref64).abs().max().item() / top
            for name, t in (("kernel", Y), ("ieee_sums", emu),
                            ("plain_tf32", tf32))}
    t_k = cuda_ms(lambda: matvec.kernel_matmul_cross(
        Xa, Xb, V, sigma, fast_accum=True), 5, 1)
    print(f"K2 fast-mode gate, cross ({na}x{nb},P={p},m={m}): max|d|/max|Y| "
          f"vs plain f64 {errs['kernel']:.3e}; the same TF32 rounding with "
          f"IEEE sums {errs['ieee_sums']:.3e}, the plain product under TF32 "
          f"{errs['plain_tf32']:.3e}; kernel {t_k:.3f} ms", flush=True)
    check(failures, "K2 fast-mode gate: no further from f64 than twice the "
          "IEEE-sum TF32 product", errs["kernel"] <= 2 * errs["ieee_sums"],
          f"{errs['kernel']:.3e} vs {errs['ieee_sums']:.3e}")
    del Xa, Xb, V, Y, ref64, emu, tf32
    torch.cuda.empty_cache()
    return {"shape": [na, nb, p, m], "ms": t_k,
            "max_rel_err_vs_f64": errs}


def check_k2_epilogue_2g(failures):
    """K2's cross entry at ``CM_EPILOGUE`` in fast mode with ``init`` and
    ``out_scale``: every row within ``K2_FAST_TOL`` of the plain cross
    product under TF32 (the rows past 2^31 bytes apart too), and ``out``
    aliasing ``init`` bit-equal to the unaliased call; timed beside the
    bound, which counts ``init`` read."""
    from bigkrls_tpu_torch.ops import matvec
    na, nb, p, m = CM_EPILOGUE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    Xa = torch.randn((na, p), generator=gen, device="cuda")
    Xb = torch.randn((nb, p), generator=gen, device="cuda")
    V = torch.randn((nb, m), generator=gen, device="cuda")
    init = torch.randn((na, m), generator=gen, device="cuda")
    sigma, scale = float(p), -2.5
    kw = dict(init=init, out_scale=scale, fast_accum=True)
    Y = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, **kw)
    ref = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb, block=256, **kw)
    past = 2 ** 31 // (4 * m)         # the first row past 2^31 bytes
    top = ref.abs().max().item()
    err = (Y - ref).abs().max().item()
    err_past = (Y[past:] - ref[past:]).abs().max().item()
    t_p = cuda_ms(lambda: matvec.kernel_matmul_plain(
        Xa, V, sigma, Xb=Xb, block=256, out=ref, **kw), 3, 1)
    del ref
    buf = init.clone()
    Ya = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, init=buf,
                                    out_scale=scale, fast_accum=True, out=buf)
    same = Ya.data_ptr() == buf.data_ptr() and torch.equal(Ya, Y)
    del Y
    t_k = cuda_ms(lambda: matvec.kernel_matmul_cross(
        Xa, Xb, V, sigma, init=buf, out_scale=1.0, fast_accum=True, out=buf),
        5, 1)
    bound, by = k2_cross_bound_ms(na, nb, p, m, "fast", init=True)
    print(f"K2 cross epilogue ({na}x{nb},P={p},m={m}, fast, init, out over "
          f"init): max|d|/max|Y| vs plain TF32 {err / top:.3e} on every row, "
          f"{err_past / top:.3e} on rows {past}-{na - 1} past 2^31 bytes "
          f"(limit {K2_FAST_TOL:g}); aliased bit-equal to unaliased: {same}; "
          f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {bound:.3f} ms "
          f"({by})", flush=True)
    check(failures, "K2 cross epilogue past 2^31 bytes vs plain",
          err <= K2_FAST_TOL * top and err_past <= K2_FAST_TOL * top,
          f"{err / top:.3e}, {err_past / top:.3e} (limit {K2_FAST_TOL:g})")
    check(failures, "K2 cross epilogue: out over init bit-equal", same)
    del Xa, Xb, V, init, buf, Ya
    torch.cuda.empty_cache()
    return {"shape": [na, nb, p, m], "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "max_rel_err": err / top, "max_rel_err_past_2g": err_past / top,
            "aliased_bit_equal": same}


# ---------------------------------------------------------------------------
# the workflows: cross-validation, persistence, checkpoints, the CLI, traces
# ---------------------------------------------------------------------------

# CV metrics, card f32 vs CPU f64. Derived from the end-to-end limits
# above: the predictions agree within d = TOL_PRED_FRAC·sd(y), so an MSE
# moves by at most 2·rms(residual)·d + d², under 1e-2 of itself while the
# residuals' rms stays above about sd(y)/5; a squared correlation moves by
# at most about 2·d/sd(y) = 2e-3 (5e-3 with room); the AME-only predictor
# X·AME moves with the AMEs (within TOL_AME_FRAC of max|AME|), 2e-2 on its
# metrics. The card showed those three loose: every metric of the census
# split and of fold 1 within 2e-6 of the CPU's (H100 80GB HBM3, 700 W;
# PERF.md), so they are held at 1e-4 / 1e-5, fifty times that. λ* keeps the
# golden search's own limit: its stopping rule, not the arithmetic, bounds
# how far two runs may land apart.
TOL_CV_LAMBDA_REL = TOL_LAMBDA_REL
TOL_CV_MSE_REL = 1e-4
TOL_CV_R2_ABS = 1e-5
TOL_CV_AME_REL = 1e-4
# the CLI's predictions vs the in-process fit of the same CSV, of sd(y)
TOL_CLI_PRED_FRAC = 1e-6


def check(failures, name, ok, detail=""):
    print(f"  {name}: {detail} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{name}: {detail}")


def cv_metric_checks(tag, got, want, failures):
    """One CV split's metrics, card vs CPU f64, each against its limit."""
    for key in sorted(want):
        g, w = float(got[key]), float(want[key])
        if "AME" in key:
            val, tol, what = rel(g, w), TOL_CV_AME_REL, "rel"
        elif key.startswith("MSE"):
            val, tol, what = rel(g, w), TOL_CV_MSE_REL, "rel"
        else:
            val, tol, what = abs(g - w), TOL_CV_R2_ABS, "abs"
        check(failures, f"{tag} {key} {what}", val <= tol,
              f"{val:.3e} (limit {tol:g}; card {g:.6g}, CPU {w:.6g})")


def folder_mb(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 2**20


def same_prediction(a, b):
    return (np.array_equal(a.predicted, b.predicted)
            and np.array_equal(a.se_pred, b.se_pred))


def start_cli(argvs, cwd):
    """Start ``python -m bigkrls_tpu_torch`` once per argv, side by side."""
    return [subprocess.Popen([sys.executable, "-m", "bigkrls_tpu_torch", *a],
                             cwd=cwd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for a in argvs]


def finish_cli(procs):
    """Wait for the processes (killing any still running after 300 s);
    returns (exit code, last JSON line or None, output) per process."""
    out = []
    for proc in procs:
        try:
            text = proc.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0] + "\n(killed after 300 s)"
        last = None
        for line in text.strip().splitlines()[::-1]:
            if line.startswith("{"):
                last = json.loads(line)
                break
        out.append((proc.returncode, last, text))
    return out


def census_protocol(bt, y, X, failures):
    """crossvalidate(ptesting=20, neig=50) at full width for seeds 1-3 on
    the card; seed 1 against the CPU f64 run. Returns seed 1's CV object
    and K1's launches per call."""
    kw = dict(ptesting=20, neig=50, noisy=False)
    cvs, times, launches = [], [], []
    for seed in (1, 2, 3):
        counts = Counts()
        t0 = time.perf_counter()
        cv = bt.crossvalidate(y, X, seed=seed, device="cuda", **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(counts.read()[0])
        cvs.append(cv)
    print(f"census protocol crossvalidate(ptesting=20, neig=50) N={N} P={P} "
          f"on the card: seed 1 (cold) {times[0]:.3f} s, seeds 2-3 (warm) "
          f"{times[1]:.3f}, {times[2]:.3f} s; route {cvs[0].trained.eig_path}"
          f", train {len(cvs[0].indices['train_set'])} rows; K1 launches per "
          f"call {launches}; lambda {[round(c.trained.lambda_, 6) for c in cvs]}"
          f", MSE_oos {[round(c['MSE_oos'], 6) for c in cvs]}; seed 3's fit "
          f"timings {json.dumps(cvs[2].trained.timings)}", flush=True)
    t0 = time.perf_counter()
    cpu = bt.crossvalidate(y, X, seed=1, device="cpu", dtype=torch.float64,
                           **kw)
    print(f"  the same protocol, seed 1, CPU f64: "
          f"{time.perf_counter() - t0:.2f} s, route {cpu.trained.eig_path}")
    check(failures, "census route", all(
        c.trained.eig_path.startswith("stepwise") for c in cvs),
        f"{[c.trained.eig_path for c in cvs]} (expected stepwise)")
    check(failures, "census K1 launches per call", launches == [2, 2, 2],
          f"{launches} (expected 2: fit and predict)")
    check(failures, "census train/test indices vs CPU", all(
        np.array_equal(cvs[0].indices[k], cpu.indices[k])
        for k in ("train_set", "test_set")), "identical")
    lam = rel(cvs[0].trained.lambda_, cpu.trained.lambda_)
    check(failures, "census lambda rel", lam <= TOL_CV_LAMBDA_REL,
          f"{lam:.3e} (limit {TOL_CV_LAMBDA_REL:g})")
    cv_metric_checks("census", cvs[0].metrics, cpu.metrics, failures)
    return cvs[0], launches[0], times


def kfold_protocol(bt, y, X, failures):
    """5-fold CV at full width on the card (fused route on ~2485 rows);
    fold 1 against the CPU f64 run."""
    counts = Counts()
    t0 = time.perf_counter()
    cv = bt.crossvalidate(y, X, seed=1, kfolds=5, noisy=False,
                          device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    k1 = counts.read()[0]
    fits = [sum(ph["seconds"] for ph in f.trained.timings)
            for f in cv.fold_results]
    print(f"5-fold CV N={N} P={P} on the card: {total:.3f} s; fits (phase "
          f"sums) {', '.join(f'{t:.3f}' for t in fits)} s; routes "
          f"{[f.trained.eig_path for f in cv.fold_results]}; train rows "
          f"{[f.trained.n for f in cv.fold_results]}; K1 launches {k1}; fold "
          f"5's timings {json.dumps(cv.fold_results[4].trained.timings)}",
          flush=True)
    # the partition is drawn on the host from the seed alone, as
    # crossvalidate draws it (cut(sample(N), breaks=5)); fold 1 is then
    # fitted and tested on the CPU in f64 (the other four folds would add
    # ~14 s of CPU time and test nothing more)
    from bigkrls_tpu_torch.crossvalidate import _split_metrics
    rng = np.random.default_rng(1)
    folds = np.argsort(rng.permutation(N)) * 5 // N
    tr, te = folds != 0, folds == 0
    t0 = time.perf_counter()
    m_cpu = bt.fit(y[tr], X[tr], device="cpu", dtype=torch.float64,
                   noisy=False)
    p_cpu = bt.predict(m_cpu, X[te], ytest=y[te])
    cpu = _split_metrics(m_cpu, p_cpu, X[te], y[te], True)
    print(f"  fold 1 on the CPU, f64: {time.perf_counter() - t0:.2f} s, "
          f"route {m_cpu.eig_path}")
    check(failures, "k-fold routes", all(
        f.trained.eig_path == "eigh-fused" for f in cv.fold_results),
        "eigh-fused on every fold")
    check(failures, "k-fold K1 launches", k1 == 10,
          f"{k1} (expected 10: a fit and a predict per fold)")
    check(failures, "k-fold assignment vs the host partition of seed 1",
          np.array_equal(cv.folds, folds), "identical")
    finite = all(np.all(np.isfinite(v)) for v in cv.metrics.values())
    check(failures, "k-fold metrics finite", finite, "all folds")
    lam = rel(cv.fold_results[0].trained.lambda_, m_cpu.lambda_)
    check(failures, "k-fold fold 1 lambda rel", lam <= TOL_CV_LAMBDA_REL,
          f"{lam:.3e} (limit {TOL_CV_LAMBDA_REL:g})")
    cv_metric_checks("k-fold fold 1", {k: v[0] for k, v in cv.metrics.items()},
                     cpu, failures)
    text = str(bt.summary_cv(cv))
    check(failures, "summary_cv formats", "Fold 5" in text, "5 folds")
    return k1, total, fits


def persistence_checks(bt, m_dense, m_stream, cv, y, X, work, failures):
    """save/load of the dense f32 model, the streaming model and a CV
    object; predictions after the round trip bit-equal."""
    from bigkrls_tpu_torch.native import matstore
    check(failures, "native store built", matstore.available(),
          "g++ -O3 -shared -fPIC")
    Xn = X[:517]
    for name, model, newdata in (("dense", m_dense, Xn),
                                 ("streaming", m_stream, None),
                                 ("census CV", cv, Xn)):
        if newdata is None:
            newdata = streaming_data(SN)[1][:517]
        t0 = time.perf_counter()
        folder = bt.save_model(model, os.path.join(work, name))
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = bt.load_model(folder, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        a = model.trained if name == "census CV" else model
        b = loaded.trained if name == "census CV" else loaded
        same = same_prediction(bt.predict(a, newdata, se_pred=True),
                               bt.predict(b, newdata, se_pred=True))
        kernel = "no K" if b.K is None else f"K {tuple(b.K.shape)} {b.K.dtype}"
        check(failures, f"save/load {name}: predict(517 rows, SEs) after "
              "the round trip", same,
              f"bit-equal; {folder_mb(folder):.1f} MB, save {t_save:.3f} s, "
              f"load {t_load:.3f} s, {kernel} on {b.coeffs.shape[0]} rows")


def checkpoint_dense(bt, y, X, warm_s, work, failures):
    """The dense adaptive fit saved to and resumed from a checkpoint."""
    ck = os.path.join(work, "ck_dense")
    kw = dict(device="cuda", noisy=False, checkpoint_dir=ck)
    t0 = time.perf_counter()
    m1 = bt.fit(y, X, **kw)
    t_first = time.perf_counter() - t0
    counts = Counts()
    t0 = time.perf_counter()
    m2 = bt.fit(y, X, **kw)
    t_resume = time.perf_counter() - t0
    k1_resume = counts.read()[0]
    print(f"checkpointed dense fit: first {t_first:.3f} s ({m1.eig_path}), "
          f"resumed {t_resume:.3f} s ({m2.eig_path}, K1 launches "
          f"{k1_resume}, timings {json.dumps(m2.timings)}); plain warm fit "
          f"{warm_s:.3f} s", flush=True)
    check(failures, "dense resume K1 launches", k1_resume == 1,
          f"{k1_resume} (expected 1: K is rebuilt, the eig region skipped)")
    check(failures, "dense checkpoint: first fit adaptive",
          m1.eig_path.startswith("adaptive-krylov"), m1.eig_path)
    check(failures, "dense resume: eig_path and bits",
          m2.eig_path == "checkpoint" and m1.lambda_ == m2.lambda_
          and np.array_equal(m1.coeffs, m2.coeffs) and m1.looe == m2.looe
          and m1.neffective == m2.neffective,
          f"{m2.eig_path}; lambda, coeffs, looe, Neff bit-equal")
    vec = Path(ck, "adaptive_vectors.bin")

    def stamp():
        return (vec.stat().st_mtime_ns, vec.stat().st_size) \
            if vec.exists() else None

    before = stamp()
    y2 = y + np.cos(X[:, 1])
    m3 = bt.fit(y2, X, **kw)
    m3f = bt.fit(y2, X, device="cuda", noisy=False)
    check(failures, "dense resume, changed y: stored prefix, vectors "
          "untouched", m3.eig_path == "checkpoint" and before is not None
          and stamp() == before, f"{m3.eig_path}; {vec.name} {before}")
    print("  changed-y resume vs a fresh fit on that y (card f32):")
    compare(m3, m3f, bt.predict(m3, X[:10], se_pred=True),
            bt.predict(m3f, X[:10], se_pred=True), y2, failures)
    return k1_resume


def checkpoint_streaming(bt, warm_s, work, failures):
    """The N=50,000 streaming fit saved to and resumed from a checkpoint:
    the resume skips eigensystem_streaming, so K2 runs once (derivatives
    and ŷ)."""
    y, X = streaming_data(SN)
    ck = os.path.join(work, "ck_stream")
    kw = dict(neig=SNEIG, which_derivatives=[0, 1, 2, 3, 4], device="cuda",
              noisy=False, checkpoint_dir=ck)
    counts = Counts()
    t0 = time.perf_counter()
    m1 = bt.fit(y, X, **kw)
    t_first = time.perf_counter() - t0
    k2_first = counts.read()[1]
    with open(os.path.join(ck, "eig_meta.json")) as fh:
        native = json.load(fh).get("native")
    counts = Counts()
    t0 = time.perf_counter()
    m2 = bt.fit(y, X, **kw)
    t_resume = time.perf_counter() - t0
    k2_resume = counts.read()[1]
    print(f"checkpointed streaming fit N={SN}: first {t_first:.3f} s "
          f"({m1.eig_path}, K2 launches {k2_first}, timings "
          f"{json.dumps(m1.timings)}), resumed {t_resume:.3f} s "
          f"({m2.eig_path}, K2 launches {k2_resume}, timings "
          f"{json.dumps(m2.timings)}); warm streaming fit without a "
          f"checkpoint {warm_s:.3f} s", flush=True)
    check(failures, "streaming checkpoint: eigenvectors in the native store",
          bool(native) and os.path.exists(os.path.join(ck,
                                                        "eig_vectors.bin")),
          "eig_vectors.bin")
    check(failures, "streaming first fit K2 launches", k2_first == 8,
          f"{k2_first} (expected 8)")
    check(failures, "streaming resume K2 launches", k2_resume == 1,
          f"{k2_resume} (expected 1, m=22: derivatives and yhat)")
    check(failures, "streaming resume: eig_path and bits",
          m2.eig_path == "checkpoint" and m1.lambda_ == m2.lambda_
          and np.array_equal(m1.coeffs, m2.coeffs),
          f"{m2.eig_path}; lambda, coeffs bit-equal")
    return t_first, t_resume, k2_first, k2_resume


class CLIRun:
    """``python -m bigkrls_tpu_torch`` on the card, as subprocesses, in two
    waves run beside the rest of the phase: fit, cv and warmup; then
    summary, predict, reducibility and explore on the fitted model."""

    NAMES = ["fit", "cv", "warmup", "summary", "predict", "reducibility",
             "explore"]

    def __init__(self, y, X, work):
        self.root = str(Path(__file__).resolve().parent)
        self.work, self.y, self.X = work, y, X
        self.data = os.path.join(work, "smoke.csv")
        np.savetxt(self.data, np.column_stack([y, X]), delimiter=",",
                   fmt="%.17g",
                   header=",".join(["y"] + [f"x{j}" for j in range(P)]),
                   comments="")
        self.new = os.path.join(work, "new.csv")
        np.savetxt(self.new, X[:517], delimiter=",", fmt="%.17g")
        self.mdir = os.path.join(work, "cli_model")
        self.pred_csv = os.path.join(work, "cli_pred.csv")
        self.dev = ["--device", "cuda"]
        self.t0 = time.perf_counter()
        self.first = start_cli(
            [["fit", self.data, "--out", self.mdir, *self.dev],
             ["cv", self.data, "--ptesting", "20", "--seed", "1", *self.dev],
             ["warmup", "--shapes", f"{N}x{P}", *self.dev]], self.root)
        self.second = None

    def second_wave(self):
        self.first = finish_cli(self.first)
        self.second = start_cli(
            [["summary", self.mdir, *self.dev],
             ["predict", self.mdir, self.new, "--se", "--out",
              self.pred_csv, *self.dev],
             ["reducibility", self.mdir, *self.dev],
             ["explore", self.mdir, "-o",
              os.path.join(self.work, "fx.html"), *self.dev]], self.root)

    def kill(self):
        for procs in (self.first, self.second):
            for proc in procs or ():
                if isinstance(proc, subprocess.Popen):
                    proc.kill()
                    proc.communicate()


def cli_checks(bt, cli, failures):
    """The command line's exit codes, devices and predictions."""
    from bigkrls_tpu_torch.utils.io import design_from_csv
    y, X, first = cli.y, cli.X, cli.first
    second = finish_cli(cli.second)
    pred_csv = cli.pred_csv
    print(f"command line (7 subprocesses, 3 then 4 side by side, beside the "
          f"checks above): {time.perf_counter() - cli.t0:.2f} s", flush=True)
    for name, (rc, last, text) in zip(cli.NAMES, first + second):
        device = (last or {}).get("device", "")
        ok = rc == 0 and device.startswith("cuda")
        check(failures, f"CLI {name}", ok, f"exit {rc}, device {device!r}")
        if not ok:
            print(text[-2000:])
    warm = first[2][1] or {}
    check(failures, "CLI warmup first_s >= steady_s",
          warm.get("first_s", 0) >= warm.get("steady_s", 1),
          f"{warm.get('first_s')} / {warm.get('steady_s')} s")
    yc, Xc = design_from_csv(cli.data)
    m = bt.fit(yc, Xc, device="cuda", noisy=False)
    want = bt.predict(m, X[:517], se_pred=True).predicted
    got = np.loadtxt(pred_csv, delimiter=",", skiprows=1)[:, 0] \
        if os.path.exists(pred_csv) else np.full(517, np.nan)
    d = float(np.max(np.abs(got - want)) / np.std(y, ddof=1))
    check(failures, "CLI predict vs in-process fit of the CSV / sd(y)",
          d <= TOL_CLI_PRED_FRAC, f"{d:.3e} (limit {TOL_CLI_PRED_FRAC:g})")


def trace_check(bt, y, X, work, failures):
    d = os.path.join(work, "trace")
    bt.fit(y, X, device="cuda", noisy=False, trace_dir=d)
    files = sorted(Path(d).glob("*.pt.trace.json"))
    names_k1 = bool(files) and "gauss_tile_kernel" in files[0].read_text()
    check(failures, "trace_dir: a trace that names K1", names_k1,
          f"{[f.name for f in files]}")


def workflows_phase(bt, m_dense, m_stream, warm_dense_s, warm_stream_s,
                    failures):
    """Cross-validation, persistence, checkpoints, the CLI and a trace, on
    the card. Returns K1's and K2's launches per workflow."""
    t_phase = time.perf_counter()
    y, X = smoke_data()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        cli = CLIRun(y, X, work)
        try:
            cv, k1_census, _ = census_protocol(bt, y, X, failures)
            k1_kfold, _, _ = kfold_protocol(bt, y, X, failures)
            persistence_checks(bt, m_dense, m_stream, cv, y, X, work,
                               failures)
            cli.second_wave()
            k1_resume = checkpoint_dense(bt, y, X, warm_dense_s, work,
                                         failures)
            _, _, k2_first, k2_resume = checkpoint_streaming(
                bt, warm_stream_s, work, failures)
            trace_check(bt, y, X, work, failures)
            cli_checks(bt, cli, failures)
        finally:
            cli.kill()
    print(f"workflows phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"k1": {"census_cv_call": k1_census, "kfold5_call": k1_kfold,
                   "dense_resume": k1_resume},
            "k2": {"streaming_checkpointed_fit": k2_first,
                   "streaming_resume": k2_resume}}


# ---------------------------------------------------------------------------
# the mesh phase: parallel/ on virtual shards of the one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
# K2's cross entry (Na, Nb, P, m): a ring step of the N=50,000 fit on 4
# shards, and a ragged one at the dense fit's width; fast mode at the first
K2_CROSS_SHAPES = [(SN // MESH_SHARDS, SN // MESH_SHARDS, SP, SQ),
                   (N, N // 2, P, 22)]
# each ring product is MESH_SHARDS² cross launches; the N=50,000 fit makes
# 7 products at m=540 (6 power + Ritz) and 1 at m=22 (derivatives and ŷ)
RING_PRODUCTS = 8
JACOBI_N = 1024


def check_k2_cross(failures):
    """The cross entry against its plain version (precise mode within
    ``k2_tol``; fast mode within ``K2_FAST_TOL`` of the plain version under
    TF32, as for the square entry), the square entry bit-equal to the cross
    entry with Xa = Xb in both modes, and the times beside the bound."""
    from bigkrls_tpu_torch.ops import matvec
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    out = {}
    for na, nb, p, m in K2_CROSS_SHAPES:
        Xa = torch.randn((na, p), generator=gen, device="cuda")
        Xb = torch.randn((nb, p), generator=gen, device="cuda")
        V = torch.randn((nb, m), generator=gen, device="cuda")
        Vs = torch.randn((na, m), generator=gen, device="cuda")
        sigma, tol = float(p), k2_tol(nb)
        Y = matvec.kernel_matmul_cross(Xa, Xb, V, sigma)
        ref = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (Y - ref).abs().max().item()
        same = all(torch.equal(
            matvec.kernel_matmul(Xa, Vs, sigma, fast_accum=f),
            matvec.kernel_matmul_cross(Xa, Xa, Vs, sigma, fast_accum=f))
            for f in (False, True))
        t_k = cuda_ms(lambda: matvec.kernel_matmul_cross(Xa, Xb, V, sigma),
                      10, 2)
        t_p = cuda_ms(lambda: matvec.kernel_matmul_plain(Xa, V, sigma,
                                                         Xb=Xb), 10, 2)
        bound, by = k2_cross_bound_ms(na, nb, p, m, "split")
        line = (f"K2 cross ({na}x{nb},P={p},m={m}): max|d|/max|Y| vs plain "
                f"f32 {err / scale:.3e} (limit {tol:.1e}); square entry "
                f"bit-equal to the cross entry with Xa = Xb: {same}; kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bound:.4f} ms "
                f"({by})")
        if not err <= tol * scale:
            failures.append(f"K2 cross ({na},{nb},{p},{m}): {err / scale} > "
                            f"{tol}")
        if not same:
            failures.append(f"K2 cross ({na},{nb},{p},{m}): the square entry "
                            "differs from the cross entry with Xa = Xb")
        if (na, nb, p, m) == K2_CROSS_SHAPES[0]:
            Yf = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, fast_accum=True)
            ref_f = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb,
                                               fast_accum=True)
            torch.cuda.synchronize()
            err_f = (Yf - ref_f).abs().max().item()
            t_f = cuda_ms(lambda: matvec.kernel_matmul_cross(
                Xa, Xb, V, sigma, fast_accum=True), 10, 2)
            bound_f = k2_cross_bound_ms(na, nb, p, m, "fast")[0]
            line += (f"; fast mode max|d|/max|Y| vs plain TF32 "
                     f"{err_f / scale:.3e} (limit {K2_FAST_TOL:g}), "
                     f"{t_f:.4f} ms, bound {bound_f:.4f} ms")
            if not err_f <= K2_FAST_TOL * scale:
                failures.append(f"K2 cross fast: {err_f / scale} > "
                                f"{K2_FAST_TOL}")
            out.update(cross_shape=[na, nb, p, m], cross_ms=t_k,
                       cross_plain_ms=t_p, cross_bound_ms=bound,
                       cross_bound_by=by, cross_max_abs_err=err,
                       cross_fast_ms=t_f, cross_fast_bound_ms=bound_f,
                       cross_fast_max_abs_err=err_f)
            del Yf, ref_f
        print(line, flush=True)
        del Xa, Xb, V, Vs, Y, ref
    return out


def warm_fit(bt, y, X, **kw):
    """One warm fit: (model, synced wall seconds, peak bytes the fit
    allocated above what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = bt.fit(y, X, noisy=False, **kw)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0, torch.cuda.max_memory_allocated() \
        - base


def gather_budget(tag, log, n, failures):
    """Print a mesh fit's gather log; any N×N gather, or N-row gather off
    ``GATHER_ALLOWED``, is a failure. Returns the log's summary."""
    from bigkrls_tpu_torch.parallel.sharded import GATHER_ALLOWED
    bad = log.offending(n)
    labels = sorted({lab for lab, _ in log.entries})
    print(f"{tag} gathers: {log.count} ({log.elements} elements), labels "
          f"{labels}; off the allow-list {sorted(GATHER_ALLOWED)}: {bad}",
          flush=True)
    if bad:
        failures.append(f"{tag}: gathered {bad}")
    return {k: v for k, v in log.summary().items() if k != "entries"}


def mesh_vs_one(tag, bt, y, X, mesh_kw, one_kw):
    """Warm fits over the mesh and on the one device, in turns (mesh, one,
    one, mesh): times and peak memory of each, printed and returned."""
    runs = {"mesh": [], "one": []}
    for side in ("mesh", "one", "one", "mesh"):
        _, t, peak = warm_fit(bt, y, X, **(mesh_kw if side == "mesh"
                                           else one_kw))
        runs[side].append((t, peak))
    out = {side: {"warm_s": [r[0] for r in v],
                  "peak_gib": [r[1] / 2 ** 30 for r in v]}
           for side, v in runs.items()}
    print(f"{tag} warm fits, mesh / one device (in turns m, 1, 1, m): "
          f"{out['mesh']['warm_s'][0]:.4f}, {out['one']['warm_s'][0]:.4f}, "
          f"{out['one']['warm_s'][1]:.4f}, {out['mesh']['warm_s'][1]:.4f} s;"
          f" peak allocated above the start {out['mesh']['peak_gib'][0]:.4f}"
          f" / {out['one']['peak_gib'][0]:.4f} GiB", flush=True)
    return out


def ring_fit(bt, mesh, m_stream, warm_stream_s, failures):
    """The N=50,000 streaming fit over a ring of the mesh's shards, held
    against the single-device streaming fit. Returns K2's cross launches in
    the fit, the warm fit time and the gather and memory record."""
    from bigkrls_tpu_torch.parallel.sharded import record_gathers
    y, X = streaming_data(SN)
    kw = dict(neig=SNEIG, which_derivatives=[0, 1, 2, 3, 4], mesh=mesh)
    counts = Counts()
    t0 = time.perf_counter()
    with record_gathers() as log:
        m = bt.fit(y, X, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    _, k2, k2_fast = counts.read()
    cross = counts.cross()
    m_warm, warm, _ = warm_fit(bt, y, X, **kw)
    want = RING_PRODUCTS * MESH_SHARDS ** 2
    rep = m.sharding_report
    print(f"ring streaming fit N={SN} over {MESH_SHARDS} shards of cuda:0: "
          f"cold {cold:.3f} s, warm {warm:.3f} s (single device warm "
          f"{warm_stream_s:.3f} s), timings {json.dumps(m_warm.timings)}; "
          f"eig_path {m.eig_path}, lambda {m.lambda_:.6g}, lastkeeper "
          f"{m.lastkeeper}; K2 launches {k2} (cross {cross}, fast {k2_fast}; "
          f"expected {want} = {RING_PRODUCTS} products x {MESH_SHARDS}^2); "
          f"Q {rep['Q']}", flush=True)
    record = {"gathers": gather_budget("ring fit", log, SN, failures),
              **mesh_vs_one("ring fit", bt, y, X, kw,
                            {k: v for k, v in kw.items() if k != "mesh"})}
    if (k2, cross, k2_fast) != (want, want, 0):
        failures.append(f"ring fit: K2 launches {k2}, cross {cross}, fast "
                        f"{k2_fast}; expected {want} cross launches")
    if m.eig_path != "streaming-krylov" or m.K is not None:
        failures.append(f"ring fit took {m.eig_path!r}")
    if rep["X_std"]["devices"] != MESH_SHARDS or rep["Q"]["replicated"]:
        failures.append(f"ring fit: sharding report {rep}")
    if rep["X_std"]["shard_shape"][0] != SN // MESH_SHARDS:
        failures.append(f"ring fit: X_std {rep['X_std']}")
    print("ring fit vs the single-device streaming fit (card f32):")
    compare(m, m_stream, bt.predict(m, X[:10], se_pred=True),
            bt.predict(m_stream, X[:10], se_pred=True), y, failures)
    del m, m_warm
    torch.cuda.empty_cache()
    return cross, warm, record


def dense_mesh_fit(bt, mesh, m_dense, failures):
    """The default fit at N=3106, P=67 over a 2×2 mesh: the adaptive route,
    one K1 launch per block; held against the single-device card fit.
    Returns K1's launches in the fit, the warm fit time and the gather and
    memory record."""
    from bigkrls_tpu_torch.ops import kernels
    from bigkrls_tpu_torch.parallel.sharded import ShardedTensor, \
        record_gathers
    y, X = smoke_data()
    counts = Counts()
    with record_gathers() as log:
        m = bt.fit(y, X, mesh=mesh)
    torch.cuda.synchronize()
    k1 = kernels.gauss_tile_launches
    m_warm, warm, _ = warm_fit(bt, y, X, mesh=mesh)
    rep = m.sharding_report
    print(f"dense fit N={N} P={P} over a {mesh.shape[0]}x{mesh.shape[1]} mesh "
          f"of cuda:0: eig_path {m.eig_path}, lambda {m.lambda_:.6g}, "
          f"lastkeeper {m.lastkeeper}; K1 launches {k1} (expected "
          f"{mesh.size}, one per block); warm {warm:.3f} s, timings "
          f"{json.dumps(m_warm.timings)}; K {rep['K']}, Q {rep['Q']}",
          flush=True)
    del counts
    if not (m.eig_path or "").startswith("adaptive-krylov"):
        failures.append(f"dense mesh fit took {m.eig_path!r}, not the "
                        "adaptive route")
    if k1 != mesh.size:
        failures.append(f"dense mesh fit: K1 launched {k1} times, expected "
                        f"{mesh.size}")
    if rep["K"]["devices"] != mesh.size or rep["Q"]["devices"] !=             mesh.shape[0]:
        failures.append(f"dense mesh fit: sharding report {rep}")
    if not (isinstance(m.K, ShardedTensor) and m.K.spec == "block"):
        failures.append("dense mesh fit: the model's K is not block-sharded")
    record = {"gathers": gather_budget("dense mesh fit", log, N, failures),
              **mesh_vs_one("dense mesh fit", bt, y, X, {"mesh": mesh},
                            {"device": "cuda"})}
    print("dense mesh fit vs the single-device card fit:")
    compare(m, m_dense, bt.predict(m, X[:10], se_pred=True),
            bt.predict(m_dense, X[:10], se_pred=True), y, failures)
    return k1, warm, record


def jacobi_fit(bt, mesh, failures):
    """A full-spectrum fit at N=1024 with block Jacobi forced over the mesh,
    against the same fit by the gathered ``eigh``; no fallback allowed."""
    import logging
    y, X = smoke_data()
    y, X = y[:JACOBI_N], X[:JACOBI_N]
    # eigtrunc as at N > 3000, so that lastkeeper does not hang on the sign
    # of f32 noise in the smallest eigenvalues
    kw = dict(eigtrunc=1e-3, noisy=False)
    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    log = logging.getLogger("bigkrls_tpu_torch")
    handler = Catch(level=logging.WARNING)
    log.addHandler(handler)
    try:
        t0 = time.perf_counter()
        mj = bt.fit(y, X, mesh=mesh, eig_method="jacobi", **kw)
        torch.cuda.synchronize()
        t_j = time.perf_counter() - t0
    finally:
        log.removeHandler(handler)
    t0 = time.perf_counter()
    mf = bt.fit(y, X, mesh=mesh, eig_method="full", **kw)
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    top = np.abs(mj.K_eigenvalues[:20] - mf.K_eigenvalues[:20]).max()         / mf.K_eigenvalues[0]
    print(f"Jacobi fit N={JACOBI_N} ({mj.eig_path}, {t_j:.3f} s) vs full "
          f"eigh ({mf.eig_path}, {t_f:.3f} s): lambda {mj.lambda_:.6g} / "
          f"{mf.lambda_:.6g}, top-20 eigenvalues max|d|/lambda_1 {top:.3e}; "
          f"fallback warnings {warned}", flush=True)
    if mj.eig_path != "stepwise:jacobi" or warned:
        failures.append(f"Jacobi fit: {mj.eig_path!r}, warnings {warned}")
    if not top <= 1e-5:
        failures.append(f"Jacobi eigenvalues: {top} of lambda_1 from eigh's")
    compare(mj, mf, bt.predict(mj, X[:10], se_pred=True),
            bt.predict(mf, X[:10], se_pred=True), y, failures)
    return t_j


def nccl_group(failures):
    """A one-rank NCCL group: initialize_distributed with explicit
    arguments, process_info, global_mesh, then the group destroyed."""
    import socket
    import torch.distributed as dist
    from bigkrls_tpu_torch.parallel import distributed
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n = distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                           device_type="cuda")
    try:
        info = distributed.process_info()
        mesh = distributed.global_mesh()
        backend = dist.get_backend()
        ok = (distributed.is_initialized() and backend == "nccl"
              and info["process_count"] == 1 and info["process_index"] == 0
              and info["global_devices"] == n == torch.cuda.device_count()
              and mesh.size == n)
        print(f"one-rank NCCL group: backend {backend}, {info}, mesh "
              f"{mesh}: ok={ok}", flush=True)
    finally:
        dist.destroy_process_group()
    if not ok or distributed.is_initialized():
        failures.append("one-rank NCCL group")
    nccl_group_launcher(failures)


def nccl_group_launcher(failures):
    """The one-rank NCCL group joined as under a launcher such as torchrun
    (``env://`` with ``LOCAL_RANK=0``, ``LOCAL_WORLD_SIZE=1``): the process
    takes every card, the first as its current device."""
    import socket
    import torch.distributed as dist
    from bigkrls_tpu_torch.parallel import distributed
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        n = distributed.initialize_distributed()
        try:
            info = distributed.process_info()
            mesh = distributed.global_mesh()
            backend = dist.get_backend()
            ok = (backend == "nccl" and torch.cuda.current_device() == 0
                  and n == info["local_devices"] == torch.cuda.device_count()
                  and mesh.size == n)
            print(f"one-rank NCCL group through the launcher's environment: "
                  f"backend {backend}, {info}, mesh {mesh}: ok={ok}",
                  flush=True)
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not ok or distributed.is_initialized():
        failures.append("one-rank NCCL group through the launcher")


def cards_fit(bt, m_dense, virtual_mesh, failures):
    """With 2 or more cards: the N=3106 fit over a mesh of distinct cards
    (2×2 over four, else 1×D), one K1 launch on each card, held against
    the single-device fit; bit for bit against the same fit over virtual
    shards of cuda:0 (printed), peer access between the cards printed
    first. Returns the record, or None on one card."""
    from collections import Counter

    from bigkrls_tpu_torch.ops import kernels
    from bigkrls_tpu_torch.parallel.sharded import make_mesh, \
        record_gathers
    count = min(torch.cuda.device_count(), MESH_SHARDS)
    if count < 2:
        print("one card: the fit over distinct cards is not run", flush=True)
        return None
    peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
             for i in range(count) for j in range(count) if i != j}
    print(f"peer access: {json.dumps(peers)}", flush=True)
    mesh = make_mesh(devices=[torch.device("cuda", i) for i in range(count)])
    y, X = smoke_data()
    before = Counter(kernels.gauss_tile_launches_by_device)
    t0 = time.perf_counter()
    with record_gathers() as log:
        m = bt.fit(y, X, mesh=mesh, noisy=False)
    for i in range(count):
        torch.cuda.synchronize(i)
    cold = time.perf_counter() - t0
    by_card = dict(Counter(kernels.gauss_tile_launches_by_device) - before)
    m_virtual = bt.fit(y, X, mesh=virtual_mesh, noisy=False)
    same = all(np.array_equal(getattr(m, f), getattr(m_virtual, f))
               for f in ("coeffs", "yfitted", "avgderivatives"))
    print(f"dense fit N={N} P={P} over {mesh}: eig_path {m.eig_path}, "
          f"cold {cold:.3f} s, K1 launches by card {by_card}; bit-equal to "
          f"the fit over virtual shards of cuda:0: {same}", flush=True)
    if by_card != {i: 1 for i in range(count)}:
        failures.append(f"dense fit over cards: K1 launches {by_card}")
    if not (m.eig_path or "").startswith("adaptive-krylov"):
        failures.append(f"dense fit over cards took {m.eig_path!r}")
    record = {"cards": count, "cold_s": cold, "k1_by_card": by_card,
              "bit_equal_to_virtual": same,
              "gathers": gather_budget("dense fit over cards", log, N,
                                       failures)}
    print("dense fit over cards vs the single-device card fit:")
    compare(m, m_dense, bt.predict(m, X[:10], se_pred=True),
            bt.predict(m_dense, X[:10], se_pred=True), y, failures)
    return record


def mesh_phase(bt, m_dense, m_stream, warm_stream_s, failures):
    """``parallel/`` on virtual shards of the card. Returns the numbers for
    the kernels line."""
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS)
    cross = check_k2_cross(failures)
    k2_ring, ring_warm, ring_rec = ring_fit(bt, mesh, m_stream,
                                            warm_stream_s, failures)
    k1_mesh, dense_warm, dense_rec = dense_mesh_fit(bt, mesh, m_dense,
                                                    failures)
    cards = cards_fit(bt, m_dense, mesh, failures)
    jacobi_fit(bt, mesh, failures)
    nccl_group(failures)
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"mesh_fits": {"ring": ring_rec, "dense": dense_rec,
                                    "cards": cards}}))
    return {"k1": {"dense_mesh_fit_blocks": k1_mesh},
            "k2": {"ring_fit_cross": k2_ring}, "cross": cross,
            "ring_warm_s": ring_warm, "dense_mesh_warm_s": dense_warm}


# ---------------------------------------------------------------------------
# the benchmark, ``python -m bigkrls_tpu_torch bench``, at a short budget
# ---------------------------------------------------------------------------

BENCH_BUDGET_S = 240
# the JAX bench's R² on the same seeded data (BENCH_r04.json's log)
JAX_BENCH_R2 = {"krls_streaming_fullfit_n50000_p20_s": 0.541,
                "krls_streaming_fullfit_n100000_p20_s": 0.545}
# K2 launches of one streaming fit, (all, fast): six power products, then
# the Ritz product (a 3780-wide precise one where the power products were
# fast) and the 22-wide product of the coefficients' step
BENCH_FIT_K2 = {"krls_streaming_fullfit_n50000_p20_fastpower_s": (8, 6)}
BENCH_FIT_K2_DEFAULT = (8, 0)
# the K2 shapes of the bench's run at this budget that check_k2 does not
# hold: the 100k fit and product, and the fast-power fit's Ritz product
BENCH_K2_SHAPES = [(100_000, SP, SQ), (100_000, SP, 22), (SN, SP, 7 * SQ)]


def check_k2_bench_shapes(failures):
    """K2 (precise) against its plain version, every row, at the shapes
    the bench's streaming run gives it; returns the errors by shape."""
    from bigkrls_tpu_torch.ops import matvec
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    out = {}
    for n, p, m in BENCH_K2_SHAPES:
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        Y = matvec.kernel_matmul(X, V, float(p))
        ref = matvec.kernel_matmul_plain(X, V, float(p))
        rel_err = ((Y - ref).abs().max() / ref.abs().max()).item()
        tol = k2_tol(n)
        print(f"K2 ({n},P={p},m={m}), a bench shape: max|d|/max|Y| vs plain "
              f"f32 {rel_err:.3e} (limit {tol:.1e})", flush=True)
        check(failures, f"K2 ({n},{p},{m}) vs plain", rel_err <= tol,
              f"{rel_err} (limit {tol})")
        out[f"{n}x{p}x{m}"] = rel_err
        del X, V, Y, ref
    torch.cuda.empty_cache()
    return out


def bench_phase(card, failures):
    """The port's benchmark as a user runs it, with ``BENCH_BUDGET_S=240``:
    every metric name of the JAX bench present, none failed and none
    passed only on a retry, the primary last, every record naming
    ``card``, the 50k and 100k R² the JAX bench's to three digits, every
    streaming fit through K2 (``BENCH_FIT_K2``) and every product within
    its ``k2_tol`` of the plain one. Returns the records."""
    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "bigkrls_tpu_torch", "bench", "--device",
             "cuda"], cwd=str(Path(__file__).resolve().parent), env=env,
            capture_output=True, text=True, timeout=3 * BENCH_BUDGET_S)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", e.stdout or "", e.stderr or ""
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    print(f"bench (BENCH_BUDGET_S={BENCH_BUDGET_S}): exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s, {len(recs)} records",
          flush=True)
    for r in recs:
        extra = {k: r[k] for k in ("value_cold", "value_median", "R2",
                                   "eig_path", "k2_launches",
                                   "k2_fast_launches", "ms", "bound_ms",
                                   "plain_ms", "max_rel_err", "tol",
                                   "peak_memory_gib", "attempts",
                                   "first_error", "skipped", "failed")
                 if k in r}
        print(f"  {r['metric']}: {r['value']} {r['unit']} {json.dumps(extra)}")
    names = [r["metric"] for r in recs]
    check(failures, "bench exit code", rc == 0, f"{rc}")
    check(failures, "bench metric names", set(names) == set(METRICS)
          and len(names) == len(METRICS),
          f"missing {sorted(set(METRICS) - set(names))}")
    check(failures, "bench: no failed record",
          not any("failed" in r for r in recs),
          f"{[r['metric'] for r in recs if 'failed' in r]}")
    retried = [(r["metric"], r.get("first_error")) for r in recs
               if r.get("attempts", 1) > 1]
    check(failures, "bench: no record needed a retry", not retried,
          f"{retried}")
    for r in recs:
        ran = r["value"] is not None
        if ran and r["metric"].startswith("krls_streaming_fullfit_"):
            want = BENCH_FIT_K2.get(r["metric"], BENCH_FIT_K2_DEFAULT)
            got = (r.get("k2_launches"), r.get("k2_fast_launches"))
            check(failures, f"bench {r['metric']} K2 launches (all, fast)",
                  got == want, f"{got} (expected {want})")
        if ran and r["metric"].startswith("streaming_product_"):
            check(failures, f"bench {r['metric']} K2 vs plain",
                  r.get("max_rel_err") is not None
                  and r["max_rel_err"] <= r["tol"],
                  f"{r.get('max_rel_err')} (limit {r.get('tol')}, "
                  f"{r.get('checked_rows')} rows)")
    check(failures, "bench: the primary last",
          bool(names) and names[-1] == PRIMARY, f"{names[-1:]}")
    check(failures, "bench: every record names the card",
          bool(recs) and all(r.get("card") == card for r in recs),
          f"{card!r}")
    for metric, want in JAX_BENCH_R2.items():
        got = next((r.get("R2") for r in recs if r["metric"] == metric),
                   None)
        check(failures, f"bench {metric} R2 vs the JAX bench's",
              got is not None and round(got, 3) == want,
              f"{got} (JAX {want})")
    if rc != 0 or len(recs) != len(METRICS) or retried:
        print(err[-4000:])
    return recs


DL_LAMBDA_REL = 1e-6     # device loop vs host loop on the card, same basis
DL_LE_REL = 1e-5
DL_COEFFS_REL = 1e-4     # of max|c|


@contextlib.contextmanager
def strict_chunks(record):
    """Every chunk of the golden search's device loop under
    ``set_sync_debug_mode("error")``: a host read inside one raises.
    ``record`` receives (iterations, chunks) of each search."""
    from bigkrls_tpu_torch.ops import solve
    chunk, search = solve.golden_chunk, solve.golden_search_device

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chunk(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def recorded(*a, **kw):
        out = search(*a, **kw)
        record.append(out[1:])
        return out

    solve.golden_chunk, solve.golden_search_device = strict, recorded
    try:
        yield
    finally:
        solve.golden_chunk, solve.golden_search_device = chunk, search


def device_loop_phase(bt, m_cpu, smi, failures):
    """The golden-section λ search as a device loop, on the default fit's
    data (N=3106, P=67, f32, the adaptive route at k=256): no host read
    inside a chunk of a warm fit; the synchronising calls of one warm fit
    (``torch.cuda.set_sync_debug_mode("warn")``, by file and line) with
    the device loop and with the host loop in its place, the golden
    loop's at most ⌈iterations / T⌉ + 1; the device loop against the
    host loop on the fit's own masked basis (λ*, Le, coefficients, both
    within §2 of the CPU f64 fit), the region's time each way, and the
    bench's three post-kernel metrics, min and median of 9."""
    import golden_loop as gl
    from bigkrls_tpu_torch import bench
    from bigkrls_tpu_torch.ops import solve
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    y, X, K, yd = gl.default_data(dev)
    T = solve.GOLDEN_CHUNK
    out = {"card": smi, "T": T}

    searches = []
    try:
        with strict_chunks(searches):
            bt.fit(y, X, device="cuda", noisy=False)
        check(failures, "device loop: no host read inside a chunk", True)
    except RuntimeError as e:
        check(failures, "device loop: no host read inside a chunk", False,
              str(e)[:300])
    it, chunks = searches[-1] if searches else (None, None)
    out.update(iterations=it, chunks=chunks, searches=len(searches))
    print(f"device loop: a warm default fit, {len(searches)} search(es), "
          f"{it} golden-section iterations in {chunks} chunks of T={T}, "
          f"no read inside a chunk", flush=True)

    with gl.count_syncs() as reads:
        bt.fit(y, X, device="cuda", noisy=False)
    with gl.host_loop_in_regions(), gl.count_syncs() as reads_host:
        bt.fit(y, X, device="cuda", noisy=False)
    loop_reads = sum(n for site, n in reads["by_site"].items()
                     if site.startswith("solve.py:"))
    out["reads"] = {"device_loop": reads, "host_loop": reads_host,
                    "golden_loop": loop_reads}
    print(f"synchronising calls of one warm default fit "
          f"(set_sync_debug_mode; the phase timer's synchronize calls "
          f"are not among them): device loop "
          f"{reads['total']} (golden loop {loop_reads}), host loop in its "
          f"place {reads_host['total']}", flush=True)
    print(f"  device loop by site: {json.dumps(reads['by_site'])}")
    print(f"  host loop by site: {json.dumps(reads_host['by_site'])}")
    if it is not None:
        limit = -(-it // T) + 1
        check(failures, "golden loop reads <= ceil(iterations/T) + 1",
              loop_reads <= limit, f"{loop_reads} (limit {limit})")

    basis = gl.loop_basis(K, yd)
    lam_d, Le_d, c_d, it_d = solve.golden_solve(**basis)
    lam_h, Le_h, c_h, it_h = gl.host_golden_solve(**basis)
    d = {"lambda": [float(lam_d), float(lam_h)], "iterations": [it_d, it_h],
         "lambda_rel": rel(float(lam_d), float(lam_h)),
         "Le_rel": rel(float(Le_d), float(Le_h)),
         "coeffs_rel": float((c_d - c_h).abs().max() / c_h.abs().max()),
         "vs_cpu_f64": [rel(float(lam_d), m_cpu.lambda_),
                        rel(float(lam_h), m_cpu.lambda_)]}
    out["device_vs_host"] = d
    print(f"device vs host loop, the fit's masked basis: lambda "
          f"{d['lambda']}, iterations {d['iterations']}, lambda rel "
          f"{d['lambda_rel']:.3e} (limit {DL_LAMBDA_REL}), Le rel "
          f"{d['Le_rel']:.3e}, coeffs {d['coeffs_rel']:.3e} of max; vs the "
          f"CPU f64 fit {d['vs_cpu_f64'][0]:.3e} / {d['vs_cpu_f64'][1]:.3e} "
          f"(limit {TOL_LAMBDA_REL})", flush=True)
    check(failures, "device vs host loop lambda",
          d["lambda_rel"] <= DL_LAMBDA_REL, f"{d['lambda_rel']}")
    check(failures, "device vs host loop Le", d["Le_rel"] <= DL_LE_REL,
          f"{d['Le_rel']}")
    check(failures, "device vs host loop coefficients",
          d["coeffs_rel"] <= DL_COEFFS_REL, f"{d['coeffs_rel']}")
    check(failures, "device and host loop lambda vs the CPU f64 fit",
          max(d["vs_cpu_f64"]) <= TOL_LAMBDA_REL, f"{d['vs_cpu_f64']}")

    # the adaptive region (the bench's primary) each way, in turns
    times = {"device_loop": [], "host_loop": []}
    for _ in range(9):
        for way in times:
            ctx = (gl.host_loop_in_regions() if way == "host_loop"
                   else contextlib.nullcontext())
            with ctx:
                t0 = gl.now(dev)
                bench.postkernel_fit_adaptive(K, yd)
                times[way].append(gl.now(dev) - t0)
    out["region_s"] = {k: gl.min_median(v) for k, v in times.items()}
    print(f"adaptive region, device loop / host loop (min, median of 9, "
          f"in turns): " + ", ".join(
              f"{k} {v['min']:.6f} / {v['median']:.6f} s"
              for k, v in out["region_s"].items()) + f"  [{smi}]")

    out["bench"] = gl.bench_regions(K, yd, 9)
    for name, v in out["bench"].items():
        print(f"  {name}: min {v['min']:.6f} s, median {v['median']:.6f} s "
              f"(of {v['n']})  [{smi}]")
    del K
    torch.cuda.empty_cache()
    print(f"device loop phase: {time.perf_counter() - t_phase:.1f} s")
    print("device_loop: " + json.dumps(out, default=str), flush=True)
    return out


def check_outputs(m, s, pred, failures):
    ok = (np.all(np.isfinite(m.coeffs)) and m.coeffs.shape == (N,)
          and m.derivatives.shape == (N, P)
          and np.all(np.isfinite(m.derivatives))
          and pred.predicted.shape == (10,)
          and np.all(np.isfinite(pred.predicted))
          and np.all(np.isfinite(pred.se_pred)) and np.all(pred.se_pred > 0)
          and s.ttests.shape == (P, 4)
          and np.all((s.ttests[:, 3] >= 0) & (s.ttests[:, 3] <= 1)))
    if not ok:
        failures.append("fit/summary/predict outputs not finite or of the "
                        "expected shape")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.ops import _build, kernels, matvec
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import k1_oracle

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc[-1]}, device {torch.cuda.get_device_name(0)}", flush=True)
    failures = []
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    oracle_build = k1_oracle.start_build()   # beside the package's nvccs
    _build.library()
    k1_first = k1_oracle.load(oracle_build)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s; K1's frozen first design "
          f"beside it)", flush=True)
    for line in _build.last_build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "setmaxnreg")):
            print("  ptxas:" + line.split(":", 1)[-1])

    y, X = smoke_data()
    Xd = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    X_std = ((Xd - Xd.mean(0)) / Xd.std(0, correction=1)).contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    k1 = check_k1(X_std, k1_first, failures)

    # ---- the dense main path: fit, summary, predict on the card ----
    kernels.gauss_tile_launches = 0
    t0 = time.perf_counter()
    m = bt.fit(y, X, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    s = bt.summary(m)
    pred = bt.predict(m, X[:10], se_pred=True)
    launches = kernels.gauss_tile_launches
    print(f"cold fit on the card: {fit_s:.3f} s, eig_path {m.eig_path}, "
          f"lambda {m.lambda_:.6g}, lastkeeper {m.lastkeeper}, "
          f"Neff {m.neffective:.4f}, R2 {m.R2:.6f}; K1 launches {launches}",
          flush=True)
    if not (m.eig_path or "").startswith("adaptive-krylov"):
        failures.append(f"fit took {m.eig_path!r}, not the adaptive route")
    if launches < 2:
        failures.append(f"K1 launched {launches} times in fit+predict "
                        "(expected one each)")
    check_outputs(m, s, pred, failures)

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        m_warm = bt.fit(y, X, device="cuda", noisy=False)
        warm.append(time.perf_counter() - t0)
    print(f"warm fit: {statistics.median(warm):.3f} s (3 fits: "
          f"{', '.join(f'{t:.3f}' for t in warm)}), timings of the last "
          f"{json.dumps(m_warm.timings)}")
    t0 = time.perf_counter()
    m_plain = bt.fit(y, X, device="cuda", noisy=False, kernel_impl="plain")
    print(f"warm fit, plain kernel: {time.perf_counter() - t0:.3f} s, "
          f"timings {json.dumps(m_plain.timings)}", flush=True)

    # ---- the same fit through the port on the CPU in float64 ----
    t0 = time.perf_counter()
    m_cpu = bt.fit(y, X, device="cpu", dtype=torch.float64, noisy=False)
    pred_cpu = bt.predict(m_cpu, X[:10], se_pred=True)
    print(f"CPU f64 fit: {time.perf_counter() - t0:.2f} s, eig_path "
          f"{m_cpu.eig_path}, lambda {m_cpu.lambda_:.6g}")
    print("card f32 vs CPU f64:")
    compare(m, m_cpu, pred, pred_cpu, y, failures)
    device_loop_phase(bt, m_cpu, smi.splitlines()[0], failures)

    # ---- K2 and the streaming slice ----
    k2 = check_k2(failures)
    k2_launches, m_stream, warm_stream = streaming_phase(bt, failures)
    streaming_vs_dense(bt, failures)
    chebyshev_phase(failures)
    cm = constant_memory_phase(bt, failures)
    wf = workflows_phase(bt, m, m_stream, statistics.median(warm),
                         warm_stream, failures)
    mp = mesh_phase(bt, m, m_stream, warm_stream, failures)
    del m_stream
    torch.cuda.empty_cache()
    k2_bench = check_k2_bench_shapes(failures)
    bench = bench_phase(smi.splitlines()[0].rpartition(",")[0].strip(),
                        failures)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
          f"build to here", flush=True)
    print(json.dumps({"kernels": [{
        "name": "gauss_tile", "route": "cuda",
        "source": "bigkrls_tpu_torch/csrc/gauss_kernel.cu",
        "replaces": "bigkrls_tpu/ops/kernels.py:87",
        "launches": launches, "library_ms": None,
        "cards": [f"cuda:{i}" for i in
                  sorted(kernels.gauss_tile_launches_by_device)],
        "workflow_launches": wf["k1"], "mesh_launches": mp["k1"],
        "constant_memory_launches": cm.pop("constant_memory_k1_launches"),
        **k1}, {
        "name": "kernel_matmul", "route": "cuda",
        "source": "bigkrls_tpu_torch/csrc/kernel_matmul.cu",
        "replaces": "bigkrls_tpu/ops/matvec.py:139",
        "launches": k2_launches, "library_ms": None,
        "cards": [f"cuda:{i}" for i in
                  sorted(matvec.kernel_matmul_launches_by_device)],
        "workflow_launches": wf["k2"], "mesh_launches": mp["k2"],
        "bench_launches": {r["metric"]: r["k2_launches"] for r in bench
                           if r.get("k2_launches") is not None},
        "bench_shapes_max_rel_err": k2_bench, **cm, **mp["cross"],
        **k2}]}))
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
