#!/usr/bin/env python3
"""Drive the PyTorch port (``bigkrls_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions; exits non-zero without a CUDA device;
2. builds the CUDA kernels from ``bigkrls_tpu_torch/csrc`` and prints the
   build time;
3. holds the Gaussian tile kernel (K1) against its plain PyTorch version
   on the card at the fit's and predict's shapes (max |Δ| ≤ 1e-5 in f32,
   bit-symmetric, exact diagonal) and times both with CUDA events;
4. runs the default ``fit`` at N=3106, P=67 (the election data's width)
   on a seeded low-rank design whose kernel spectrum decays like the
   election data's, so the fit takes the adaptive route through K1; then
   ``summary`` and ``predict(se_pred=True)``; checks the launch count, and
   holds the result against the port's own float64 fit on the CPU;
5. prints one JSON line for the kernels, then the result line.

Any failed check exits non-zero without the result line. No JAX is used.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N, P = 3106, 67
SEED = 2016

# K1 shapes (M, N, P, symmetric): the fit's kernel, ragged and wide-N
# symmetric cases, and predict's cross-kernel shape
K1_SHAPES = [(N, N, P, True), (1000, 1000, 5, True), (4097, 4097, 3, True),
             (16384, 16384, 20, True), (517, N, P, False)]
K1_TOL = 1e-5   # f32 rank-P cancellation at r ≈ P, damped by exp()

# end-to-end tolerances, GPU f32 vs CPU f64 (tests/test_adaptive.py:181-183)
TOL_LAMBDA_REL = 2e-2   # bounded by the golden search's own stopping rule
TOL_LOOE_REL = 1e-3
TOL_NEFF_REL = 1e-3
TOL_R2_ABS = 1e-4
TOL_AME_FRAC = 1e-2     # of max |AME|
TOL_PRED_FRAC = 1e-3    # of sd(y)


def smoke_data():
    """Low-rank design with a decaying kernel spectrum (lastkeeper ≈ 219
    of 3106 at eigtrunc 0.001) and one binary column."""
    rng = np.random.default_rng(SEED)
    Z = rng.normal(size=(N, 6))
    W = rng.normal(size=(6, P))
    X = Z @ W + 0.3 * rng.normal(size=(N, P))
    X[:, P - 1] = (X[:, 0] > 0)
    y = X @ rng.normal(size=P) / np.sqrt(P) + np.sin(2 * X[:, 0]) \
        + rng.normal(size=N)
    return y, X


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


def check_k1(X_std, failures):
    """K1 vs its plain version at every shape; returns (max |Δ|, kernel
    ms, plain ms) at the fit's shape."""
    from bigkrls_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst, fit_ms = 0.0, None
    for m, n, p, sym in K1_SHAPES:
        if (m, n, p) == (N, N, P):
            A = X_std
        else:
            A = torch.randn((m, p), generator=gen, device="cuda")
        B = A if sym else torch.randn((n, p), generator=gen, device="cuda")
        if (m, n, p) == (517, N, P):
            B = X_std
        sigma = float(p)
        K = kernels.gauss_tile(A, B, sigma, sym)
        ref = kernels.gauss_tile_plain(A, B, sigma, sym)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(K - ref)).item()
        worst = max(worst, err)
        sym_ok = (not sym) or (torch.equal(K, K.T)
                               and bool(torch.all(torch.diagonal(K) == 1.0)))
        t_k = cuda_ms(lambda: kernels.gauss_tile(A, B, sigma, sym))
        t_p = cuda_ms(lambda: kernels.gauss_tile_plain(A, B, sigma, sym))
        print(f"K1 ({m},{n},P={p},sym={sym}): max|d|={err:.3e} "
              f"symmetric/diag ok={sym_ok} kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms", flush=True)
        if not err <= K1_TOL:
            failures.append(f"K1 {m}x{n} P={p}: max|d| {err} > {K1_TOL}")
        if not sym_ok:
            failures.append(f"K1 {m}x{n} P={p}: not bit-symmetric with "
                            "an exact diagonal")
        if (m, n, p, sym) == (N, N, P, True):
            fit_ms = (t_k, t_p)
        del K, ref
    return worst, fit_ms


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def compare(m_gpu, m_cpu, pred_gpu, pred_cpu, y, failures):
    checks = [
        ("lambda rel", rel(m_gpu.lambda_, m_cpu.lambda_), TOL_LAMBDA_REL),
        ("LOO error rel", rel(m_gpu.looe, m_cpu.looe), TOL_LOOE_REL),
        ("Neff rel", rel(m_gpu.neffective, m_cpu.neffective), TOL_NEFF_REL),
        ("R2 abs", abs(m_gpu.R2 - m_cpu.R2), TOL_R2_ABS),
        ("AME / max|AME|",
         float(np.max(np.abs(m_gpu.avgderivatives - m_cpu.avgderivatives))
               / np.max(np.abs(m_cpu.avgderivatives))), TOL_AME_FRAC),
        ("predict / sd(y)",
         float(np.max(np.abs(pred_gpu.predicted - pred_cpu.predicted))
               / np.std(y, ddof=1)), TOL_PRED_FRAC),
    ]
    for name, val, tol in checks:
        ok = val <= tol
        print(f"  {name}: {val:.3e} (limit {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"end to end {name}: {val} > {tol}")
    lk = (m_gpu.lastkeeper, m_cpu.lastkeeper)
    print(f"  lastkeeper gpu/cpu: {lk[0]}/{lk[1]}")
    if lk[0] != lk[1]:
        failures.append(f"lastkeeper differs: {lk}")


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
    from bigkrls_tpu_torch.ops import _build, kernels

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

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s)", flush=True)
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:" + line.split(":", 1)[-1])

    y, X = smoke_data()
    Xd = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    X_std = ((Xd - Xd.mean(0)) / Xd.std(0, correction=1)).contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_err, (k1_ms, plain_ms) = check_k1(X_std, failures)

    # ---- the main path: fit, summary, predict on the card ----
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

    t0 = time.perf_counter()
    m_warm = bt.fit(y, X, device="cuda", noisy=False)
    print(f"warm fit: {time.perf_counter() - t0:.3f} s, timings "
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

    print(json.dumps({"kernels": [{
        "name": "gauss_tile", "route": "cuda",
        "source": "bigkrls_tpu_torch/csrc/gauss_kernel.cu",
        "replaces": "bigkrls_tpu/ops/kernels.py:87",
        "launches": launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
