"""The port's benchmark: root ``bench.py``'s metrics, on a CUDA card.

    python -m bigkrls_tpu_torch bench [--device cuda] [--election-csv F]
                                      [--census-csv F]

The JAX package's ``bench.py`` timed the JAX programs on a TPU; this module
times their counterparts in this package, under the same metric names,
units and order, with the same timed regions:

* ``krls_postkernel_fit_n3106_p67_s`` (the primary, printed last): the
  default fit's post-kernel region, ``ops/adaptive.postkernel_adaptive``
  on a built K (eigensolver, λ search, coefficients and the vcov filter;
  the kernel and the derivatives outside), one warm-up run and then 9
  timed runs (``value_min``, ``value_median``, ``reps``);
* ``krls_postkernel_fit_dense_n3106_s``: ``ops/fused.postkernel_device``
  (dense ``eigh``, λ search, solve), best of 2 after a warm-up;
* ``krls_postkernel_fit_neig50_n3106_s``: the reference's "Estimating
  Fewer" protocol, ``ops/eig.eigensystem(neig=50, eigtrunc=0.01)`` then
  ``lambda_search.lambda_search_solve``; the record is ``method="auto"``
  (block-Krylov), the dense ``eigh``-then-slice time is logged beside it;
* the derivatives of every column (``ops/effects.derivatives_all``),
  logged only, as in the JAX bench;
* ``krls_cv_census_ptesting20_neig50_s``: one ``crossvalidate(ptesting=20,
  neig=50)`` call of the census replication protocol, best of seeds 2-3
  after seed 1;
* on a CUDA device only (the JAX bench ran them on a TPU only), the
  kernel-free streaming fits at N = 50,000, 100,000, 500,000 and 1,000,000
  (P = 20, ``neig=500``, five derivative columns, the JAX recipe and seed,
  so R² compares with the JAX run) and one K(X)·V product of the fit's
  block width at N = 100,000 and 1,000,000 (``..._tflops``), K2 beside its
  bound and, at 100,000, beside the plain product.

The timed regions run under ``utils/precision.matmul_precision("highest")``
(TF32 off, K2 in its precise mode), as ``fit`` does, and every clock read
follows ``torch.cuda.synchronize()``. ``vs_baseline`` divides the
reference R times (``BASELINE.md``) by the port's; no TPU number enters.

Data: ``--election-csv`` (y in column 0, the 67 covariates after it) and
``--census-csv`` (the census replication file: y in column 1, X from
column 2); without them both parts run on :func:`smoke_data`, a seeded
low-rank design of the election data's shape on which the default fit
takes the adaptive route. Every record says which data it ran on.

Budget (``BENCH_BUDGET_S``, default 1500 s): it is checked before every
secondary; a secondary with too little time left gives a ``skipped``
record, and one that fails its retries a ``failed`` record, so that no
metric silently goes missing. A record made under the retries says how
many attempts it took (``attempts``) and, after a failed one, the first
error (``first_error``): a secondary that passed only on a retry shows.
Every record carries the card's name and
power limit, the torch and CUDA versions, and whether the kernel library
was built by this process (``kernel_library_build_s``, 0 when it was
loaded from ``ops/_build``'s cache).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from .crossvalidate import crossvalidate
from .lambda_search import lambda_search_solve
from .model import fit
from .ops import _build, matvec
from .ops.adaptive import postkernel_adaptive
from .ops.effects import derivatives_all
from .ops.eig import eigensystem
from .ops.fused import postkernel_device
from .ops.kernels import kernel_matrix
from .types import Eigensystem
from .utils import memory
from .utils.precision import matmul_precision

N, P = 3106, 67
SEED = 2016
# the reference's post-kernel fit on the election data (BASELINE.md):
# default eigtrunc, and Neig=50
BASELINE_S = 31.389
BASELINE_NEIG50_S = 18.907
DEFAULT_BUDGET_S = 1500.0
RETRIES = 3

# the streaming secondaries: the JAX bench's recipe
STREAM_P, STREAM_NEIG = 20, 500
STREAM_DERIVATIVES = [0, 1, 2, 3, 4]
STREAM_Q = STREAM_NEIG + 40          # the fit's Krylov block width
CHECK_ROWS = 256   # rows from each end of a product too big for the plain one

# published H100 SXM peaks, for the bounds (dense rates, 700 W)
PEAK_FP32, PEAK_TF32, PEAK_HBM = 67e12, 495e12, 3.35e12
# tile·V passes K2 runs on the tensor cores, per mode
K2_PASSES = {"split": 3, "fast": 1}

PRIMARY = "krls_postkernel_fit_n3106_p67_s"
# every metric, in the order the bench prints them (the primary last)
METRICS = (
    "krls_postkernel_fit_dense_n3106_s",
    "krls_postkernel_fit_neig50_n3106_s",
    "krls_cv_census_ptesting20_neig50_s",
    "krls_streaming_fullfit_n50000_p20_s",
    "krls_streaming_fullfit_n100000_p20_s",
    "streaming_product_n100000_tflops",
    "krls_streaming_fullfit_n50000_p20_fastpower_s",
    "krls_streaming_fullfit_n500000_p20_s",
    "streaming_product_n1000000_tflops",
    "krls_streaming_fullfit_n1000000_p20_s",
    PRIMARY,
)
FALLBACK = ("low-rank fallback: smoke_data(), 6 factors + 0.3 noise, one "
            "binary column, seed 2016")


def smoke_data(n: Optional[int] = None, p: Optional[int] = None,
               seed: int = SEED):
    """Low-rank design with a decaying kernel spectrum (lastkeeper ≈ 219
    of 3106 at eigtrunc 0.001; the election data's is 225) and one binary
    column: the fallback for the election and census CSVs. ``n`` and ``p``
    default to the module's ``N`` and ``P``."""
    n = N if n is None else n
    p = P if p is None else p
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, 6))
    W = rng.normal(size=(6, p))
    X = Z @ W + 0.3 * rng.normal(size=(n, p))
    X[:, p - 1] = (X[:, 0] > 0)
    y = X @ rng.normal(size=p) / np.sqrt(p) + np.sin(2 * X[:, 0]) \
        + rng.normal(size=n)
    return y, X


def streaming_data(n: int, p: int = STREAM_P, seed: int = SEED):
    """The JAX bench's streaming recipe: iid normal X, y = sin(x₀) +
    0.2·ΣX + noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    y = np.sin(X[:, 0]) + X @ (0.2 * np.ones(p)) + rng.normal(size=n)
    return y, X


# the device memory the JAX package plans against on its chip (its
# ``utils/memory.DEFAULT_BUDGET``, 8 GiB): under it the streaming fit at
# P=20, ``neig=500`` takes the constant-memory flow from N ≈ 170,500, as the
# JAX bench's 500k and 1M fits did
JAX_CHIP_BUDGET = 8 * 1024 ** 3


@contextlib.contextmanager
def planning_budget(nbytes: int):
    """Inside the block, ``utils.memory.device_memory_budget`` answers
    ``nbytes`` for every device; restored on the way out, also after an
    error. The streaming solver's flow choice (``ops/eig._auto_krylov``)
    reads it, so a fit inside the block takes the flow it would take on a
    device of that memory."""
    real = memory.device_memory_budget
    memory.device_memory_budget = lambda device=None, default=None: nbytes
    try:
        yield
    finally:
        memory.device_memory_budget = real


def k1_bound_ms(m, n, p):
    """(ms, bound_by): 2MNP fp32 operations over the SIMT peak, or A and B
    read once and K written once over the memory rate, whichever is larger;
    counted for the whole matrix, whether or not the kernel mirrors tiles."""
    t_ops = 2 * m * n * p / PEAK_FP32
    t_bytes = 4 * (m * p + n * p + m * n) / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def k2_bound_ms(n, p, m, mode):
    """(ms, bound_by): the larger of the bytes (X, V read once, Y written
    once) over the memory rate and the operations the kernel runs over
    their peaks: the 2N²P rank-P part in fp32, and tile·V as one (fast) or
    three (split) TF32 passes of 2N²m each, or in fp32 (fma)."""
    t_bytes = 4 * (n * p + 2 * n * m) / PEAK_HBM
    t_ops = 2 * n * n * p / PEAK_FP32
    if mode == "fma":
        t_ops += 2 * n * n * m / PEAK_FP32
    else:
        t_ops += K2_PASSES[mode] * 2 * n * n * m / PEAK_TF32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def k2_tol(n: int) -> float:
    """K2's precise mode against its plain version, of max|Y|: both sides
    round the tile to f32 (about 1e-6, as K1) and sum N f32 products per
    entry in different orders; the rounding of such a sum grows like
    sqrt(N)·2⁻²⁴, which is 1.3e-5 at N = 50,000."""
    return 1e-5 * max(1.0, (n / 8192) ** 0.5)


# K2's fast mode against its plain version under TF32, of max|Y|: TF32
# keeps 10 mantissa bits (2⁻¹¹ ≈ 5e-4, about 3 digits) of the tile and of
# V, and the kernel and cuBLAS round to TF32 differently, so the two agree
# to a few of those units, not to f32
K2_FAST_TOL = 5e-3


def k2_cross_bound_ms(na, nb, p, m, mode, init: bool = False):
    """(ms, bound_by) of one cross product, as ``k2_bound_ms``: Xa, Xb, V
    (and ``init``, Na×m, where given) read once and Y written once over
    the memory rate, or 2·Na·Nb·P fp32 plus passes·2·Na·Nb·m TF32
    operations over their peaks."""
    t_bytes = 4 * (na * p + nb * p + nb * m + (2 if init else 1) * na * m
                   ) / PEAK_HBM
    t_ops = (2 * na * nb * p / PEAK_FP32
             + K2_PASSES[mode] * 2 * na * nb * m / PEAK_TF32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


# end-to-end limits of a card f32 fit against its reference fit (the CPU
# f64 fit, or the same fit through the plain product; tests/test_adaptive.py
# :181-183)
TOL_LAMBDA_REL = 2e-2   # bounded by the golden search's own stopping rule
TOL_LOOE_REL = 1e-3
TOL_NEFF_REL = 1e-3
TOL_R2_ABS = 1e-4
TOL_AME_FRAC = 1e-2     # of max |AME|
TOL_PRED_FRAC = 1e-3    # of sd(y)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def compare_fits(m, ref, pred, pred_ref, y, failures, log=print,
                 looe_ref_at_lambda=None):
    """Hold fit ``m`` against ``ref`` (and their predictions of the same
    rows) within the limits above and an equal lastkeeper; prints each
    check and appends what fails to ``failures``.

    ``looe_ref_at_lambda``: the reference's LOO error at m's λ* (the
    reference refitted with ``lambda_=m.lambda_``). Where given, m's LOO
    error is held against it, and the two fits' LOO errors at their own λ*
    are printed beside: the λ check bounds how far the λ*s lie apart, and
    where λ* sits on the search's lower bound L, which each fit sets from
    its own trailing eigenvalues, the LOO error moves with L."""
    looe_ref = ref.looe if looe_ref_at_lambda is None else looe_ref_at_lambda
    loo_name = ("LOO error rel" if looe_ref_at_lambda is None else
                f"LOO error rel at the same lambda (at each fit's own: "
                f"{rel(m.looe, ref.looe):.3e})")
    checks = [
        ("lambda rel", rel(m.lambda_, ref.lambda_), TOL_LAMBDA_REL),
        (loo_name, rel(m.looe, looe_ref), TOL_LOOE_REL),
        ("Neff rel", rel(m.neffective, ref.neffective), TOL_NEFF_REL),
        ("R2 abs", abs(m.R2 - ref.R2), TOL_R2_ABS),
        ("AME / max|AME|",
         float(np.max(np.abs(m.avgderivatives - ref.avgderivatives))
               / np.max(np.abs(ref.avgderivatives))), TOL_AME_FRAC),
        ("predict / sd(y)",
         float(np.max(np.abs(pred.predicted - pred_ref.predicted))
               / np.std(y, ddof=1)), TOL_PRED_FRAC),
    ]
    for name, val, tol in checks:
        ok = val <= tol
        log(f"  {name}: {val:.3e} (limit {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"end to end {name}: {val} > {tol}")
    lk = (m.lastkeeper, ref.lastkeeper)
    log(f"  lastkeeper: {lk[0]} / {lk[1]} (reference)")
    if lk[0] != lk[1]:
        failures.append(f"lastkeeper differs: {lk}")


def card(device) -> dict:
    """The device a record ran on: the card's name and power limit (as
    ``nvidia-smi`` gives them) and the torch and CUDA versions."""
    dev = torch.device(device)
    info = {"device": str(dev), "card": "cpu", "power_limit": None,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type != "cuda":
        return info
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    info["card"] = torch.cuda.get_device_name(index)
    info["power_limit"] = "not measured"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return info
    if index < len(smi):
        name, _, limit = smi[index].rpartition(",")
        info.update(card=name.strip(), power_limit=limit.strip())
    return info


def load_election(path: Optional[str] = None):
    """(y, X, data): the election CSV (y = gop_2016_delta in column 0, the
    67 covariates after it), or :func:`smoke_data` without one."""
    if path is None:
        y, X = smoke_data()
        return y, X, FALLBACK
    d = np.genfromtxt(path, delimiter=",", skip_header=1)
    if d.shape != (N, P + 1):
        raise ValueError(f"{path}: expected ({N}, {P + 1}), got {d.shape}")
    return d[:, 0], d[:, 1:], f"{os.path.basename(path)} (real)"


def load_census(path: Optional[str] = None):
    """(y, X, data): the census replication CSV (y in column 1, X from
    column 2), or :func:`smoke_data` without one."""
    if path is None:
        y, X = smoke_data()
        return y, X, FALLBACK
    d = np.genfromtxt(path, delimiter=",", skip_header=1)
    return d[:, 1], d[:, 2:], f"{os.path.basename(path)} (real)"


# ---------------------------------------------------------------------------
# the timed regions (the JAX bench's, on the same K)
# ---------------------------------------------------------------------------

def postkernel_fit_adaptive(K, y_std):
    """The default fit's post-kernel region. Returns ``(eig, lam, coeffs,
    spectrum, k)``; raises if the route declines, since the primary must
    time the adaptive route and no other."""
    n = int(K.shape[0])
    res = postkernel_adaptive(K, y_std, 0.001, 1e-3 * n)
    if res is None:
        raise RuntimeError("the adaptive route declined this design; the "
                           "primary times that route only")
    out, lam, _Le, coeffs, spectrum = res
    return out.eig, lam, coeffs, spectrum, out.k


def postkernel_fit_dense(K, y_std):
    """The fused dense region. Returns ``(eig, lam, coeffs, spectrum)``."""
    n = int(K.shape[0])
    vals, vecs, lk, lam, _Le, coeffs, spectrum, _ = postkernel_device(
        K, y_std, 0.001, 1e-3 * n)
    eig = Eigensystem(values_full=vals, vectors=vecs[:, :lk], lastkeeper=lk)
    return eig, float(lam), coeffs, spectrum[:lk]


def postkernel_fit_neig50(K, y_std, method: str):
    """Neig=50, eigtrunc=0.01: the eigensystem, then bounds, golden search
    and solve. Returns ``(eig, lam, coeffs)``."""
    eig = eigensystem(K, neig=50, eigtrunc=0.01, method=method)
    lam, _Le, coeffs = lambda_search_solve(eig, y_std)
    return eig, lam, coeffs


# ---------------------------------------------------------------------------
# the run: clock, budget, retries, records
# ---------------------------------------------------------------------------

def _log(*a):
    print(*a, file=sys.stderr, flush=True)


class _Run:
    """One bench run: its device, clock, budget and records."""

    def __init__(self, device, budget_s: float, log):
        self.dev = torch.device(device)
        self.budget_s = budget_s
        self.log = log
        self.t_start = time.perf_counter()
        self.metrics = []
        self.common = card(self.dev)
        # inside ``retry``: the attempt under way, and the first error
        self.attempts: Optional[int] = None
        self.first_error: Optional[str] = None

    def now(self) -> float:
        """The host clock, after the device has finished queued work."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def left(self) -> float:
        return self.budget_s - (time.perf_counter() - self.t_start)

    def record(self, metric: str, value, unit: str = "s", vs_baseline=None,
               **fields):
        rec = {"metric": metric, "value": value, "unit": unit,
               "vs_baseline": vs_baseline, **fields, **self.common}
        if self.attempts is not None:
            rec["attempts"] = self.attempts
            if self.first_error is not None:
                rec["first_error"] = self.first_error
        self.metrics.append(rec)
        return rec

    def have_budget(self, label: str, need_s: float = 0.0,
                    metric: Optional[str] = None, unit: str = "s") -> bool:
        """False, with a ``skipped`` record for ``metric``, when no more
        than ``need_s`` seconds of the budget are left."""
        left = self.left()
        if left > need_s:
            return True
        self.log(f"skipping {label}: {self.budget_s - left:.0f}s elapsed, "
                 f"{left:.0f}s left, {need_s:.0f}s needed (BENCH_BUDGET_S="
                 f"{self.budget_s:.0f}); the primary metric prints last")
        if metric is not None:
            self.record(metric, None, unit, skipped=f"budget ({left:.0f}s "
                                                    f"left)")
        return False

    def retry(self, label: str, fn, metric: Optional[str] = None,
              unit: str = "s") -> bool:
        """Run a secondary up to ``RETRIES`` times (not again once the
        budget is spent); after the last failure, a ``failed`` record for
        ``metric``. Every record made meanwhile carries ``attempts`` (and
        ``first_error`` after a failed attempt). Returns True on success."""
        last = None
        try:
            for attempt in range(1, RETRIES + 1):
                self.attempts = attempt
                try:
                    fn()
                    return True
                except Exception as e:   # noqa: BLE001 — the primary prints
                    last = repr(e)
                    if self.first_error is None:
                        self.first_error = last
                    self.log(f"{label} attempt {attempt}/{RETRIES} failed:\n"
                             f"{traceback.format_exc()}")
                # the traceback's frames are gone: free their device memory
                if self.dev.type == "cuda":
                    torch.cuda.empty_cache()
                if attempt < RETRIES and self.left() <= 0:
                    self.log(f"{label}: budget spent after {attempt} "
                             "attempt(s); not retrying")
                    break
            if metric is not None:
                self.record(metric, None, unit, failed=last)
            return False
        finally:
            self.attempts = self.first_error = None


def _tflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e12


def main(device: str = "cuda", election_csv: Optional[str] = None,
         census_csv: Optional[str] = None, out=None, log=_log) -> int:
    """Run the benchmark on ``device`` and print one JSON record per line
    to ``out`` (standard output by default), the primary last."""
    out = sys.stdout if out is None else out
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: a CUDA device was asked for and "
                           "torch.cuda.is_available() is False")
    budget = float(os.environ.get("BENCH_BUDGET_S", DEFAULT_BUDGET_S))
    run = _Run(dev, budget, log)
    run.common["kernel_library_build_s"] = _load_library(dev)
    log(f"bench on {run.common['card']} ({run.common['power_limit']}), torch "
        f"{run.common['torch']}, CUDA {run.common['cuda']}; kernel library "
        f"build {run.common['kernel_library_build_s']} s")
    with matmul_precision("highest"):
        primary = _dense_part(run, election_csv, census_csv)
        if dev.type == "cuda":
            _streaming_secondaries(run)
    for rec in run.metrics:
        print(json.dumps(rec), file=out, flush=True)
    print(json.dumps(primary), file=out, flush=True)
    return 0


def _load_library(dev) -> Optional[float]:
    """Seconds this process spent building the CUDA kernel library (0.0
    when it was loaded from the build cache); None off CUDA."""
    if dev.type != "cuda":
        return None
    _build.library()
    return round(_build.last_build_seconds, 3)


def _dense_part(run: _Run, election_csv, census_csv) -> dict:
    """The kernel, the primary and the N=3106 secondaries; returns the
    primary's record (printed last by the caller)."""
    dev, log = run.dev, run.log
    y, X, data = load_election(election_csv)
    n, p = X.shape
    log(f"data: {data}  N={n} P={p}")
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = (y - y.mean()) / y.std(ddof=1)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=dev)
    yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
    sigma = float(p)

    # ---- the kernel (outside every timed region below) ----
    t = run.now()
    K = kernel_matrix(Xd, sigma)
    first = run.now() - t
    reps = 10
    t = run.now()
    for _ in range(reps):
        K = kernel_matrix(Xd, sigma)
    kernel_s = (run.now() - t) / reps
    bound, by = k1_bound_ms(n, n, p)
    log(f"kernel: first call {first:.4f}s, then {kernel_s * 1e3:.3f} ms "
        f"[{_tflops(2.0 * n * n * p, kernel_s):.2f} TFLOP/s @ 2N^2P; H100 "
        f"bound {bound:.4f} ms ({by})]")

    # ---- the primary: one warm-up, then 9 timed runs ----
    t = run.now()
    eig, lam, coeffs, spectrum, k_used = postkernel_fit_adaptive(K, yd)
    cold = run.now() - t
    log(f"adaptive post-kernel warm-up: {cold:.4f}s  lambda={lam:.6g} "
        f"lastkeeper={eig.lastkeeper} k={k_used}")
    times = []
    for _ in range(9):
        t = run.now()
        eig, lam, coeffs, spectrum, k_used = postkernel_fit_adaptive(K, yd)
        times.append(run.now() - t)
    best, median = float(np.min(times)), float(np.median(times))
    log(f"adaptive post-kernel fit over {len(times)} runs: min {best:.4f}s "
        f"median {median:.4f}s max {max(times):.4f}s")
    primary = {
        "metric": PRIMARY, "value": round(best, 6), "unit": "s",
        "vs_baseline": round(BASELINE_S / best, 2),
        "value_min": round(best, 6), "value_median": round(median, 6),
        "reps": len(times), "value_cold": round(cold, 6),
        "route": f"adaptive-krylov:k={k_used}", "lambda": lam,
        "lastkeeper": eig.lastkeeper, "kernel_ms": kernel_s * 1e3,
        "data": data, **run.common}

    # ---- secondary: the fused dense region ----
    def dense():
        postkernel_fit_dense(K, yd)
        best_d = np.inf
        for _ in range(2):
            t = run.now()
            _, lam_d, _, _ = postkernel_fit_dense(K, yd)
            best_d = min(best_d, run.now() - t)
        log(f"fused dense post-kernel fit: {best_d:.4f}s lambda={lam_d:.6g} "
            f"(the adaptive region is {best_d / best:.1f}x faster)")
        run.record("krls_postkernel_fit_dense_n3106_s", round(best_d, 6),
                   vs_baseline=round(BASELINE_S / best_d, 2), data=data,
                   **{"lambda": lam_d})

    m = "krls_postkernel_fit_dense_n3106_s"
    if run.have_budget("dense secondary", metric=m):
        run.retry("dense secondary", dense, m)

    # ---- secondary: the reference's "Estimating Fewer" protocol ----
    def neig50():
        best50 = {}
        for method in ("auto", "full"):
            postkernel_fit_neig50(K, yd, method)
            b = np.inf
            for _ in range(2):
                t = run.now()
                postkernel_fit_neig50(K, yd, method)
                b = min(b, run.now() - t)
            best50[method] = b
        log(f"Neig=50 eigtrunc=0.01 post-kernel fit: block-Krylov "
            f"{best50['auto']:.4f}s, dense eigh-then-slice "
            f"{best50['full']:.4f}s (reference ARPACK {BASELINE_NEIG50_S}s)")
        run.record("krls_postkernel_fit_neig50_n3106_s",
                   round(best50["auto"], 6),
                   vs_baseline=round(BASELINE_NEIG50_S / best50["auto"], 2),
                   value_full_eigh=round(best50["full"], 6), data=data)

    m = "krls_postkernel_fit_neig50_n3106_s"
    if run.have_budget("neig50 secondary", metric=m):
        run.retry("Neig=50 secondary", neig50, m)

    # ---- secondary: every column's derivatives (logged only) ----
    if run.have_budget("derivatives secondary"):
        run.retry("derivatives secondary", lambda: _derivatives_secondary(
            run, X, Xd, yd, K, coeffs, spectrum, eig, sigma))

    # ---- secondary: the census replication protocol ----
    m = "krls_cv_census_ptesting20_neig50_s"
    if run.have_budget("census CV secondary", metric=m):
        run.retry("census CV secondary",
                  lambda: _cv_secondary(run, census_csv), m)
    del K
    return primary


def _derivatives_secondary(run, X, Xd, yd, K, coeffs, spectrum, eig, sigma):
    n, p = X.shape
    bmask = torch.as_tensor([np.unique(X[:, j]).size == 2 for j in range(p)],
                            device=run.dev)
    z0, z1 = Xd.amin(0), Xd.amax(0)
    resid = yd - K @ coeffs
    spec = (torch.sum(resid * resid) / n) * spectrum[:eig.lastkeeper]

    def dispatch():
        return derivatives_all(Xd, K, coeffs, eig.vectors, spec, sigma,
                               bmask, z0, z1)

    dispatch()
    reps = 10
    t = run.now()
    for _ in range(reps):
        dispatch()
    deriv_s = (run.now() - t) / reps
    run.log(f"all-{p}-column derivatives + AME variances: {deriv_s:.4f}s "
            f"[{_tflops(2.0 * n * n * (p + eig.lastkeeper), deriv_s):.2f} "
            f"TFLOP/s @ 2N^2(P+k)]")


def _cv_secondary(run, census_csv):
    """One census-protocol ``crossvalidate`` call: seed 1 (cold), then the
    best of seeds 2 and 3."""
    yc, Xc, data = load_census(census_csv)
    kw = dict(ptesting=20, neig=50, noisy=False, device=run.dev)
    t = run.now()
    crossvalidate(yc, Xc, seed=1, **kw)
    cold = run.now() - t
    best, r2s = np.inf, []
    for seed in (2, 3):
        t = run.now()
        cv = crossvalidate(yc, Xc, seed=seed, **kw)
        best = min(best, run.now() - t)
        r2s.append(float(cv["pseudoR2_oos"]))
    run.log(f"census CV (ptesting=20, Neig=50): cold {cold:.3f}s, per-seed "
            f"warm {best:.4f}s (oos R2 {', '.join(f'{r:.3f}' for r in r2s)})")
    run.record("krls_cv_census_ptesting20_neig50_s", round(best, 6),
               value_cold=round(cold, 6), route=cv.trained.eig_path,
               pseudoR2_oos=r2s, data=data)


# ---------------------------------------------------------------------------
# the streaming secondaries (a CUDA device only)
# ---------------------------------------------------------------------------

def _launched(before) -> list:
    """K2's launches since ``before`` (a copy of
    ``ops/matvec.kernel_matmul_shapes``), as sorted ``[N, Nb, P, m, mode,
    count]`` rows."""
    diff = matvec.kernel_matmul_shapes - before
    return sorted([*key, c] for key, c in diff.items())


def launch_floor_s(launched) -> float:
    """The seconds ``launched`` (rows of :func:`_launched`) would take at
    K2's bound: each launch priced by ``k2_bound_ms`` (square) or
    ``k2_cross_bound_ms`` (cross)."""
    ms = 0.0
    for n, nb, p, m, mode, count in launched:
        one = (k2_bound_ms(n, p, m, mode) if nb == 0
               else k2_cross_bound_ms(n, nb, p, m, mode))[0]
        ms += count * one
    return ms / 1e3


def _streaming_fit(run: _Run, n: int, metric: str, fast_power=False,
                   warm_reps: int = 2, note: str = ""):
    """A full streaming fit (derivatives included), cold, then warm
    ``warm_reps − 1`` times; the record's value is the best warm time (the
    cold time with ``warm_reps=1``), with the warm fit's phases, the peak
    memory of each fit, and the products' floor at K2's bound."""
    dev = run.dev
    y, X = streaming_data(n)
    kw = dict(neig=STREAM_NEIG, streaming=True, noisy=False,
              which_derivatives=STREAM_DERIVATIVES, device=dev)
    if fast_power is not None:       # None: the package's default ("auto")
        kw["fast_eig_power"] = fast_power

    def one():
        torch.cuda.reset_peak_memory_stats(dev)
        t = run.now()
        model = fit(y, X, **kw)
        sec = run.now() - t
        return model, sec, torch.cuda.max_memory_allocated(dev) / 2 ** 30

    before = matvec.kernel_matmul_shapes.copy()
    m, cold, peak_cold = one()
    launched = _launched(before)
    warm, peak = np.inf, peak_cold
    for _ in range(warm_reps - 1):
        m = None
        m, sec, peak = one()
        warm = min(warm, sec)
    if warm_reps == 1:
        warm = cold
    floor_s = launch_floor_s(launched)
    k2 = sum(row[-1] for row in launched)
    k2_fast = sum(row[-1] for row in launched if row[4] == "fast")
    phases = {d["phase"]: d["seconds"] for d in m.timings}
    run.log(f"N={n} streaming full fit{note}: cold {cold:.3f}s, warm "
            f"{warm:.3f}s (R2={m.R2:.4f}, lambda={m.lambda_:.6g}, "
            f"lastkeeper={m.lastkeeper}); K2 launches (N, Nb, P, m, mode, "
            f"count) {launched}, {k2} ({k2_fast} fast); floor "
            f"at K2's bound {floor_s:.3f}s; peak {peak:.2f} GiB; phases "
            f"{phases}")
    run.record(metric, round(warm, 6), value_cold=round(cold, 6),
               R2=m.R2, **{"lambda": m.lambda_}, lastkeeper=m.lastkeeper,
               eig_path=m.eig_path, timings=phases, products=launched,
               k2_launches=k2, k2_fast_launches=k2_fast,
               product_floor_s=round(floor_s, 6),
               peak_memory_gib=round(peak, 4),
               peak_memory_gib_cold=round(peak_cold, 4),
               data=f"JAX bench streaming recipe, N={n}, P={STREAM_P}, seed "
                    f"{SEED}")
    del m
    torch.cuda.empty_cache()


def _streaming_roofline(run: _Run, n: int, reps: int, warmup: int,
                        plain: bool):
    """One K(X)·V product at the fit's block width: K2's time, its
    TFLOP/s at 2N²(P+m) and its bound; with ``plain``, the plain product's
    time beside it (the JAX bench's "alternative"). K2's result is held
    against the plain product within ``k2_tol(n)`` of max|Y|: every row
    with ``plain``, else the first and last ``CHECK_ROWS`` rows (the plain
    cross product of those rows against all of X); over it, this raises."""
    dev, p, m = run.dev, STREAM_P, STREAM_Q
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    X = torch.randn((n, p), generator=gen, device=dev)
    V = torch.randn((n, m), generator=gen, device=dev)

    def timed(fn):
        for _ in range(warmup):
            fn()
        t = run.now()
        for _ in range(reps):
            fn()
        return (run.now() - t) / reps

    sigma = float(p)
    Y = matvec.kernel_matmul(X, V, sigma)
    if plain:
        ref = matvec.kernel_matmul_plain(X, V, sigma)
    else:
        rows = torch.cat([torch.arange(CHECK_ROWS, device=dev),
                          torch.arange(n - CHECK_ROWS, n, device=dev)])
        ref, Y = matvec.kernel_matmul_plain(X[rows], V, sigma, Xb=X), Y[rows]
    checked = int(ref.shape[0])
    err = float((Y - ref).abs().max())
    rel_err, tol = err / float(ref.abs().max()), k2_tol(n)
    del Y, ref
    run.log(f"N={n} K2 vs the plain product on {checked} rows: "
            f"max|d|/max|Y| {rel_err:.3e} (limit {tol:.1e})")
    if not rel_err <= tol:
        raise RuntimeError(f"K2 at ({n}, {p}, {m}) differs from the plain "
                           f"product by {rel_err:.3e} of max|Y|, over "
                           f"k2_tol {tol:.1e}")
    t_k = timed(lambda: matvec.kernel_matmul(X, V, sigma))
    t_p = timed(lambda: matvec.kernel_matmul_plain(X, V, sigma)) \
        if plain else None
    flops = 2.0 * n * n * (p + m)
    bound, by = k2_bound_ms(n, p, m, "split")
    rate = _tflops(flops, t_k)
    run.log(f"N={n} streaming product (K2, precise): {t_k * 1e3:.2f} ms, "
            f"{rate:.2f} TFLOP/s @ 2N^2(P+m); H100 bound {bound:.2f} ms "
            f"({by}), {100 * bound / (t_k * 1e3):.0f}% of it"
            + (f"; plain product {t_p * 1e3:.2f} ms" if plain else ""))
    run.record(f"streaming_product_n{n}_tflops", round(rate, 4),
               unit="TFLOP/s", ms=t_k * 1e3, bound_ms=bound, bound_by=by,
               plain_ms=None if t_p is None else t_p * 1e3, shape=[n, p, m],
               max_abs_err=err, max_rel_err=rel_err, tol=tol,
               checked_rows=checked, reps=reps,
               data=f"torch.randn (seed 0), N={n}, P={p}, m={m}")
    del X, V
    torch.cuda.empty_cache()


def _streaming_secondaries(run: _Run):
    """The JAX bench's streaming secondaries and gates, in its order."""
    log = run.log
    log("at streaming scale the kernel is rebuilt inside every K(X)·V "
        "product (ops/matvec.py, K2): its cost is inside the fit times")
    m = "krls_streaming_fullfit_n50000_p20_s"
    if run.have_budget("N=50k streaming secondary", metric=m):
        run.retry("N=50k secondary", lambda: _streaming_fit(run, 50_000, m),
                  m)
    m = "krls_streaming_fullfit_n100000_p20_s"
    if run.have_budget("N=100k streaming secondary", metric=m):
        run.retry("N=100k secondary",
                  lambda: _streaming_fit(run, 100_000, m), m)
    m = "streaming_product_n100000_tflops"
    if run.have_budget("N=100k product", metric=m, unit="TFLOP/s"):
        run.retry("N=100k product", lambda: _streaming_roofline(
            run, 100_000, reps=3, warmup=1, plain=True), m, "TFLOP/s")
    m = "krls_streaming_fullfit_n50000_p20_fastpower_s"
    if run.have_budget("N=50k fast-power streaming secondary", metric=m):
        run.retry("N=50k fast-power secondary", lambda: _streaming_fit(
            run, 50_000, m, fast_power=True, note=" (fast_eig_power)"), m)
    m = "krls_streaming_fullfit_n500000_p20_s"
    if run.have_budget("N=500k streaming secondary", need_s=700.0, metric=m):
        run.retry("N=500k secondary", lambda: _streaming_fit(
            run, 500_000, m, fast_power=None, note=" (default config)"), m)
    m = "streaming_product_n1000000_tflops"
    if run.have_budget("N=1M product", need_s=240.0, metric=m,
                       unit="TFLOP/s"):
        run.retry("N=1M product", lambda: _streaming_roofline(
            run, 1_000_000, reps=1, warmup=0, plain=False), m, "TFLOP/s")
    m = "krls_streaming_fullfit_n1000000_p20_s"
    if run.have_budget("N=1M streaming full fit", need_s=700.0, metric=m):
        run.retry("N=1M secondary", lambda: _streaming_fit(
            run, 1_000_000, m, fast_power=None, warm_reps=1,
            note=" (default config, single run)"), m)
