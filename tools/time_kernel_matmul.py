#!/usr/bin/env python3
"""Time the kernel-free product kernel (K2) on one CUDA card.

    python3 tools/time_kernel_matmul.py [--shapes N,P,m ...] [--reps R]
    python3 tools/time_kernel_matmul.py --ablate [--reps R]
    python3 tools/time_kernel_matmul.py --cross [--shapes Na,Nb,P,m ...]

Without ``--ablate``: at each (N, P, m) shape, the CUDA kernel in its three
modes, as columns: split (precise: three TF32 tensor-core passes), fast (one
TF32 pass) and fma (the IEEE fp32 pass without tensor cores), with the width
of the block's tile chosen by the host's rule and forced to every width
that covers no more than twice the columns needed (320 is half of a pair of
blocks that share their K tiles). Beside them the plain
PyTorch version in f32 and under TF32. Prints each mode's error against the
plain version run in float64 on the card (of max|Y|), and checks that the
result is bit-equal across widths and across two runs. Times are medians of
R (default 5) CUDA-event-timed launches after one warm-up, in milliseconds.

With ``--ablate``: at (50000, 20, 540) and (50000, 20, 22) the kernel is
rebuilt with parts switched off at compile time (``-DBIGKRLS_ABLATE_*``):
the tensor-core pass (MMA), the V slices' copies (VLOAD), expf and the
division (EXP), the rank-P FMAs (GRAM); and once with no producer starting
a tile before its previous one has been read (NO_OVERLAP). The differences
attribute the kernel's time to its parts, where no profiler can run; split
minus fast is what the two extra passes and the hi/lo split cost. The
ablated kernels compute garbage and are built into their own libraries.
With ``--cross``: the cross entry ``kernel_matmul_cross(Xa, Xb, V)`` (one
step of the ring product) at (Na, Nb, P, m) shapes, default a ring step of
the N=50,000 fit on 4 shards (12500, 12500, 20, 540), a ragged
(3106, 1553, 67, 22) and a narrow (12500, 12500, 20, 22): split and fast
mode against the plain version (f32, and under TF32 for fast) and against
float64, the square entry's bit-equality with ``kernel_matmul_cross(X, X,
V)``, and the times beside the bound (2·Na·Nb·P fp32 operations plus
3 (split) or 1 (fast) TF32 passes of 2·Na·Nb·m, or the bytes, whichever
is larger; H100 SXM peaks).
No JAX is used.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(1000, 67, 130), (4097, 3, 5), (8192, 20, 1100), (50000, 20, 22),
          (50000, 20, 1), (50000, 20, 230), (50000, 20, 540),
          (50000, 67, 540), (50000, 20, 541)]
MODES = ("split", "fast", "fma")
ABLATIONS = [(), ("NO_OVERLAP",), ("MMA",), ("MMA", "VLOAD"),
             ("MMA", "VLOAD", "EXP"), ("MMA", "VLOAD", "EXP", "GRAM")]
ABLATE_SHAPES = [(50000, 20, 540), (50000, 20, 22)]
CROSS_SHAPES = [(12500, 12500, 20, 540), (3106, 1553, 67, 22),
                (12500, 12500, 20, 22)]
# published H100 SXM peaks (dense, 700 W), as in chip_smoke.py
PEAK_FP32, PEAK_TF32, PEAK_HBM = 67e12, 495e12, 3.35e12


def cross_bound_ms(na, nb, p, m, passes):
    """(ms, bound_by) of one cross product: Xa, Xb, V read once and Y
    written once over the memory rate, or the 2·Na·Nb·P fp32 and
    passes·2·Na·Nb·m TF32 operations over their peaks."""
    t_bytes = 4 * (na * p + nb * p + nb * m + na * m) / PEAK_HBM
    t_ops = 2 * na * nb * p / PEAK_FP32 + passes * 2 * na * nb * m / PEAK_TF32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def cross(gen, shapes, reps) -> bool:
    """The cross entry at each shape; returns False when a check fails."""
    from bigkrls_tpu_torch.ops import matvec
    ok = True
    for na, nb, p, m in shapes:
        Xa = torch.randn((na, p), generator=gen, device="cuda")
        Xb = torch.randn((nb, p), generator=gen, device="cuda")
        V = torch.randn((nb, m), generator=gen, device="cuda")
        sigma = float(p)
        ref64 = matvec.kernel_matmul_plain(Xa.double(), V.double(), sigma,
                                           Xb=Xb.double())
        scale = ref64.abs().max().item()
        ref = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb)
        ref_f = matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb,
                                           fast_accum=True)
        cells = []
        for mode, fast, plain in (("split", False, ref), ("fast", True, ref_f)):
            Y = matvec.kernel_matmul_cross(Xa, Xb, V, sigma, fast_accum=fast)
            torch.cuda.synchronize()
            err = (Y - plain).abs().max().item() / scale
            err64 = (Y - ref64).abs().max().item() / scale
            t = ms(lambda: matvec.kernel_matmul_cross(Xa, Xb, V, sigma,
                                                      fast_accum=fast), reps)
            bound, by = cross_bound_ms(na, nb, p, m, 3 if mode == "split"
                                       else 1)
            cells.append(f"{mode} {t:.3f} ms (bound {bound:.3f}, {by}; err vs "
                         f"plain {err:.2e}, vs f64 {err64:.2e})")
        t_p = ms(lambda: matvec.kernel_matmul_plain(Xa, V, sigma, Xb=Xb),
                 reps)
        Vs = torch.randn((na, m), generator=gen, device="cuda")
        same = all(torch.equal(matvec.kernel_matmul(Xa, Vs, sigma,
                                                    fast_accum=f),
                               matvec.kernel_matmul_cross(Xa, Xa, Vs, sigma,
                                                          fast_accum=f))
                   for f in (False, True))
        ok &= same
        print(f"cross ({na},{nb},P={p},m={m}): " + "; ".join(cells)
              + f"; plain f32 {t_p:.3f} ms; kernel_matmul(X, V) bit-equal to "
              f"kernel_matmul_cross(X, X, V): {same}", flush=True)
        del Xa, Xb, V, Vs, ref64, ref, ref_f
    return ok


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
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


def print_ptxas(log: str):
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "warning",
                                   "setmaxnreg")):
            print("  ptxas:" + line.split(":", 1)[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    from bigkrls_tpu_torch.ops import _build, matvec
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    args = sys.argv[1:]
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 5
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def kernel(X, V, sigma, mode, nt=0):
        return matvec._kernel_matmul_cuda(X, V, sigma, None, None, False,
                                          None, n_tiles=nt, mode=mode)

    if "--cross" in args:
        shapes = CROSS_SHAPES
        if "--shapes" in args:
            shapes = [tuple(int(v) for v in a.split(","))
                      for a in args[args.index("--shapes") + 1:]
                      if not a.startswith("--")]
        _build.library()
        print(f"nvcc {_build.last_build_seconds:.1f} s")
        print_ptxas(_build.last_build_log)
        return 0 if cross(gen, shapes, reps) else 1

    if "--ablate" in args:
        data = []
        for n, p, m in ABLATE_SHAPES:
            data.append((torch.randn((n, p), generator=gen, device="cuda"),
                         torch.randn((n, m), generator=gen, device="cuda")))
        base = _build.COMPILE_FLAGS
        for off in ABLATIONS:
            _build.COMPILE_FLAGS = base + tuple(
                f"-DBIGKRLS_ABLATE_{name}" for name in off)
            _build.library.cache_clear()
            _build.library()
            row = []
            for X, V in data:
                p, m = X.shape[1], V.shape[1]
                row.append(f"m={m}: " + ", ".join(
                    f"{mode} "
                    f"{ms(lambda: kernel(X, V, float(p), mode), reps):.2f}"
                    for mode in MODES))
            print(f"without {'+'.join(off) or 'nothing'}: " + "; ".join(row),
                  flush=True)
        return 0

    shapes = SHAPES
    if "--shapes" in args:
        shapes = []
        for a in args[args.index("--shapes") + 1:]:
            if a.startswith("--"):
                break
            shapes.append(tuple(int(v) for v in a.split(",")))
    _build.library()
    print(f"nvcc {_build.last_build_seconds:.1f} s")
    print_ptxas(_build.last_build_log)
    ok = True
    for n, p, m in shapes:
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        sigma = float(p)
        ref64 = matvec.kernel_matmul_plain(X.double(), V.double(), sigma)
        scale = ref64.abs().max().item()
        ref = matvec.kernel_matmul_plain(X, V, sigma)
        ref_f = matvec.kernel_matmul_plain(X, V, sigma, fast_accum=True)
        print(f"({n},{p},{m}): plain "
              f"{ms(lambda: matvec.kernel_matmul_plain(X, V, sigma), reps):.3f}"
              f" (err vs f64 {(ref - ref64).abs().max().item() / scale:.2e}),"
              f" plain TF32 "
              f"{ms(lambda: matvec.kernel_matmul_plain(X, V, sigma, fast_accum=True), reps):.3f}"
              f" (err {(ref_f - ref64).abs().max().item() / scale:.2e})")
        del ref, ref_f
        plan = matvec._tile_plan(n, p, m, sms)
        widths = [0] + [nt for nt in matvec._N_TILES
                        if nt == plan or 64 * nt <= 2 * max(m, 64)]
        first = {}
        for nt in widths:
            cells = []
            for mode in MODES:
                Y = kernel(X, V, sigma, mode, nt)
                again = kernel(X, V, sigma, mode, nt)
                torch.cuda.synchronize()
                same = torch.equal(Y, again) and torch.equal(
                    Y, first.setdefault(mode, Y))
                ok &= same
                err = (Y - ref64).abs().max().item() / scale
                cells.append(
                    f"{mode} {ms(lambda: kernel(X, V, sigma, mode, nt), reps):.3f}"
                    f" (err {err:.2e}{'' if same else ', BITS DIFFER'})")
            print(f"   width {'rule -> ' + str(64 * plan) if nt == 0 else 64 * nt}: "
                  + ", ".join(cells), flush=True)
        del X, V, ref64, first
    if not ok:
        print("results differ between runs or widths", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
