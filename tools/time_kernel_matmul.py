#!/usr/bin/env python3
"""Time the kernel-free product kernel (K2) on one CUDA card.

    python3 tools/time_kernel_matmul.py            # shapes x m-tile widths
    python3 tools/time_kernel_matmul.py --ablate   # the kernel's parts

Without arguments: at each (N, P, m) shape, the CUDA kernel with its m-tile
width forced to 64·G columns (G = 1, 2, 3) and chosen by the kernel (G = 0),
in precise and fast (TF32) mode, beside the plain PyTorch version in both
modes; checks that the result is bit-equal across G and prints the errors
against the plain version. Times are means of 3 CUDA-event-timed launches
after one warm-up, in milliseconds.

With ``--ablate``: at (50000, 20, 540) the kernel is rebuilt with parts
switched off at compile time (``-DBIGKRLS_ABLATE_*``: the tile·V pass, the
V slice's loads, expf and the division, the rank-P FMAs); the differences
attribute the kernel's time to its parts, where no profiler can run. The
ablated kernels compute garbage and are built into their own libraries.
No JAX is used.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(1000, 67, 130), (4097, 3, 5), (8192, 20, 1100), (50000, 20, 22),
          (50000, 20, 1), (50000, 20, 540), (50000, 67, 540),
          (50000, 20, 541)]
ABLATIONS = [(), ("PASS",), ("PASS", "VLOAD"), ("PASS", "VLOAD", "EXP"),
             ("PASS", "VLOAD", "EXP", "GRAM")]


def ms(fn, reps: int = 3) -> float:
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

    def kernel(X, V, sigma, fast, G):
        return matvec._kernel_matmul_cuda(X, V, sigma, None, None, fast,
                                          None, G)

    if "--ablate" in sys.argv:
        n, p, m = 50000, 20, 540
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        base = _build.COMPILE_FLAGS
        for off in ABLATIONS:
            _build.COMPILE_FLAGS = base + tuple(
                f"-DBIGKRLS_ABLATE_{name}" for name in off)
            _build.library.cache_clear()
            _build.library()
            row = [f"G={G} {'fast' if fast else 'precise'} "
                   f"{ms(lambda: kernel(X, V, float(p), fast, G)):.2f}"
                   for G in (1, 3) for fast in (False, True)]
            print(f"without {'+'.join(off) or 'nothing'}: " + ", ".join(row),
                  flush=True)
        return 0

    _build.library()
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:" + line.split(":", 1)[-1])
    for n, p, m in SHAPES:
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        sigma = float(p)
        ref = matvec.kernel_matmul_plain(X, V, sigma)
        ref_f = matvec.kernel_matmul_plain(X, V, sigma, fast_accum=True)
        scale = ref.abs().max().item()
        first = kernel(X, V, sigma, False, 1)
        print(f"({n},{p},{m}): plain "
              f"{ms(lambda: matvec.kernel_matmul_plain(X, V, sigma)):.3f}, "
              f"plain TF32 "
              f"{ms(lambda: matvec.kernel_matmul_plain(X, V, sigma, fast_accum=True)):.3f}")
        for G in (0, 1, 2, 3):
            Y = kernel(X, V, sigma, False, G)
            Yf = kernel(X, V, sigma, True, G)
            torch.cuda.synchronize()
            print(f"   G={G}: precise "
                  f"{ms(lambda: kernel(X, V, sigma, False, G)):.3f} (err "
                  f"{(Y - ref).abs().max().item() / scale:.2e}, bit-equal "
                  f"to G=1: {torch.equal(Y, first)}), fast "
                  f"{ms(lambda: kernel(X, V, sigma, True, G)):.3f} (err "
                  f"{(Yf - ref_f).abs().max().item() / scale:.2e})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
