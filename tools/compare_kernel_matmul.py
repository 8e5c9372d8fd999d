#!/usr/bin/env python3
"""Time the public ``kernel_matmul`` of several checkouts in one call.

    python3 tools/compare_kernel_matmul.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``bigkrls_tpu_torch`` package (this
checkout is ``.``; an older commit can be unpacked beside it with
``git archive <commit> bigkrls_tpu_torch | tar -x -C <dir>``). The roots
are timed one after the other, each in a process of its own, in the order
given, so ``old new new old`` compares two kernels on one card within one
run. Per root: the CUDA kernel in precise and fast mode at (50000, 20, 540),
(50000, 20, 22) and (1000, 67, 130), and the plain version under TF32 at
the first shape; medians (and the range) of 20 CUDA-event-timed launches
after 3 warm-ups, in milliseconds. No JAX is used.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

SHAPES = [(50000, 20, 540), (50000, 20, 22), (1000, 67, 130)]


def ms(fn, reps: int = 20, warmup: int = 3):
    import torch
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
    return statistics.median(times), min(times), max(times)


def time_root(root: str) -> int:
    import torch
    sys.path.insert(0, root)
    from bigkrls_tpu_torch.ops import _build, matvec
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for n, p, m in SHAPES:
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        runs = [("precise", lambda: matvec.kernel_matmul(X, V, float(p))),
                ("fast", lambda: matvec.kernel_matmul(X, V, float(p),
                                                      fast_accum=True))]
        if (n, p, m) == SHAPES[0]:
            runs.append(("plain TF32", lambda: matvec.kernel_matmul_plain(
                X, V, float(p), fast_accum=True)))
        for name, fn in runs:
            med, lo, hi = ms(fn)
            print(f"{root} ({n},{p},{m}) {name}: median {med:.4f} ms "
                  f"(min {lo:.4f}, max {hi:.4f})", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        return time_root(sys.argv[2])
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", root]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
