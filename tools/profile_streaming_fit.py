#!/usr/bin/env python3
"""Where the time goes in the port's streaming fit on one CUDA card.

    python3 tools/profile_streaming_fit.py [N] [neig] [--ring D]

Runs ``bigkrls_tpu_torch.fit`` on the N=50,000, P=20, ``neig=500`` streaming
recipe of ``chip_smoke.py`` (cold, then three warm fits timed by the wall
clock), then one more warm fit under ``torch.profiler``. Prints the card
(``nvidia-smi`` name and power limit), the warm fits' phase timings, the
profiled fit's device-busy share and the device time by kernel, K2
(``kernel_matmul_kernel``) first. ``--ring D`` runs the fit over a mesh
of D virtual shards of the card (``fit(mesh=...)``: the ring product, D²
launches of K2's cross entry a product). No JAX is used.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.ops import _build
    args = sys.argv[1:]
    ring = 0
    if "--ring" in args:
        i = args.index("--ring")
        ring = int(args[i + 1])
        del args[i:i + 2]
    n = int(args[0]) if len(args) > 0 else 50_000
    neig = int(args[1]) if len(args) > 1 else 500
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.library()
    rng = np.random.default_rng(2016)
    X = rng.normal(size=(n, 20))
    y = np.sin(X[:, 0]) + X @ (0.2 * np.ones(20)) + rng.normal(size=n)
    X[:, 4] = (X[:, 4] > 0)
    kw = dict(neig=neig, which_derivatives=[0, 1, 2, 3, 4], device="cuda",
              noisy=False)
    if ring:
        from bigkrls_tpu_torch.parallel.sharded import make_mesh
        kw["mesh"] = make_mesh(devices=[torch.device("cuda", 0)] * ring)

    def timed():
        t0 = time.perf_counter()
        m = bt.fit(y, X, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, m

    cold, m = timed()
    print(f"N={n} P=20 neig={neig}"
          f"{f' over a ring of {ring} shards' if ring else ''}: eig_path "
          f"{m.eig_path}, cold fit {cold:.3f} s")
    for _ in range(3):
        s, m = timed()
        print(f"warm fit {s:.4f} s, timings {json.dumps(m.timings)}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, m = timed()
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    print(f"profiled warm fit: {wall * 1e3:.1f} ms wall, {busy:.1f} ms of "
          f"device time: busy {100 * busy / (wall * 1e3):.1f}%, idle "
          f"{100 - 100 * busy / (wall * 1e3):.1f}% (profiler overhead "
          "included)")
    k2 = [r for r in rows if "kernel_matmul_kernel" in r[0]]
    k2_ms = sum(r[1] for r in k2)
    print(f"K2: {k2_ms:.1f} ms in {sum(r[2] for r in k2)} launches, "
          f"{100 * k2_ms / busy:.1f}% of device time, "
          f"{100 * k2_ms / (wall * 1e3):.1f}% of the wall clock")
    print("device time by kernel (ms, calls):")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:14]:
        print(f"  {ms:9.2f}  {count:5d}  {key[:100]}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
