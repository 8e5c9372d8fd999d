#!/usr/bin/env python3
"""Block Jacobi (``parallel/jacobi.py``) against ``eigh`` on one CUDA card.

    python3 tools/time_jacobi.py [N ...]

For each N (default 1024 and 2048) the Gaussian kernel of
``chip_smoke.py``'s design (its first N rows, f32, built by the dense
kernel K1) is decomposed by ``torch.linalg.eigh`` and by
``block_jacobi_eigh`` without a mesh and over a 2×2 mesh of virtual
shards of the card, with the 2b×2b pair problems solved in float32 and in
float64 (``jacobi.PAIR_DTYPE``). Prints, beside each time (median of 3,
after one warm-up, synced wall clock), the top-20 eigenvalues' distance
from the float64 ``eigvalsh`` of the same matrix (of λ₁) and the
residual ‖KV − VΛ‖_F/‖K‖_F; and the orthogonality ‖UᵀU − I‖_max of a
batched ``eigh`` of four random symmetric 256×256 matrices in float32 on
the card and on the CPU. No JAX is used.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def timed(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    out, times = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import smoke_data
    from bigkrls_tpu_torch.ops.kernels import gauss_tile
    from bigkrls_tpu_torch.parallel import jacobi
    from bigkrls_tpu_torch.parallel.sharded import make_mesh, place
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for dev in ("cuda", "cpu"):
        M = torch.randn((4, 256, 256), generator=gen)
        M = (M + M.transpose(1, 2)).to(dev)
        U = torch.linalg.eigh(M)[1]
        err = (U.transpose(1, 2) @ U - torch.eye(256, device=dev)).abs().max()
        print(f"batched f32 eigh (4 x 256^2) on {dev}: max|U^T U - I| "
              f"{err.item():.3e}")
    sizes = [int(a) for a in sys.argv[1:]] or [1024, 2048]
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    _, X = smoke_data()
    for n in sizes:
        Xd = torch.as_tensor(X[:n], dtype=torch.float32, device="cuda")
        Xs = ((Xd - Xd.mean(0)) / Xd.std(0)).contiguous()
        K = gauss_tile(Xs, Xs, float(Xs.shape[1]), True)
        ref = torch.linalg.eigvalsh(K.double()).flip(0)
        lam1 = ref[0].item()

        def report(name, t, w, V):
            w = w.flip(0)
            top = (w[:20].double() - ref[:20]).abs().max().item() / lam1
            res = (torch.linalg.norm(K @ V - V * w.flip(0)[None, :])
                   / torch.linalg.norm(K)).item()
            print(f"N={n} {name}: {t:.3f} s, top-20 |d|/lambda_1 "
                  f"{top:.3e}, residual {res:.3e}", flush=True)

        t, (w, V) = timed(lambda: torch.linalg.eigh(K))
        report("eigh", t, w, V)
        for pair in (torch.float32, torch.float64):
            jacobi.PAIR_DTYPE = pair
            for name, m, A in (("jacobi", None, K),
                               ("jacobi 2x2 mesh", mesh,
                                place(K, mesh, "block"))):
                t, (w, V) = timed(lambda: jacobi.block_jacobi_eigh(
                    A, mesh=m))
                report(f"{name}, pairs in {str(pair)[6:]}", t, w, V)
    return 0


if __name__ == "__main__":
    sys.exit(main())
