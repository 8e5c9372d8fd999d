#!/usr/bin/env python3
"""Hold the kernel-free product kernel (K2) of two trees bit for bit.

    python3 tools/k2_bits.py OUT.pt [OTHER.pt]

Run from a tree's root on a CUDA card: computes ``kernel_matmul`` (precise
and fast mode, bare and with the ``init``/``out_scale`` epilogue) at five
(N, P, m) shapes on seeded inputs and saves the results to OUT.pt. With
OTHER.pt (saved the same way by another tree, e.g. the parent commit
unpacked beside this one), exits 1 unless every result is bit-equal to
it. No JAX is used.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

SHAPES = [(50000, 20, 540), (4097, 3, 5), (1000, 67, 130), (8192, 20, 1100),
          (3106, 67, 22)]


def main() -> int:
    from bigkrls_tpu_torch.ops import matvec
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    res = {}
    for n, p, m in SHAPES:
        X = torch.randn((n, p), generator=gen, device="cuda")
        V = torch.randn((n, m), generator=gen, device="cuda")
        init = torch.randn((n, m), generator=gen, device="cuda")
        for fast in (False, True):
            res[(n, p, m, fast)] = matvec.kernel_matmul(
                X, V, float(p), fast_accum=fast).cpu()
            res[(n, p, m, fast, "epilogue")] = matvec.kernel_matmul(
                X, V, float(p), init=init, out_scale=-2.5,
                fast_accum=fast).cpu()
    torch.save(res, sys.argv[1])
    if len(sys.argv) > 2:
        other = torch.load(sys.argv[2])
        bad = [k for k in res if not torch.equal(res[k], other[k])]
        print(f"K2 bit-equal to {sys.argv[2]} at {len(res)} cases; "
              f"differing: {bad}")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
