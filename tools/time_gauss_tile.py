#!/usr/bin/env python3
"""Time the Gaussian tile kernel (K1) on one CUDA card.

    python3 tools/time_gauss_tile.py [--shapes M,N,P,sym ...] [--reps R]
    python3 tools/time_gauss_tile.py --tiles [--shapes ...]
    python3 tools/time_gauss_tile.py --ablate [--shapes ...]
    python3 tools/time_gauss_tile.py --check

Prints the card's name and power limit first. At each (M, N, P, symmetric)
shape (``sym`` 1: A and B are the same rows, exact-1 diagonal):

* the kernel against the frozen first design (``tools/gauss_kernel_first.cu``,
  built here as an oracle): bit-equal or not, and both kernels' times in
  the order old / new / new / old, each the median of R (default 20)
  CUDA-event-timed launches after 3 warm-ups, in milliseconds;
* the looped time: R launches inside one pair of events, over R, and the
  graph time: R launches captured into one CUDA graph and replayed, over R.
  A single call's time holds the host's share (the wrapper runs while the
  device waits); the looped time is the larger of the host's and the
  device's time per call; the graph time is the device's alone;
* the plain PyTorch version's time, the bound max(2MNP / 67 TFLOP/s,
  4(MP + NP + MN) / 3.35 TB/s), and the graph time's share of it.

``--tiles`` adds the graph time with every tile forced (and, for a
symmetric shape, with the mirror switched off), each checked bit-equal to
the rule's choice. ``--ablate`` rebuilds the kernel with parts switched off
at compile time (``-DBIGKRLS_K1_ABLATE_GRAM``: the product's loads and
FMAs; ``_ENTRY``: the quotient and expf; ``_STORE``: the global stores) and
prints the graph times, with the mirror on and off: the differences
attribute the kernel's time to its parts where no profiler can run. The
ablated kernels compute garbage and go into libraries of their own.
``--check`` holds the kernel bit-equal to the oracle over a list of edge
shapes, every tile, three sigmas, and exits. No JAX is used.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import k1_oracle  # noqa: E402
from chip_smoke import cuda_ms as event_ms  # noqa: E402
from chip_smoke import graph_ms, looped_ms  # noqa: E402
from chip_smoke import k1_bound_ms as bound_ms  # noqa: E402

SHAPES = [(3106, 3106, 67, 1), (16384, 16384, 20, 1), (517, 3106, 67, 0),
          (1000, 1000, 5, 1), (4097, 4097, 3, 1), (3106, 3106, 68, 1),
          (10, 50000, 20, 0), (8192, 8192, 200, 1), (32768, 32768, 20, 1)]
ABLATIONS = [(), ("STORE",), ("ENTRY",), ("GRAM",), ("GRAM", "ENTRY"),
             ("GRAM", "ENTRY", "STORE")]
ABLATE_SHAPES = [(3106, 3106, 67, 1), (16384, 16384, 20, 1),
                 (517, 3106, 67, 0)]
# (M, N, P, sym): every tile's edges (one below, at, one above), P around
# the 16-byte and the slice boundaries, one-row and one-column calls
CHECK_SHAPES = [(63, 63, 1, 1), (64, 64, 3, 1), (65, 65, 4, 1),
                (127, 127, 5, 1), (128, 128, 67, 1), (129, 129, 68, 1),
                (130, 130, 200, 1), (257, 257, 513, 1), (1000, 1000, 72, 1),
                (1000, 1000, 73, 1), (1, 70, 2, 0), (70, 1, 2, 0),
                (517, 3106, 67, 0), (129, 65, 76, 0), (3106, 3106, 67, 1)]


def operands(shape, gen):
    m, n, p, sym = shape
    A = torch.randn((m, p), generator=gen, device="cuda")
    B = A if sym else torch.randn((n, p), generator=gen, device="cuda")
    return A, B


def parse_shapes(args, default):
    if "--shapes" not in args:
        return default
    shapes = []
    for a in args[args.index("--shapes") + 1:]:
        if a.startswith("--"):
            break
        shapes.append(tuple(int(v) for v in a.split(",")))
    return shapes


def print_ptxas(log: str):
    keep = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "gauss_tile" in line
        if keep and any(w in line for w in ("Compiling", "registers",
                                            "spill")):
            print("  ptxas:" + line.split(":", 1)[-1])


def check(kernels, old) -> int:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bad = 0
    for shape in CHECK_SHAPES:
        m, n, p, sym = shape
        A, B = operands(shape, gen)
        for sigma in (float(p), 0.7131, 1e-3):
            for diag in ([True, False] if sym else [False]):
                ref = old(A, B, sigma, diag)
                runs = [(None, None)] + [(t, None) for t in kernels._TILES]
                if sym:
                    runs += [(t, False) for t in kernels._TILES]
                for tile, mirror in runs:
                    K = kernels._gauss_tile_cuda(A, B, sigma, diag, tile=tile,
                                                 mirror=mirror)
                    torch.cuda.synchronize()
                    if not torch.equal(K, ref):
                        bad += 1
                        d = (K - ref).abs()
                        print(f"DIFFERS {shape} sigma={sigma} diag={diag} "
                              f"tile={tile} mirror={mirror}: "
                              f"{int((K != ref).sum())} entries, max "
                              f"{d.max().item():.3e}")
        print(f"check {shape}: done", flush=True)
    print(f"check: {bad} mismatches")
    return 1 if bad else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    from bigkrls_tpu_torch.ops import _build, kernels
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 20
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def new(A, B, p, sym, tile=None, mirror=None):
        return kernels._gauss_tile_cuda(A, B, float(p), bool(sym), tile=tile,
                                        mirror=mirror)

    if "--ablate" in args:
        shapes = parse_shapes(args, ABLATE_SHAPES)
        data = [operands(s, gen) for s in shapes]
        base = _build.COMPILE_FLAGS
        for off in ABLATIONS:
            _build.COMPILE_FLAGS = base + tuple(
                f"-DBIGKRLS_K1_ABLATE_{name}" for name in off)
            _build.library.cache_clear()
            kernels._lib = None
            row = []
            for (m, n, p, sym), (A, B) in zip(shapes, data):
                cell = f"{graph_ms(lambda: new(A, B, p, sym), reps):.4f}"
                if sym:
                    t = graph_ms(lambda: new(A, B, p, sym, mirror=False),
                                 reps)
                    cell += f" (no mirror {t:.4f})"
                row.append(f"({m},{n},{p}): {cell}")
            print(f"without {'+'.join(off) or 'nothing'}: " + "; ".join(row),
                  flush=True)
        return 0

    build = k1_oracle.start_build()
    _build.library()
    old = k1_oracle.load(build)
    print(f"nvcc {_build.last_build_seconds:.1f} s")
    print_ptxas(_build.last_build_log)
    if "--check" in args:
        return check(kernels, old)

    ok = True
    for shape in parse_shapes(args, SHAPES):
        m, n, p, sym = shape
        A, B = operands(shape, gen)
        sigma = float(p)
        K = new(A, B, p, sym)
        ref = old(A, B, sigma, bool(sym))
        torch.cuda.synchronize()
        same = torch.equal(K, ref)
        ok &= same
        del ref
        t = [event_ms(lambda: old(A, B, sigma, bool(sym)), reps),
             event_ms(lambda: new(A, B, p, sym), reps),
             event_ms(lambda: new(A, B, p, sym), reps),
             event_ms(lambda: old(A, B, sigma, bool(sym)), reps)]
        loop_new = looped_ms(lambda: new(A, B, p, sym), reps)
        loop_old = looped_ms(lambda: old(A, B, sigma, bool(sym)), reps)
        dev_new = graph_ms(lambda: new(A, B, p, sym), reps)
        dev_old = graph_ms(lambda: old(A, B, sigma, bool(sym)), reps)
        plain = event_ms(lambda: kernels.gauss_tile_plain(A, B, sigma,
                                                          bool(sym)),
                         min(reps, 5), 1)
        bound, by = bound_ms(m, n, p)
        plan = kernels._tile_plan(m, n, p, bool(sym), sms)
        print(f"({m},{n},P={p},sym={sym}) tile {plan}x{plan}: "
              f"bit-equal to the first design: {same}; old/new/new/old "
              f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} / {t[3]:.4f} ms; looped "
              f"new {loop_new:.4f}, old {loop_old:.4f}; graph new {dev_new:.4f}, "
              f"old {dev_old:.4f}; plain {plain:.4f}; bound {bound:.4f} "
              f"({by}); share of bound {bound / dev_new:.1%}", flush=True)
        if "--tiles" in args:
            runs = [(tile, None) for tile in kernels._TILES]
            if sym:
                runs += [(tile, False) for tile in kernels._TILES]
            cells = []
            for tile, mirror in runs:
                Kt = new(A, B, p, sym, tile, mirror)
                torch.cuda.synchronize()
                eq = torch.equal(Kt, K)
                ok &= eq
                del Kt
                tt = graph_ms(lambda: new(A, B, p, sym, tile, mirror), reps)
                cells.append(f"{tile}x{tile}"
                             f"{'' if mirror is None else ' no mirror'} "
                             f"{tt:.4f}{'' if eq else ' BITS DIFFER'}")
            print("   tiles, graph: " + ", ".join(cells), flush=True)
        del A, B, K
    if not ok:
        print("results differ from the first design or between tiles",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
