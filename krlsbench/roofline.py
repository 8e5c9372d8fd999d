"""Peaks of the card and the work of the program's two kernels.

The least time a launch could take is the larger of its operations over
the TF32 tensor-core peak and its bytes over the memory rate. The
operations are those the mathematics needs, counted from the launch's
shapes: 495 TFLOP/s is the fastest the card does such work at TF32
precision or better, so the count holds whatever mode or pass count the
program chooses, and no implementation can read above 100%. The bytes
count each input read once and each output written once.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

# published NVIDIA H100 SXM peaks, dense, at the 700 W limit
PEAK_TF32 = 495e12       # FLOP/s
PEAK_HBM = 3.35e12       # bytes/s
WORD = 4                 # float32


def k1_work(m: int, n: int, p: int) -> Tuple[float, float]:
    """(operations, bytes) of an (M, N, P) Gaussian tile: 2MNP for the
    distances; A and B read once, the whole M x N tile written once,
    mirrored or not."""
    return 2.0 * m * n * p, WORD * (m * p + n * p + m * n)


def k2_work(na: int, nb: int, p: int, m: int,
            init: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of K(Xa, Xb) V for V (Nb, m): 2 Na Nb P for the
    distances and 2 Na Nb m for the product; Xa, Xb, V (and init) read
    once, Y written once."""
    return (2.0 * na * nb * (p + m),
            WORD * (na * p + nb * p + nb * m + (2 if init else 1) * na * m))


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, which term bounds it)."""
    t_ops, t_bytes = ops / PEAK_TF32, nbytes / PEAK_HBM
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def share_pct(works: Iterable[Tuple[float, float]],
              device_s: float) -> Optional[float]:
    """100 x (sum of the launches' least times) / their device time, or
    None where nothing ran."""
    least = sum(bound_s(o, b)[0] for o, b in works)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
