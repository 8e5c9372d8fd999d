"""Data loading, ported from ``bigkrls_tpu/utils/io.py`` (the counterpart
of the reference's ``read.big.matrix``).

``load_csv`` reads a numeric CSV (one optional header row) through the
native reader (``native/matstore.cpp``) when it is built, else numpy, and
returns a float64 array ready for ``fit``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..native import matstore


def load_csv(path: str) -> np.ndarray:
    if matstore.available():
        return matstore.read_csv(path)[0]
    return np.atleast_2d(np.loadtxt(path, delimiter=",", ndmin=2))


def design_from_csv(path: str, y_col: int = 0,
                    drop_cols: Optional[Sequence[int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a numeric CSV into (y, X) by column index."""
    arr = load_csv(path)
    drop = set(drop_cols or [])
    drop.add(y_col)
    keep = [j for j in range(arr.shape[1]) if j not in drop]
    return arr[:, y_col].copy(), arr[:, keep].copy()
