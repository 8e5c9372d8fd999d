"""A low-rank design with a decaying kernel spectrum and the last column
binary (the port's ``bench.smoke_data``: lastkeeper about 219 of 3106 at
eigtrunc 0.001), y linear plus sin(2 x_0) plus noise."""
import numpy as np


def make(rng, n: int, p: int, factors: int = 6, noise: float = 0.3):
    Z = rng.normal(size=(n, factors))
    W = rng.normal(size=(factors, p))
    X = Z @ W + noise * rng.normal(size=(n, p))
    X[:, p - 1] = (X[:, 0] > 0)
    y = X @ rng.normal(size=p) / np.sqrt(p) + np.sin(2 * X[:, 0]) \
        + rng.normal(size=n)
    return y, X
