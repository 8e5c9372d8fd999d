"""iid normal X, y = sin(x_0) + slope * sum(X) + noise (the port's
``bench.streaming_data``)."""
import numpy as np


def make(rng, n: int, p: int, slope: float = 0.2):
    X = rng.normal(size=(n, p))
    y = np.sin(X[:, 0]) + X @ (slope * np.ones(p)) + rng.normal(size=n)
    return y, X
