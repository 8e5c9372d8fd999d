"""The seeded data of a configuration: X and y of each pool dataset.

A configuration's ``data`` names its recipe, ``recipes/<recipe>.py``, whose
``make(rng, n, p, **params)`` returns (y, X); the rest of ``data`` is its
parameters. The recipes are the port's benchmark recipes
(``bigkrls_tpu_torch/bench.py``, ``smoke_data`` and ``streaming_data``),
copied so that a change to the program cannot change the benchmark's
inputs. Each dataset draws from its own stream of ``(seed, index)``, so the
same seed gives the same data.
"""
from __future__ import annotations

import numpy as np

from . import spec


def stream(seed: int, *tags: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and the given tags."""
    return np.random.default_rng([seed % (1 << 64), *tags])


def recipe(name: str):
    """``make`` of ``recipes/<name>.py``."""
    return spec.load_module("recipes", name, "data recipe").make


def dataset(config: dict, seed: int, index: int):
    """(y, X) of pool dataset ``index`` of ``config``."""
    params = dict(config["data"])
    make = recipe(params.pop("recipe"))
    return make(stream(seed, 1, index), config["n"], config["p"], **params)
