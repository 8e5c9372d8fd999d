"""bigkrls_tpu_torch — Kernel Regularized Least Squares in PyTorch on CUDA.

The port of ``bigkrls_tpu`` (JAX) to PyTorch, with the Gaussian kernel
builder as a hand-written CUDA kernel for Hopper (``csrc/``). It runs the
single-device dense fit: ``fit``/``bigKRLS`` on one explicit device
(``device="cuda"`` by default), ``predict``, ``summary`` and
``check_data``. ``convert.model_from_reference`` turns a fitted JAX model
into this package's model. The rest of the JAX package's API is listed in
ROADMAP.md, queue 1, in the order it is ported.

``enable_x64()`` makes float64 the default fit dtype (parity mode, as the
reference computes in double).
"""
from __future__ import annotations

import torch as _torch

from . import model as _model
from .inference import KRLSSummary, summary
from .model import bigKRLS, check_data, fit
from .predict import predict
from .types import (Eigensystem, FactoredCovariance, KRLSModel,
                    KRLSPrediction)

__version__ = "0.1.0"


def enable_x64() -> None:
    """Make float64 the package's default fit dtype. PyTorch's own
    default dtype is left alone."""
    _model.DEFAULT_DTYPE = _torch.float64
