"""bigkrls_tpu_torch — Kernel Regularized Least Squares in PyTorch on CUDA.

The port of ``bigkrls_tpu`` (JAX) to PyTorch, with the dense Gaussian
kernel and the kernel-free product K(X)·V as hand-written CUDA kernels
for Hopper (``csrc/``). Every entry point runs on an explicit device
(``device="cuda"`` by default) or mesh. Public API (reference equivalents in
parentheses):

* ``fit`` / ``bigKRLS``            (``bigKRLS()``), dense or streaming
  (kernel-free, chosen by itself from N = 32768 with ``neig < N``), with
  ``checkpoint_dir``, ``model_subfolder_name`` and ``trace_dir``
* ``predict``                      (``predict.bigKRLS``)
* ``summary``                      (``summary.bigKRLS``)
* ``crossvalidate``                (``crossvalidate.bigKRLS``)
* ``summary_cv``                   (``summary.bigKRLS_CV``)
* ``save_model`` / ``load_model``  (``save.bigKRLS`` / ``load.bigKRLS``)
* ``plot_effects`` / ``export_effects`` / ``effects_explorer``
                                   (``shiny.bigKRLS``)
* ``reducibility``                 (``examples/reducibility.R``)
* ``enable_x64``                   float64 as the default fit dtype
* ``python -m bigkrls_tpu_torch``  the command line

``fit(mesh=...)`` runs over a mesh of devices, or of virtual shards of
one device (``parallel/``: ``sharded.make_mesh``, the ring product,
block Jacobi, ``distributed`` process groups).
``convert.model_from_reference`` turns a fitted JAX model into this
package's model.
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


# persistence imports crossvalidate, and the `crossvalidate` and
# `reducibility` functions shadow their submodules in the package
# namespace, as in the JAX package
from .crossvalidate import KRLSCrossValidation, summary_cv
from .crossvalidate import crossvalidate as _crossvalidate_fn
from .explorer import effects_explorer
from .persistence import load_model, save_model
from .plotting import export_effects, plot_effects
from .reducibility import reducibility as _reducibility_fn

crossvalidate = _crossvalidate_fn
reducibility = _reducibility_fn
from .cli import main
