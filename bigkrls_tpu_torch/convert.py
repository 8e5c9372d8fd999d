"""Turn a fitted model of the JAX package into the port's ``KRLSModel``.

KRLS has no weights: a fitted model *is* its parameters (coefficients,
training X and y, bandwidth, λ, Neff, moments and the factored Var(c)).
``model_from_reference`` reads them from a ``bigkrls_tpu`` model by duck
typing — any object with the same field names, arrays readable by
``numpy.asarray`` — so this module needs no JAX. The port's ``predict``
and ``summary`` then run on the result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import FactoredCovariance, KRLSModel

# fields kept as python scalars / lists; every other array becomes numpy f64
_SCALARS = ("sigma", "lambda_", "looe", "R2", "R2AME", "neffective",
            "neffective_acf", "sigmasq_std", "y_mean", "y_sd")
_PASSTHROUGH = ("xlabs", "lastkeeper", "which_derivatives", "path",
                "timings", "eig_path")


def model_from_numpy(fields: dict, device="cuda",
                     dtype=None) -> KRLSModel:
    """Build a ``KRLSModel`` from a dict of its fields as numpy arrays and
    python scalars. The factored covariance is given as ``vcov_Q``,
    ``vcov_spectrum`` and ``vcov_scale`` (or omitted); ``K`` is optional.
    Tensors are placed on ``device`` in ``dtype``; as for ``fit``, the
    device defaults to ``"cuda"`` and ``dtype=None`` means the package's
    default fit dtype (``model.DEFAULT_DTYPE``)."""
    if dtype is None:
        from . import model
        dtype = model.DEFAULT_DTYPE
    out = {}
    for f in dataclasses.fields(KRLSModel):
        name = f.name
        if name in ("vcov_c_factored", "sharding_report"):
            continue
        v = fields.get(name)
        if v is None:
            out[name] = None
        elif name == "K":
            out[name] = torch.tensor(np.asarray(v), dtype=dtype,
                                     device=device)
        elif name in _SCALARS:
            out[name] = float(v)
        elif name == "binaryindicator":
            out[name] = np.asarray(v, dtype=bool)
        elif name in _PASSTHROUGH:
            out[name] = v
        else:
            out[name] = np.asarray(v, dtype=np.float64)
    if out.get("lastkeeper") is not None:
        out["lastkeeper"] = int(out["lastkeeper"])
    vcov = None
    if fields.get("vcov_Q") is not None:
        vcov = FactoredCovariance(
            torch.tensor(np.asarray(fields["vcov_Q"]), dtype=dtype,
                         device=device),
            torch.tensor(np.asarray(fields["vcov_spectrum"]), dtype=dtype,
                         device=device),
            float(fields.get("vcov_scale", 1.0)))
    return KRLSModel(vcov_c_factored=vcov, **out)


def model_from_reference(m, device="cuda", dtype=None,
                         keep_kernel: bool = False) -> KRLSModel:
    """The port's model for a fitted ``bigkrls_tpu`` model ``m``. The N×N
    kernel is copied only with ``keep_kernel`` (predict does not need
    it)."""
    fields = {f.name: getattr(m, f.name, None)
              for f in dataclasses.fields(KRLSModel)}
    if not keep_kernel:
        fields["K"] = None
    fac = getattr(m, "vcov_c_factored", None)
    if fac is not None:
        fields.update(vcov_Q=fac.Q, vcov_spectrum=fac.spectrum,
                      vcov_scale=fac.scale)
    return model_from_numpy(fields, device=device, dtype=dtype)
