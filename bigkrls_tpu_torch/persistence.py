"""Save and load fitted models, predictions and CV objects, ported from
``bigkrls_tpu/persistence.py`` (``save.bigKRLS`` / ``load.bigKRLS``,
``R/bigKRLS.R:901-1017``).

The folder format is the JAX package's, so a folder written by either
package loads in the other:

* ``meta.json``: the class, the scalars and the labels;
* ``arrays.npz``: every array, tensors copied to the host in their own
  dtype (an f32 fit saves f32 arrays). The port writes it uncompressed
  (``numpy.load`` reads either form): on fitted float data zlib saved
  about a tenth of the bytes for 3-5 s a save (N=3106 and N=50,000
  models, H100 host);
* with the native store built (``native/matstore.cpp``), each float64
  array of at least ``MMAP_THRESHOLD`` elements goes to its own raw
  ``<name>.bin`` instead, listed with its shape in ``bigmats.json``, and is
  read back through a memory map past the file's header;
* a name collision appends an integer suffix unless ``overwrite_existing``
  (the reference's ``make_path``);
* a CV object writes ``fold_k/trained`` and ``fold_k/tested`` per fold.

``load_model(path, device="cuda", dtype=None)`` puts a model's tensors on
``device``; ``dtype=None`` keeps the dtype they were saved in.

A mesh fit's model (K block-sharded, Q row-sharded) is saved in the same
format: each sharded array is fetched to the host of process 0 shard by
shard (block row by block row for K), so no device holds it whole, and
process 0 alone writes; it loads as a single-device model.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from .convert import model_from_numpy
from .crossvalidate import KRLSCrossValidation, KRLSFold
from .native import matstore
from .parallel.sharded import (ShardedTensor, _rank, host_gather,
                               process_zero_writes)
from .types import KRLSModel, KRLSPrediction

MMAP_THRESHOLD = 4_000_000  # elements; at or above, a raw .bin file

_MODEL_ARRAYS = [
    "X", "y", "K", "coeffs", "yfitted", "K_eigenvalues", "derivatives",
    "avgderivatives", "var_avgderivatives", "binaryindicator",
    "x_means", "x_sds", "eig_tail_theta", "eig_tail_w",
]
_MODEL_SCALARS = [
    "sigma", "lambda_", "looe", "R2", "R2AME", "lastkeeper", "neffective",
    "neffective_acf", "sigmasq_std", "y_mean", "y_sd",
]
_PRED_ARRAYS = ["predicted", "se_pred", "newdata", "newdataK", "ytest",
                "vcov_est_pred"]


def _host(v):
    """A tensor as a host numpy array in its own dtype (a sharded one
    fetched shard by shard to process 0; None elsewhere); anything else as
    it is."""
    if isinstance(v, ShardedTensor):
        return host_gather(v, label="save_model", dst=0)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def _unique_path(path: str, overwrite_existing: bool) -> str:
    if overwrite_existing or not os.path.exists(path):
        return path
    i = 1
    while os.path.exists(f"{path}{i}"):
        i += 1
    return f"{path}{i}"


def _save_arrays(folder: str, arrays: Dict[str, Any]) -> None:
    big, small = {}, {}
    native = matstore.available()
    for name, arr in arrays.items():
        if arr is None:
            continue
        arr = np.asarray(arr)
        if native and arr.size >= MMAP_THRESHOLD and arr.dtype == np.float64:
            big[name] = arr
        else:
            small[name] = arr
    np.savez(os.path.join(folder, "arrays.npz"), **small)
    if big:
        for name, arr in big.items():
            matstore.write_matrix(os.path.join(folder, f"{name}.bin"), arr)
        with open(os.path.join(folder, "bigmats.json"), "w") as fh:
            json.dump({name: list(arr.shape) for name, arr in big.items()}, fh)


def _load_arrays(folder: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    npz_path = os.path.join(folder, "arrays.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as data:
            out.update({k: data[k] for k in data.files})
    bm_path = os.path.join(folder, "bigmats.json")
    if os.path.exists(bm_path):
        with open(bm_path) as fh:
            shapes = json.load(fh)
        for name, shape in shapes.items():
            # read-only and zero-copy; torch.tensor copies it on load
            arr = matstore.mmap_matrix(os.path.join(folder, f"{name}.bin"))
            out[name] = arr.reshape(tuple(shape))
    return out


def _save_one(obj, folder: str) -> None:
    if _rank() == 0:
        os.makedirs(folder, exist_ok=True)
    if isinstance(obj, KRLSModel):
        arrays = {name: getattr(obj, name) for name in _MODEL_ARRAYS}
        fac = obj.vcov_c_factored
        if fac is not None:
            arrays["vcov_Q"] = fac.Q
            arrays["vcov_spectrum"] = fac.spectrum
        meta: Dict[str, Any] = {"class": "KRLSModel",
                                "xlabs": list(obj.xlabs),
                                "which_derivatives": obj.which_derivatives,
                                "eig_path": obj.eig_path}
        for name in _MODEL_SCALARS:
            meta[name] = getattr(obj, name)
        if fac is not None:
            meta["vcov_scale"] = fac.scale
    elif isinstance(obj, KRLSPrediction):
        arrays = {name: getattr(obj, name) for name in _PRED_ARRAYS}
        meta = {"class": "KRLSPrediction", "pseudoR2": obj.pseudoR2,
                "MSE": obj.MSE}
    else:
        raise TypeError(f"cannot save object of type {type(obj)}")
    # every process takes part in fetching the sharded arrays; one writes
    sharded = [a for a in arrays.values() if isinstance(a, ShardedTensor)]
    arrays = {name: _host(arr) for name, arr in arrays.items()}
    with process_zero_writes(*sharded) as writer:
        if writer:
            _save_arrays(folder, arrays)
            with open(os.path.join(folder, "meta.json"), "w") as fh:
                json.dump(meta, fh, default=float)


def save_model(obj, path: str, overwrite_existing: bool = False,
               noisy: bool = False) -> str:
    """Save a KRLSModel, KRLSPrediction or KRLSCrossValidation to a folder.

    Returns the folder actually used (integer-suffixed on collision unless
    ``overwrite_existing``, like the reference's ``make_path``).
    """
    path = _unique_path(path, overwrite_existing)
    if _rank() == 0:
        os.makedirs(path, exist_ok=True)
    if isinstance(obj, KRLSCrossValidation):
        meta: Dict[str, Any] = {
            "class": "KRLSCrossValidation", "type": obj.type,
            "seed": obj.seed, "kfolds": obj.kfolds, "ptesting": obj.ptesting,
            "metrics": {k: (np.asarray(v).tolist()
                            if isinstance(v, np.ndarray) else v)
                        for k, v in obj.metrics.items()},
            "n_folds_saved": len(obj.fold_results),
        }
        if obj.folds is not None:
            meta["folds"] = obj.folds.tolist()
        if obj.indices is not None:
            meta["indices"] = {k: v.tolist() for k, v in obj.indices.items()}
        if _rank() == 0:
            with open(os.path.join(path, "meta.json"), "w") as fh:
                json.dump(meta, fh, default=float)
        for k, fold in enumerate(obj.fold_results):
            _save_one(fold.trained, os.path.join(path, f"fold_{k + 1}",
                                                 "trained"))
            _save_one(fold.tested, os.path.join(path, f"fold_{k + 1}",
                                                "tested"))
    else:
        _save_one(obj, path)
    if noisy:
        total = sum(os.path.getsize(os.path.join(dp, f))
                    for dp, _, fs in os.walk(path) for f in fs)
        print(f"Saved to {path} ({total / 1024**2:.1f} MB)")
    return path


def _saved_dtype(arrays: Dict[str, np.ndarray]):
    """The torch dtype the model's tensors were saved in (K, else the
    covariance factor); None when the model saved neither."""
    for name in ("K", "vcov_Q"):
        if name in arrays:
            return torch.from_numpy(np.zeros(0, arrays[name].dtype)).dtype
    return None


def _load_one(folder: str, device, dtype):
    with open(os.path.join(folder, "meta.json")) as fh:
        meta = json.load(fh)
    arrays = _load_arrays(folder)
    cls = meta["class"]
    if cls == "KRLSModel":
        fields = dict(arrays)
        for name in (*_MODEL_SCALARS, "xlabs", "which_derivatives",
                     "eig_path", "vcov_scale"):
            fields[name] = meta.get(name)
        fields["path"] = folder
        if dtype is None:
            dtype = _saved_dtype(arrays)
        return model_from_numpy(fields, device=device, dtype=dtype)
    if cls == "KRLSPrediction":
        return KRLSPrediction(
            predicted=arrays.get("predicted"),
            se_pred=arrays.get("se_pred"),
            newdata=arrays.get("newdata"),
            newdataK=arrays.get("newdataK"),
            ytest=arrays.get("ytest"),
            vcov_est_pred=arrays.get("vcov_est_pred"),
            pseudoR2=meta.get("pseudoR2"), MSE=meta.get("MSE"),
        )
    raise ValueError(f"unknown class in meta.json: {cls}")


def load_model(path: str, device="cuda", dtype=None):
    """Load whatever ``save_model`` (of either package) wrote at ``path``.
    A model's tensors go to ``device`` in ``dtype`` (None: as saved)."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("class") != "KRLSCrossValidation":
        return _load_one(path, device, dtype)
    fold_results = []
    for k in range(meta["n_folds_saved"]):
        fold = os.path.join(path, f"fold_{k + 1}")
        fold_results.append(KRLSFold(
            _load_one(os.path.join(fold, "trained"), device, dtype),
            _load_one(os.path.join(fold, "tested"), device, dtype)))
    metrics = {k: (np.asarray(v) if isinstance(v, list) else v)
               for k, v in meta["metrics"].items()}
    return KRLSCrossValidation(
        type=meta["type"], seed=meta["seed"],
        folds=(np.asarray(meta["folds"]) if "folds" in meta else None),
        indices=({k: np.asarray(v) for k, v in meta["indices"].items()}
                 if "indices" in meta else None),
        fold_results=fold_results, metrics=metrics,
        kfolds=meta.get("kfolds"), ptesting=meta.get("ptesting"),
    )
