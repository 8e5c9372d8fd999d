"""Mid-fit checkpoint and resume, ported from ``bigkrls_tpu/checkpoint.py``.

The fit's O(N³) prefix, the eigendecomposition, is stored after step 2,
keyed by a hash of the standardized X (as float64 bytes) and the eig
configuration. A refit with the same data and configuration skips the
eigendecomposition (the kernel is still built on a dense route). The
adaptive route stores its head pairs with the moment-completed λ bounds
and tail quadrature, and the solution keyed by a second hash of (y, tol):
an identical refit resumes bit-exact, a changed y re-runs only the golden
search and solve.

The files and the fingerprints are the JAX package's: the dtype enters the
hash as the numpy name ("float32", "float64"), so both packages give the
same fingerprint for the same array and configuration. The eigenvectors
go through the native store (``native/matstore.cpp``: raw float64 with a
checksum, so a torn write is detected and the checkpoint recomputed) when
it is built, else ``.npy``. Crash safety: the meta file is unlinked first,
the arrays written, and the meta written last by temp file and rename.

A mesh fit's eigenvectors and coefficients are row-sharded
(``parallel/sharded.py``): they are fetched to the host of process 0
shard by shard (across processes, a collective every process takes part
in), so no device holds them whole, and only process 0 writes. A mesh fit
resumes by laying the loaded vectors out over its mesh again.
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Optional

import numpy as np
import torch

from .native import matstore
from .parallel.sharded import (ShardedTensor, host_gather,
                               process_zero_writes)
from .types import Eigensystem

# what a damaged or half-written checkpoint can raise on load; the answer
# is always to recompute, never a partial resume
_CORRUPT = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _host64(a, dst: Optional[int] = None) -> Optional[np.ndarray]:
    """``a`` as host float64; a sharded tensor fetched shard by shard, to
    every process or only to process ``dst`` (None elsewhere)."""
    if isinstance(a, ShardedTensor):
        a = host_gather(a, label="checkpoint", dst=dst)
        return None if a is None else a.astype(np.float64)
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, dtype=np.float64)


def _dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype ("float32", "float64")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def fingerprint(X_std, sigma: float, neig: int, eigtrunc: float,
                dtype) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(_host64(X_std)).tobytes())
    h.update(json.dumps([float(sigma), int(neig), float(eigtrunc),
                         _dtype_name(dtype)]).encode())
    return h.hexdigest()[:32]


def solution_fingerprint(y_std, tol: float) -> str:
    """Fingerprint of the λ-search inputs the eig fingerprint does not
    cover: y and the golden-search tolerance."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(_host64(y_std)).tobytes())
    h.update(json.dumps([float(tol)]).encode())
    return h.hexdigest()[:32]


def _paths(ckpt_dir: str):
    return (os.path.join(ckpt_dir, "eig_meta.json"),
            os.path.join(ckpt_dir, "eig_values.npy"),
            os.path.join(ckpt_dir, "eig_vectors.bin"),
            os.path.join(ckpt_dir, "eig_vectors.npy"))


def _adaptive_paths(ckpt_dir: str):
    return (os.path.join(ckpt_dir, "adaptive_meta.json"),
            os.path.join(ckpt_dir, "adaptive_values.npz"),
            os.path.join(ckpt_dir, "adaptive_vectors.bin"),
            os.path.join(ckpt_dir, "adaptive_vectors.npy"))


def _write_vectors(vecs_bin: str, vecs_npy: str, vecs: np.ndarray) -> bool:
    """The eigenvectors through the native store, else ``.npy``; returns
    whether the native store wrote them."""
    if matstore.available():
        matstore.write_matrix(vecs_bin, vecs)
        return True
    np.save(vecs_npy, vecs)
    return False


def _read_vectors(meta: dict, vecs_bin: str, vecs_npy: str) -> np.ndarray:
    if meta.get("native"):
        return matstore.read_matrix(vecs_bin)   # checksum-verified
    return np.load(vecs_npy)


def _write_meta(meta_p: str, meta: dict) -> None:
    tmp_p = meta_p + ".tmp"
    with open(tmp_p, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp_p, meta_p)


def save_eig(ckpt_dir: str, fp: str, eig: Eigensystem) -> None:
    vecs = _host64(eig.vectors, dst=0)  # the fetch comes before the guard
    values = _host64(eig.values_full)
    with process_zero_writes(eig.vectors) as writer:
        if not writer:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        meta_p, vals_p, vecs_bin, vecs_npy = _paths(ckpt_dir)
        # invalidate first: a crash after the new arrays but before the new
        # meta must not leave an old meta paired with them
        if os.path.exists(meta_p):
            os.unlink(meta_p)
        np.save(vals_p, values)
        native = _write_vectors(vecs_bin, vecs_npy, vecs)
        # the meta, written last and atomically, marks a complete checkpoint
        _write_meta(meta_p, {"fingerprint": fp, "lastkeeper": eig.lastkeeper,
                             "native": native})


def load_eig(ckpt_dir: str, fp: str, dtype,
             device="cuda") -> Optional[Eigensystem]:
    """The stored eigensystem on ``device`` in ``dtype``, or None (none
    stored, another fingerprint, or damaged)."""
    meta_p, vals_p, vecs_bin, vecs_npy = _paths(ckpt_dir)
    if not os.path.exists(meta_p):
        return None
    try:
        with open(meta_p) as fh:
            meta = json.load(fh)
        if meta.get("fingerprint") != fp:
            return None
        values = np.load(vals_p)
        vectors = _read_vectors(meta, vecs_bin, vecs_npy)
        lastkeeper = int(meta["lastkeeper"])
    except _CORRUPT:
        return None
    return Eigensystem(
        values_full=torch.as_tensor(values, dtype=dtype, device=device),
        vectors=torch.as_tensor(vectors, dtype=dtype, device=device),
        lastkeeper=lastkeeper)


def save_adaptive(ckpt_dir: str, fp: str, out, sol_fp: Optional[str] = None,
                  lam: Optional[float] = None, Le=None,
                  coeffs=None) -> None:
    """Store an ``ops.adaptive.AdaptiveEig``: the head pairs with the
    completed-spectrum λ bounds and the tail quadrature (the only record
    of the uncomputed tail), and, with ``sol_fp``/``lam``/``Le``/
    ``coeffs``, the solution keyed by the (y, tol) fingerprint."""
    vecs = _host64(out.eig.vectors, dst=0)  # fetch before the guard
    values = _host64(out.eig.values_full)
    coeffs_h = None if coeffs is None else _host64(coeffs, dst=0)
    with process_zero_writes(out.eig.vectors, coeffs) as writer:
        if not writer:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        meta_p, vals_p, vecs_bin, vecs_npy = _adaptive_paths(ckpt_dir)
        if os.path.exists(meta_p):          # invalidate first, as in save_eig
            os.unlink(meta_p)
        arrays = dict(
            values=values,
            tail_theta=np.asarray(out.tail_theta, dtype=np.float64),
            tail_w=np.asarray(out.tail_w, dtype=np.float64))
        if coeffs_h is not None:
            arrays["coeffs"] = coeffs_h
        np.savez(vals_p, **arrays)
        native = _write_vectors(vecs_bin, vecs_npy, vecs)
        meta = {"fingerprint": fp, "lastkeeper": out.eig.lastkeeper,
                "k": out.k, "L": out.L, "U": out.U, "native": native}
        if sol_fp is not None and lam is not None:
            meta["sol_fp"] = sol_fp
            meta["lam"] = float(lam)
            meta["Le"] = float(Le)
        _write_meta(meta_p, meta)


def update_adaptive_solution(ckpt_dir: str, fp: str, sol_fp: str,
                             lam: float, Le, coeffs) -> None:
    """Replace only the stored solution of an adaptive checkpoint (after
    a resume under another (y, tol)); the eigenvectors are not rewritten.
    Crash-safe order: (1) the meta rewritten without the solution, (2) the
    small npz replaced atomically, (3) the meta with the new solution. A
    crash anywhere loses at most the stored solution, never the prefix."""
    coeffs_h = _host64(coeffs, dst=0)
    meta_p, vals_p, _, _ = _adaptive_paths(ckpt_dir)
    with process_zero_writes(coeffs) as writer:
        if not writer or not os.path.exists(meta_p):
            return
        try:
            with open(meta_p) as fh:
                meta = json.load(fh)
            if meta.get("fingerprint") != fp:
                return
            with np.load(vals_p) as data:
                arrays = {k: data[k] for k in data.files if k != "coeffs"}
        except _CORRUPT:
            return
        for key in ("sol_fp", "lam", "Le"):
            meta.pop(key, None)
        _write_meta(meta_p, meta)                       # (1)
        arrays["coeffs"] = coeffs_h
        tmp_npz = vals_p + ".tmp.npz"
        np.savez(tmp_npz, **arrays)
        os.replace(tmp_npz, vals_p)                     # (2)
        meta.update({"sol_fp": sol_fp, "lam": float(lam), "Le": float(Le)})
        _write_meta(meta_p, meta)                       # (3)


def load_adaptive(ckpt_dir: str, fp: str, dtype,
                  sol_fp: Optional[str] = None, device="cuda"):
    """``(AdaptiveEig, solution)`` from a stored adaptive checkpoint, with
    ``solution = (lam, Le, coeffs)`` when the stored one was made under
    ``sol_fp``, else None; or None overall (none stored, another
    fingerprint, or damaged: the native store's checksum catches a torn
    vector file)."""
    meta_p, vals_p, vecs_bin, vecs_npy = _adaptive_paths(ckpt_dir)
    if not os.path.exists(meta_p):
        return None
    try:
        with open(meta_p) as fh:
            meta = json.load(fh)
        if meta.get("fingerprint") != fp:
            return None
        with np.load(vals_p) as data:
            values = data["values"]
            tail_theta = data["tail_theta"]
            tail_w = data["tail_w"]
            coeffs = data["coeffs"] if "coeffs" in data.files else None
        vectors = _read_vectors(meta, vecs_bin, vecs_npy)
        lastkeeper, k = int(meta["lastkeeper"]), int(meta["k"])
        L, U = float(meta["L"]), float(meta["U"])
    except _CORRUPT:
        return None
    from .ops.adaptive import AdaptiveEig
    eig = Eigensystem(
        values_full=torch.as_tensor(values, dtype=dtype, device=device),
        vectors=torch.as_tensor(vectors, dtype=dtype, device=device),
        lastkeeper=lastkeeper)
    out = AdaptiveEig(eig=eig, L=L, U=U, k=k, tail_theta=tail_theta,
                      tail_w=tail_w)
    sol = None
    if (sol_fp is not None and coeffs is not None
            and meta.get("sol_fp") == sol_fp):
        sol = (float(meta["lam"]), float(meta["Le"]),
               torch.as_tensor(coeffs, dtype=dtype, device=device))
    return out, sol
