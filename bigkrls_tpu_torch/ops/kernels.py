"""Gaussian kernel construction.

Port of ``bigkrls_tpu/ops/kernels.py``. The rank-P identity

    ||xᵢ − xⱼ||² = rᵢ + rⱼ − 2 xᵢ·xⱼ,   rᵢ = ||xᵢ||²

turns the kernel into one (N, P)×(P, N) product plus broadcast adds and an
``exp``. Two implementations:

* ``gauss_kernel`` / ``cross_kernel``: plain PyTorch, the counterparts of
  the JAX package's XLA versions (``explicit=``, the exact-1 diagonal and
  the 0.5(K+Kᵀ) step included). They serve f64 and CPU fits.
* ``gauss_tile``: the wrapper of the hand-written CUDA kernel
  ``csrc/gauss_kernel.cu`` (the port of the Pallas ``_gauss_tile_kernel``).
  On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
  runs ``gauss_tile_plain``, the same rank-P formula in PyTorch. Its
  symmetric output is bit-symmetric by construction (see the source), so
  it needs no symmetrizing pass.

``kernel_matrix`` / ``cross_kernel_matrix`` pick between them for
``fit`` and ``predict``.
"""
from __future__ import annotations

import torch

# launches of the CUDA kernel made through ``gauss_tile`` (CPU calls, which
# run the plain version, do not count)
gauss_tile_launches = 0

KERNEL_IMPLS = ("auto", "plain", "cuda")


def _sqdist(Xa, Xb):
    """Pairwise squared Euclidean distances via the rank-P identity."""
    ra = torch.sum(Xa * Xa, dim=1)
    rb = torch.sum(Xb * Xb, dim=1)
    d2 = ra[:, None] + rb[None, :] - 2.0 * (Xa @ Xb.T)
    return torch.clamp_min(d2, 0.0)


def gauss_kernel(X, sigma, explicit: bool = False):
    """Symmetric N×N kernel ``exp(-||xᵢ-xⱼ||²/σ)`` with an exact-1
    diagonal. ``explicit=True`` uses the difference-sum form (O(N²P)
    memory; for validation only)."""
    if explicit:
        d2 = torch.sum((X[:, None, :] - X[None, :, :]) ** 2, dim=-1)
    else:
        d2 = _sqdist(X, X)
    K = torch.exp(-d2 / sigma)
    K.fill_diagonal_(1.0)
    return 0.5 * (K + K.T)


def cross_kernel(X_new, X_old, sigma):
    """Rectangular U×N kernel between new data and training data."""
    return torch.exp(-_sqdist(X_new, X_old) / sigma)


def gauss_tile_plain(A, B, sigma: float, symmetric_diag: bool):
    """Plain PyTorch version of the CUDA kernel: the same rank-P formula,
    no symmetrizing step; diagonal set to exactly 1 when ``symmetric_diag``."""
    K = torch.exp(-_sqdist(A, B) / sigma)
    if symmetric_diag:
        K.fill_diagonal_(1.0)
    return K


def gauss_tile(A, B, sigma: float, symmetric_diag: bool):
    """``exp(-||aᵢ - bⱼ||²/σ)`` for A (M, P) and B (N, P).

    CUDA tensors go to the hand-written kernel (f32, contiguous, same
    device; anything else raises). CPU tensors go to
    :func:`gauss_tile_plain`. ``symmetric_diag`` requires ``A is B``
    semantics (M == N) and writes an exact-1 diagonal."""
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[1]:
        raise ValueError(f"gauss_tile: need A (M, P) and B (N, P), got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if symmetric_diag and A.shape[0] != B.shape[0]:
        raise ValueError("gauss_tile: symmetric_diag needs M == N")
    if A.device.type == "cpu" and B.device.type == "cpu":
        return gauss_tile_plain(A, B, sigma, symmetric_diag)
    return _gauss_tile_cuda(A, B, float(sigma), symmetric_diag)


def _gauss_tile_cuda(A, B, sigma: float, symmetric_diag: bool):
    global gauss_tile_launches
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError(f"gauss_tile: A and B must lie on one CUDA device, "
                         f"got {A.device} and {B.device}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"gauss_tile: the CUDA kernel takes float32, got "
                        f"{A.dtype} and {B.dtype}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("gauss_tile: A and B must be contiguous")
    m, p = A.shape
    n = B.shape[0]
    if m == 0 or n == 0 or p == 0:
        raise ValueError(f"gauss_tile: empty operand {tuple(A.shape)}, "
                         f"{tuple(B.shape)}")
    if (m + 63) // 64 > 65535:
        raise ValueError(f"gauss_tile: M={m} rows exceed the grid limit")
    if not sigma > 0:
        raise ValueError("gauss_tile: sigma must be positive")
    from ._build import library
    lib = library()
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    same = A.data_ptr() == B.data_ptr() and m == n
    ra = torch.empty((m,), dtype=torch.float32, device=A.device)
    rb = ra if same else torch.empty((n,), dtype=torch.float32,
                                     device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.gauss_tile_f32(A.data_ptr(), B.data_ptr(), ra.data_ptr(),
                                 rb.data_ptr(), m, n, p, sigma,
                                 out.data_ptr(), int(bool(symmetric_diag)),
                                 stream)
    if err != 0:
        raise RuntimeError(f"gauss_tile: CUDA launch failed with error {err}")
    gauss_tile_launches += 1
    return out


def _use_tile(t, impl: str) -> bool:
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, "
                         f"got {impl!r}")
    if impl == "auto":
        return t.device.type == "cuda" and t.dtype == torch.float32
    return impl == "cuda"


def kernel_matrix(X, sigma: float, impl: str = "auto"):
    """The fit's N×N kernel: the CUDA kernel for ``impl="cuda"``, or
    ``"auto"`` on an f32 CUDA tensor; the plain ``gauss_kernel``
    otherwise."""
    if _use_tile(X, impl):
        return gauss_tile(X, X, sigma, True)
    return gauss_kernel(X, sigma)


def cross_kernel_matrix(X_new, X_old, sigma: float, impl: str = "auto"):
    """predict's U×N cross kernel, chosen as in :func:`kernel_matrix`."""
    if _use_tile(X_new, impl):
        return gauss_tile(X_new, X_old, sigma, False)
    return cross_kernel(X_new, X_old, sigma)
