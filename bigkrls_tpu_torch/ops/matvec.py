"""Kernel-free product: Y = K(X) · V without materializing K.

Port of ``bigkrls_tpu/ops/matvec.py``. Every consumer of the N×N kernel in
the fit is a product K·V (the eigensolver's power steps, the Ritz K·B, ŷ,
and the derivatives' stacked right-hand side), so past the size where K
fits in memory the fit recomputes K tile by tile from X, at 2N²(P+m) FLOP
per product and O(N·(P+m)) storage.

One entry point, :func:`kernel_matmul`, replaces the JAX package's
``kernel_matmul``, ``kernel_matmul_pallas`` and their ``_fast`` aliases:

    Y = (K(X)·V + init) · out_scale,
    K_ij = exp(−max(rᵢ + rⱼ − 2 xᵢ·xⱼ, 0)/σ)

with ``init`` and ``out_scale`` optional. Like the JAX product, and unlike
``gauss_kernel``, it writes no exact-1 diagonal. Two implementations:

* the hand-written CUDA kernel ``csrc/kernel_matmul.cu`` (the port of the
  Pallas ``_km_kernel``): f32 CUDA tensors; the K tiles live only on chip;
* :func:`kernel_matmul_plain`: the blocked PyTorch loop, one (N, block)
  tile of K at a time. It serves CPU tensors, float64 fits and
  ``impl="plain"``.

``fast_accum`` lowers only the tile·V contraction to TF32; the rank-P
distance part stays IEEE fp32, since its errors land inside exp().
"""
from __future__ import annotations

import torch

from .kernels import _sqdist, _use_tile

# launches of the CUDA kernel made through ``kernel_matmul`` (calls that
# run the plain version do not count); fast-mode launches count in both
kernel_matmul_launches = 0
kernel_matmul_fast_launches = 0


def _span(t):
    """The byte range [lo, hi) that holds every element of ``t``."""
    if t.numel() == 0:
        return 0, 0
    last = sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
    lo = t.data_ptr()
    return lo, lo + (last + 1) * t.element_size()


def _overlaps(a, b) -> bool:
    if a.device != b.device:
        return False
    (alo, ahi), (blo, bhi) = _span(a), _span(b)
    return alo < bhi and blo < ahi


def _check(X, V, sigma, init, out):
    """Argument checks shared by both implementations, so that a call the
    CUDA kernel would refuse is refused on the CPU too."""
    if X.dim() != 2 or V.dim() != 2 or X.shape[0] != V.shape[0]:
        raise ValueError(f"kernel_matmul: need X (N, P) and V (N, m), got "
                         f"{tuple(X.shape)} and {tuple(V.shape)}")
    if 0 in X.shape or 0 in V.shape:
        raise ValueError(f"kernel_matmul: empty operand {tuple(X.shape)}, "
                         f"{tuple(V.shape)}")
    if not sigma > 0:
        raise ValueError("kernel_matmul: sigma must be positive")
    for name, t in (("X", X), ("V", V), ("init", init), ("out", out)):
        if t is None:
            continue
        if t.dtype != X.dtype or t.device != X.device:
            raise TypeError(f"kernel_matmul: {name} is {t.dtype} on "
                            f"{t.device}, X is {X.dtype} on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"kernel_matmul: {name} must be contiguous")
    for name, t in (("init", init), ("out", out)):
        if t is not None and t.shape != V.shape:
            raise ValueError(f"kernel_matmul: {name} must have V's shape "
                             f"{tuple(V.shape)}, got {tuple(t.shape)}")
    if out is not None:
        if _overlaps(out, V) or _overlaps(out, X):
            raise ValueError("kernel_matmul: out must not alias X or V")
        if init is not None and _overlaps(out, init) and (
                out.data_ptr() != init.data_ptr()):
            raise ValueError("kernel_matmul: out may alias init only as the "
                             "same buffer")


def kernel_matmul_plain(X, V, sigma, *, init=None, out_scale=None,
                        fast_accum: bool = False, block: int = 1024,
                        out=None):
    """Plain PyTorch version of the CUDA kernel: a loop over column blocks
    of K, each step materializing one (N, block) tile.

    ``fast_accum`` runs the tile·V product (and nothing else) under TF32 on
    a CUDA tensor; on the CPU it has no effect. ``out`` receives the result
    and may be ``init`` itself."""
    sigma = float(sigma)
    _check(X, V, sigma, init, out)
    n = X.shape[0]
    if out is None:
        out = torch.empty_like(V)
    if init is None:
        out.zero_()
    elif out.data_ptr() != init.data_ptr():
        out.copy_(init)
    tf32 = bool(fast_accum) and X.device.type == "cuda"
    old = torch.backends.cuda.matmul.allow_tf32
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        tile = torch.exp(-_sqdist(X, X[lo:hi]) / sigma)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            out.addmm_(tile, V[lo:hi])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    if out_scale is not None:
        out.mul_(float(out_scale))
    return out


def kernel_matmul(X, V, sigma, *, init=None, out_scale=None,
                  fast_accum: bool = False, impl: str = "auto",
                  block: int = 1024, out=None):
    """``(K(X)·V + init) · out_scale`` for X (N, P) and V (N, m), never
    materializing K.

    ``impl``: "auto" takes the CUDA kernel for f32 CUDA tensors and the
    plain version otherwise; "cuda" asks for the kernel (anything it does
    not take raises; a CPU tensor still runs the plain version, because it
    lies on the CPU); "plain" runs :func:`kernel_matmul_plain` with
    ``block`` columns of K per step.

    ``out`` (optional) receives the result. It may be the very buffer
    passed as ``init``: every output element is read once as ``init`` and
    then written once, by the same thread. That is the only aliasing
    allowed; ``out`` overlapping ``X`` or ``V`` raises. All tensors are
    contiguous, of one dtype, on one device. The launch goes to the
    current stream and does not synchronize."""
    if not _use_tile(X, impl) or X.device.type == "cpu":
        return kernel_matmul_plain(X, V, sigma, init=init,
                                   out_scale=out_scale,
                                   fast_accum=fast_accum, block=block,
                                   out=out)
    return _kernel_matmul_cuda(X, V, float(sigma), init, out_scale,
                               bool(fast_accum), out)


def _kernel_matmul_cuda(X, V, sigma, init, out_scale, fast_accum, out,
                        m_tiles: int = 0):
    """Launch the CUDA kernel. ``m_tiles`` forces the width of the block's
    output tile to 64·m_tiles columns (1 to 3); 0 lets the kernel choose.
    The result does not depend on it, bit for bit."""
    global kernel_matmul_launches, kernel_matmul_fast_launches
    if X.device.type != "cuda":
        raise ValueError(f"kernel_matmul: the CUDA kernel needs a CUDA "
                         f"tensor, got {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"kernel_matmul: the CUDA kernel takes float32, "
                        f"got {X.dtype}")
    _check(X, V, sigma, init, out)
    n, p = X.shape
    m = V.shape[1]
    if (m + 63) // 64 > 65535:
        raise ValueError(f"kernel_matmul: m={m} columns exceed the grid "
                         "limit")
    from ._build import library
    lib = library()
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    r = torch.empty((n,), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.kernel_matmul_f32(
            X.data_ptr(), V.data_ptr(),
            None if init is None else init.data_ptr(), r.data_ptr(),
            out.data_ptr(), n, p, m, sigma,
            1.0 if out_scale is None else float(out_scale),
            int(fast_accum), int(m_tiles), stream)
    if err != 0:
        raise RuntimeError(f"kernel_matmul: CUDA launch failed with error "
                           f"{err}")
    kernel_matmul_launches += 1
    if fast_accum:
        kernel_matmul_fast_launches += 1
    return out
