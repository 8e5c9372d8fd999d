"""Kernel-free product: Y = K(X) · V without materializing K.

Port of ``bigkrls_tpu/ops/matvec.py``. Every consumer of the N×N kernel in
the fit is a product K·V (the eigensolver's power steps, the Ritz K·B, ŷ,
and the derivatives' stacked right-hand side), so past the size where K
fits in memory the fit recomputes K tile by tile from X, at 2N²(P+m) FLOP
per product and O(N·(P+m)) storage.

One entry point, :func:`kernel_matmul`, replaces the JAX package's
``kernel_matmul``, ``kernel_matmul_pallas`` and their ``_fast`` aliases
(:func:`kernel_matmul_cross` is the same product between two row sets,
one step of the ring product in ``parallel/ring_kernel.py``):

    Y = (K(X)·V + init) · out_scale,
    K_ij = exp(−max(rᵢ + rⱼ − 2 xᵢ·xⱼ, 0)/σ)

with ``init`` and ``out_scale`` optional. Like the JAX product, and unlike
``gauss_kernel``, it writes no exact-1 diagonal. Two implementations:

* the hand-written CUDA kernel ``csrc/kernel_matmul.cu`` (the port of the
  Pallas ``_km_kernel``): f32 CUDA tensors; the K tiles live only on chip
  and tile·V runs on the tensor cores;
* :func:`kernel_matmul_plain`: the blocked PyTorch loop, one (N, block)
  tile of K at a time. It serves CPU tensors, float64 fits and
  ``impl="plain"``.

The rank-P distance part is IEEE fp32 in every mode, since its errors land
inside exp(). Only the tile·V contraction differs:

* precise (the default): the split-TF32 product. The tile and V are each
  written as hi + lo, both parts rounded to TF32's 10 mantissa bits, and
  lo·hi + hi·lo + hi·hi is summed in fp32: the counterpart of the JAX
  package's ``Precision.HIGHEST``, itself a multi-pass product on the
  matrix unit. The dropped lo·lo term and the rounding of the lo parts are
  2⁻²² relative per product. :func:`kernel_matmul_split_plain` is the
  plain PyTorch version of this arithmetic;
* ``fast_accum``: one pass on the hi parts (TF32).

The kernel also holds an IEEE fp32 FMA pass without tensor cores
(``mode="fma"`` of :func:`_kernel_matmul_cuda`), which the split product is
measured against; no public argument reaches it.
"""
from __future__ import annotations

import collections

import torch

from .kernels import _sm_count, _sqdist, _use_tile

# launches of the CUDA kernel made through ``kernel_matmul`` and
# ``kernel_matmul_cross`` (calls that run the plain version do not count);
# fast-mode launches count in the fast count too, cross-entry launches in
# the cross count too
kernel_matmul_launches = 0
kernel_matmul_fast_launches = 0
kernel_matmul_cross_launches = 0
# the same launches by shape and mode, (N, Nb, P, m, mode) with Nb = 0 for
# the square entry: what work they did, for a bound on its time
kernel_matmul_shapes: collections.Counter = collections.Counter()
# and by CUDA device index
kernel_matmul_launches_by_device: collections.Counter = collections.Counter()


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


def _check(X, V, sigma, init, out, Xb=None):
    """Argument checks shared by both implementations, so that a call the
    CUDA kernel would refuse is refused on the CPU too. ``Xb`` (Nb, P) is
    the cross entry's second row set; V then has Nb rows and init/out
    X's rows."""
    Xb = X if Xb is None else Xb
    if (X.dim() != 2 or Xb.dim() != 2 or V.dim() != 2
            or Xb.shape[0] != V.shape[0] or X.shape[1] != Xb.shape[1]):
        raise ValueError(f"kernel_matmul: need X (Na, P), Xb (Nb, P) and V "
                         f"(Nb, m), got {tuple(X.shape)}, {tuple(Xb.shape)} "
                         f"and {tuple(V.shape)}")
    if 0 in X.shape or 0 in Xb.shape or 0 in V.shape:
        raise ValueError(f"kernel_matmul: empty operand {tuple(X.shape)}, "
                         f"{tuple(Xb.shape)}, {tuple(V.shape)}")
    if not sigma > 0:
        raise ValueError("kernel_matmul: sigma must be positive")
    shape = (X.shape[0], V.shape[1])
    for name, t in (("X", X), ("Xb", Xb), ("V", V), ("init", init),
                    ("out", out)):
        if t is None:
            continue
        if t.dtype != X.dtype or t.device != X.device:
            raise TypeError(f"kernel_matmul: {name} is {t.dtype} on "
                            f"{t.device}, X is {X.dtype} on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"kernel_matmul: {name} must be contiguous")
    for name, t in (("init", init), ("out", out)):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"kernel_matmul: {name} must have the shape "
                             f"{shape}, got {tuple(t.shape)}")
    if out is not None:
        if _overlaps(out, V) or _overlaps(out, X) or _overlaps(out, Xb):
            raise ValueError("kernel_matmul: out must not alias X or V")
        if init is not None and _overlaps(out, init) and (
                out.data_ptr() != init.data_ptr()):
            raise ValueError("kernel_matmul: out may alias init only as the "
                             "same buffer")


def kernel_matmul_plain(X, V, sigma, *, init=None, out_scale=None,
                        fast_accum: bool = False, block: int = 1024,
                        out=None, Xb=None):
    """Plain PyTorch version of the CUDA kernel: a loop over column blocks
    of K, each step materializing one (N, block) tile. With ``Xb`` it is
    the cross entry's: K(X, Xb)·V for V with Xb's rows.

    The tile·V product is a plain f32 ``addmm``; ``fast_accum`` runs it
    (and nothing else) under TF32 on a CUDA tensor and has no effect on the
    CPU. ``out`` receives the result
    and may be ``init`` itself."""
    sigma = float(sigma)
    _check(X, V, sigma, init, out, Xb)
    Xb = X if Xb is None else Xb
    n = Xb.shape[0]
    if out is None:
        out = X.new_empty((X.shape[0], V.shape[1]))
    if init is None:
        out.zero_()
    elif out.data_ptr() != init.data_ptr():
        out.copy_(init)
    tf32 = bool(fast_accum) and X.device.type == "cuda"
    old = torch.backends.cuda.matmul.allow_tf32
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        tile = torch.exp(-_sqdist(X, Xb[lo:hi]) / sigma)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            out.addmm_(tile, V[lo:hi])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    if out_scale is not None:
        out.mul_(float(out_scale))
    return out


def _tf32_round(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, by integer masking: the kernel's own two integer
    operations, and what ``cvt.rna.tf32.f32`` gives for finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x):
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def kernel_matmul_split_plain(X, V, sigma, *, init=None, out_scale=None,
                              block: int = 1024, out=None, fast: bool = False,
                              Xb=None):
    """Plain PyTorch version of the kernel's precise mode: the tile from
    the same rank-P formula in f32, then tile = hi + lo and V = hi + lo
    (:func:`_tf32_round`) and three f32 ``addmm``s, lo·hi + hi·lo + hi·hi;
    with ``fast``, of its fast mode: hi·hi alone. ``Xb`` as in
    :func:`kernel_matmul_plain`. It runs on the CPU, and on a CUDA tensor
    with TF32 switched off, so every sum is an IEEE one; tests, tools and
    ``chip_smoke.py`` use it, the package does not."""
    sigma = float(sigma)
    _check(X, V, sigma, init, out, Xb)
    if X.dtype != torch.float32:
        raise TypeError(f"kernel_matmul_split_plain: float32 only, got "
                        f"{X.dtype}")
    Xb = X if Xb is None else Xb
    n = Xb.shape[0]
    if out is None:
        out = X.new_empty((X.shape[0], V.shape[1]))
    if init is None:
        out.zero_()
    elif out.data_ptr() != init.data_ptr():
        out.copy_(init)
    v_hi, v_lo = _tf32_split(V)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            t_hi, t_lo = _tf32_split(torch.exp(-_sqdist(X, Xb[lo:hi])
                                               / sigma))
            if not fast:
                out.addmm_(t_lo, v_hi[lo:hi])
                out.addmm_(t_hi, v_lo[lo:hi])
            out.addmm_(t_hi, v_hi[lo:hi])
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


def kernel_matmul_cross(Xa, Xb, V, sigma, *, init=None, out_scale=None,
                        fast_accum: bool = False, impl: str = "auto",
                        block: int = 1024, out=None):
    """``(K(Xa, Xb)·V + init) · out_scale`` for Xa (Na, P), Xb (Nb, P) and
    V (Nb, m); the result is (Na, m). One step of the ring product: a
    shard's rows against a visiting block.

    The same kernel as :func:`kernel_matmul`, through its cross entry (two
    norm pre-passes, row and column bounds apart); ``kernel_matmul(X, V)``
    equals ``kernel_matmul_cross(X, X, V)`` bit for bit. ``impl``,
    ``fast_accum``, ``init``, ``out_scale`` and ``out`` as there: ``out``
    may be ``init`` itself and must not alias Xa, Xb or V."""
    if not _use_tile(Xa, impl) or Xa.device.type == "cpu":
        return kernel_matmul_plain(Xa, V, sigma, init=init,
                                   out_scale=out_scale,
                                   fast_accum=fast_accum, block=block,
                                   out=out, Xb=Xb)
    return _kernel_matmul_cuda(Xa, V, float(sigma), init, out_scale,
                               bool(fast_accum), out, Xb=Xb)


# widths of a block's output tile, in 64-column units (the kernel's NT). The
# widest, 5, is half of a pair: two blocks on neighbouring SMs, 320 columns
# each, that build one K tile between them (32 rows each, written into both
# blocks' shared memory)
_N_TILES = (1, 4, 5)
_PAIR = 5
# what building one 64 x 64 tile of K costs a block, in columns of tile·V:
# the build runs beside the product, so a block's step costs the larger
_BUILD_COLUMNS = 192
_MODES = {"split": 0, "fast": 1, "fma": 2}


def _tile_plan(n: int, p: int, m: int, sms: int) -> int:
    """The width of a block's output tile, in 64-column units, as a pure
    function of the shape and the card's SM count.

    A block of width w builds each K tile (half of it, in a pair) and
    multiplies it into its w columns meanwhile, so one of its steps costs
    max(w, build). The grid's ceil(n / 64) · ceil(m / w) blocks run in
    waves of one block per SM (two for the narrowest tile while P fits one
    chunk), and the width with the least waves · max(w, build) wins, the
    wider on a tie: the pair at m = 540 (one build per (i, j)), the
    narrowest at m = 22, and a narrower one than m suggests where wide
    tiles would leave SMs without a block. Every output element sees the
    same operations whatever the width, so the choice does not change the
    result."""
    rows = -(-n // 64)

    def cost(nt):
        per_sm = 2 if nt == 1 and p <= 32 else 1
        cols = -(-m // (64 * nt))
        build = _BUILD_COLUMNS
        if nt == _PAIR:
            cols, build = cols + cols % 2, build // 2
        waves = -(-rows * cols // (sms * per_sm))
        return waves * max(64 * nt, build)

    return min(_N_TILES, key=lambda nt: (cost(nt), -nt))


def _stage_v(V):
    """``V`` as the kernel takes it: 16-byte aligned with a row pitch that
    is a multiple of 4 floats, so that every copy into shared memory is 16
    bytes wide. Returns ``(buffer, pitch)``: ``V`` itself where it
    qualifies, else a copy into a buffer padded to the next multiple of 4
    columns (4·N·(pitch − m) extra bytes beside the copy of V; the pad
    columns are never read into a stored result)."""
    n, m = V.shape
    if m % 4 == 0 and V.data_ptr() % 16 == 0:
        return V, m
    pitch = -(-m // 4) * 4
    buf = torch.empty((n, pitch), dtype=V.dtype, device=V.device)
    buf[:, :m].copy_(V)
    return buf, pitch


def _kernel_matmul_cuda(X, V, sigma, init, out_scale, fast_accum, out,
                        n_tiles: int = 0, mode: str | None = None, Xb=None):
    """Launch the CUDA kernel. ``n_tiles`` forces the width of the block's
    output tile to 64·n_tiles columns (1, 4 or 5, the pair); 0 takes
    :func:`_tile_plan`'s. The result does not depend on it, bit for bit.
    ``mode`` ("split", "fast" or "fma") overrides the mode that
    ``fast_accum`` selects: "fma" is the IEEE fp32 pass without tensor
    cores that tools and tests measure the split product against. ``Xb``
    (not None) launches the cross entry."""
    global kernel_matmul_launches, kernel_matmul_fast_launches
    global kernel_matmul_cross_launches
    if X.device.type != "cuda":
        raise ValueError(f"kernel_matmul: the CUDA kernel needs a CUDA "
                         f"tensor, got {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"kernel_matmul: the CUDA kernel takes float32, "
                        f"got {X.dtype}")
    _check(X, V, sigma, init, out, Xb)
    n, p = X.shape
    m = V.shape[1]
    if (m + 63) // 64 > 65535:
        raise ValueError(f"kernel_matmul: m={m} columns exceed the grid "
                         "limit")
    if mode is None:
        mode = "fast" if fast_accum else "split"
    if mode not in _MODES:
        raise ValueError(f"kernel_matmul: unknown mode {mode!r}")
    if n_tiles == 0:
        n_tiles = _tile_plan(n, p, m, _sm_count(X.device.index))
    elif n_tiles not in _N_TILES:
        raise ValueError(f"kernel_matmul: n_tiles must be one of {_N_TILES}")
    from ._build import library
    lib = library()
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    nb = 0 if Xb is None else Xb.shape[0]
    r = torch.empty((n + nb,), dtype=torch.float32, device=X.device)
    Vk, ldv = _stage_v(V)
    init_ptr = None if init is None else init.data_ptr()
    scale = 1.0 if out_scale is None else float(out_scale)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        if Xb is None:
            err = lib.kernel_matmul_f32(
                X.data_ptr(), Vk.data_ptr(), ldv, init_ptr, r.data_ptr(),
                out.data_ptr(), n, p, m, sigma, scale, _MODES[mode],
                int(n_tiles), stream)
        else:
            err = lib.kernel_matmul_cross_f32(
                X.data_ptr(), n, Xb.data_ptr(), nb, Vk.data_ptr(), ldv,
                init_ptr, r.data_ptr(), out.data_ptr(), p, m, sigma, scale,
                _MODES[mode], int(n_tiles), stream)
    if err != 0:
        raise RuntimeError(f"kernel_matmul: CUDA launch failed with error "
                           f"{err}")
    kernel_matmul_launches += 1
    kernel_matmul_shapes[(n, nb, p, m, mode)] += 1
    kernel_matmul_launches_by_device[X.device.index] += 1
    if Xb is not None:
        kernel_matmul_cross_launches += 1
    if mode == "fast":
        kernel_matmul_fast_launches += 1
    return out
