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

import collections
import functools
import math

import torch

from ..utils.precision import rank_p_ieee

# launches of the CUDA kernel made through ``gauss_tile`` (CPU calls, which
# run the plain version, do not count), in all and by CUDA device index
gauss_tile_launches = 0
gauss_tile_launches_by_device: collections.Counter = collections.Counter()

KERNEL_IMPLS = ("auto", "plain", "cuda")
# the JAX package's names for the same choices: its XLA version is the
# plain one, its Pallas kernel the hand-written one
IMPL_ALIASES = {"xla": "plain", "pallas": "cuda"}


def resolve_impl(impl: str) -> str:
    """``impl`` with the JAX package's names mapped onto the port's;
    raises on anything else."""
    impl = IMPL_ALIASES.get(impl, impl)
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl must be one of "
                         f"{KERNEL_IMPLS + tuple(IMPL_ALIASES)}, got "
                         f"{impl!r}")
    return impl


def _sqdist(Xa, Xb):
    """Pairwise squared Euclidean distances via the rank-P identity; the
    product is IEEE fp32 under any precision setting."""
    ra = torch.sum(Xa * Xa, dim=1)
    rb = torch.sum(Xb * Xb, dim=1)
    with rank_p_ieee(Xa):
        g = Xa @ Xb.T
    d2 = ra[:, None] + rb[None, :] - 2.0 * g
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


# the kernel's square tiles, by edge: the blocks of each that share an SM,
# and what an entry of it costs beside one of the smaller tile's (measured:
# a thread of the larger tile owns 8 x 8 outputs instead of 8 x 4 and reads
# its operands from shared memory half as often)
_TILES = {64: (4, 1.0), 128: (2, 0.8)}
# what an entry's quotient and expf cost, in steps of the rank-P chain
_ENTRY_STEPS = 30
# the widest P the kernel stages whole; wider P runs in slices of _SLICE
_WHOLE_P, _SLICE = 72, 32
_MAX_BLOCKS = 2 ** 31 - 1       # CUDA's limit on a grid's x dimension
_lib = None                     # the loaded kernel library, after first use


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    """SMs of CUDA device ``index`` (None: the current one); asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tri_count(rows: int) -> int:
    """Tiles (I, J) with J >= I among ``rows`` tile rows."""
    return rows * (rows + 1) // 2


def _tri_decode(t: int):
    """The t-th pair (r, c), c <= r, of the lower triangle in row-major
    order, t = r(r+1)/2 + c: the kernel's map from a block index to its
    tile (I, J) = (c, r), line for line. The square root is a first guess;
    the loops make the answer exact."""
    r = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > t:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= t:
        r += 1
    return r, t - r * (r + 1) // 2


def _blocks(m: int, n: int, tile: int, mirror: bool) -> int:
    """Blocks of the grid: one per tile, only those with J >= I under
    ``mirror``."""
    rows, cols = -(-m // tile), -(-n // tile)
    return _tri_count(rows) if mirror else rows * cols


def _tile_plan(m: int, n: int, p: int, mirror: bool, sms: int) -> int:
    """The edge of the kernel's square tile, 64 or 128, as a pure function
    of the shape and the card's SM count.

    The blocks run in waves of ``sms`` x (blocks of that tile an SM holds),
    and the blocks on an SM share its issue slots, so a wave costs (blocks
    resident on an SM) x (the tile's entries) x (P chain steps + the entry
    arithmetic) x the tile's cost per entry. The tile with the least waves
    x that wins: 64 wherever 128 would end on a mostly empty wave or cover
    rows that do not exist (the fit's 3106 rows, predict's 10), 128 from a
    few thousand rows on. Every entry sees the same operations in the same
    order whatever the tile, so the choice does not change the result."""
    def cost(tile):
        per_sm, per_entry = _TILES[tile]
        blocks = _blocks(m, n, tile, mirror)
        waves = -(-blocks // (sms * per_sm))
        resident = min(per_sm, -(-blocks // sms))
        return (waves * resident * tile * tile * (p + _ENTRY_STEPS)
                * per_entry)

    return min(_TILES, key=cost)


@functools.lru_cache(maxsize=256)
def _launch_plan(m: int, n: int, p: int, mirror: bool, sms: int, tile):
    """``(tile, slice width)`` of one launch, worked out once per shape;
    ``tile`` None takes :func:`_tile_plan`'s. Raises on a tile the kernel
    does not have and on a grid past CUDA's limit."""
    if tile is None:
        tile = _tile_plan(m, n, p, mirror, sms)
    elif tile not in _TILES:
        raise ValueError(f"gauss_tile: tile must be one of {tuple(_TILES)}")
    if _blocks(m, n, tile, mirror) > _MAX_BLOCKS:
        raise ValueError(f"gauss_tile: {m} x {n} outputs exceed the grid "
                         "limit")
    return tile, _slice_width(p)


def _slice_width(p: int) -> int:
    """Columns of X staged in shared memory at once: P rounded up to a
    multiple of 4 where that is at most 72 (one stage), else 32 (two
    stages, one in flight)."""
    p4 = -(-p // 4) * 4
    return p4 if p4 <= _WHOLE_P else _SLICE


def _shared_bytes(tile: int, p: int) -> int:
    """Dynamic shared memory of one block: the staged rows of A and B at a
    pitch of 4 x odd floats, or the finished tile at a pitch of tile + 1
    that reuses the same memory, whichever is larger."""
    kc = _slice_width(p)
    pitch = kc if (kc // 4) % 2 else kc + 4
    stages = 2 if -(-p // 4) * 4 > kc else 1
    return 4 * max(stages * 2 * tile * pitch, tile * (tile + 1))


def _padded_pitch(p: int, *pointers) -> int:
    """The row pitch, in floats, of the copy of X that the kernel's 16-byte
    copies need, or 0 where X serves as it is: P a multiple of 4 and every
    pointer 16-byte aligned. The copy has zeros in the columns from P to
    the pitch (a zero factor leaves the rank-P chain bit-unchanged)."""
    if p % 4 == 0 and all(ptr % 16 == 0 for ptr in pointers):
        return 0
    return -(-p // 4) * 4


def _gauss_tile_cuda(A, B, sigma: float, symmetric_diag: bool, tile=None,
                     mirror: bool | None = None):
    """Launch the CUDA kernel. ``tile`` forces the tile's edge (64 or 128);
    None takes :func:`_tile_plan`'s. ``mirror=False`` computes every tile
    of a symmetric call. The result depends on neither, bit for bit; tools
    and tests use them."""
    global gauss_tile_launches, _lib
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
    if not sigma > 0:
        raise ValueError("gauss_tile: sigma must be positive")
    pa, pb = A.data_ptr(), B.data_ptr()
    same = pa == pb and m == n
    if mirror is None:
        mirror = same
    elif mirror and not same:
        raise ValueError("gauss_tile: mirror needs A and B to be the same "
                         "rows")
    index = A.device.index
    tile, kc = _launch_plan(m, n, p, mirror, _sm_count(index), tile)
    if _lib is None:
        from ._build import library
        _lib = library()
    out = A.new_empty((m, n))
    pitch = _padded_pitch(p, pa, pb)
    scratch = None
    if pitch:
        scratch = A.new_empty((max(m, n) if pa == pb else m + n, pitch))
    # the stream's handle without building a Stream object: the wrapper's
    # host time is most of a call that the card answers in 6 to 40 us
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (pa, pb, m, n, p, None if scratch is None else scratch.data_ptr(),
            sigma, out.data_ptr(), int(bool(symmetric_diag)), int(mirror),
            tile, kc, stream)
    if torch.cuda.current_device() == index:
        err = _lib.gauss_tile_f32(*args)
    else:
        with torch.cuda.device(A.device):
            err = _lib.gauss_tile_f32(*args)
    if err != 0:
        raise RuntimeError(f"gauss_tile: CUDA launch failed with error {err}")
    gauss_tile_launches += 1
    gauss_tile_launches_by_device[index] += 1
    return out


def _use_tile(t, impl: str) -> bool:
    impl = resolve_impl(impl)
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
