"""Dense post-kernel fit core: eigh → lastkeeper → λ bounds → golden
search → spectral solve.

Port of ``bigkrls_tpu/ops/fused.py::postkernel_device``, the route for
N < 2048 and the adaptive route's fallback. JAX runs it as one XLA
program; PyTorch runs it eagerly on the device, the golden-section loop
in chunks of steps with one host read each (``ops.solve.golden_solve``).
The JAX program's heartbeat (an ordered ``io_callback`` per iteration)
is ticked from those reads: every ``HEARTBEAT_EVERY``-th iteration, into
the sink a fit registers (:func:`set_heartbeat_log`), for fits above
``HEARTBEAT_MIN_N`` rows (``model.fit`` gates it), at no extra read.

Truncation keeps the JAX program's mask form: the spectral filter
``1/(λₖ+λ)`` is multiplied by a mask zeroing k ≥ lastkeeper, which is
algebraically the reference's hard slice. The bounds are the device
bisections of the JAX program, in working precision, over the full
value list.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .solve import golden_solve

_EPS = 2.220446049250313e-16  # R's .Machine$double.eps

HEARTBEAT_EVERY = 4
HEARTBEAT_MIN_N = 8192
_heartbeat_log = [print]


def set_heartbeat_log(log) -> None:
    """Register the sink for heartbeat ticks (the fit's ``log=`` arg)."""
    _heartbeat_log[0] = log


def _heartbeat():
    """``progress`` for the golden search: a tick line for every
    ``HEARTBEAT_EVERY``-th iteration a chunk passed."""
    last = 0

    def progress(it: int):
        nonlocal last
        first = (last // HEARTBEAT_EVERY + 1) * HEARTBEAT_EVERY
        for i in range(first, it + 1, HEARTBEAT_EVERY):
            _heartbeat_log[0](f"  golden-section iteration {i}")
        last = it
    return progress


def _sum_filter(values, lam):
    return torch.sum(values / (values + lam))


def _bisect(cond_k, lo, hi, steps: int):
    """``steps`` bisection steps for the smallest k in [lo, hi] with
    ``cond_k(k)`` (monotone), on the device without host reads."""
    for _ in range(steps):
        mid = (lo + hi) // 2
        hit = cond_k(mid)
        lo, hi = torch.where(hit, lo, mid + 1), torch.where(hit, mid, hi)
    return lo


def _upper_bound_device(values, n: int):
    """Largest U in {n, n-1, ...} with Σ λₖ/(λₖ+U) ≥ 1, as integer
    bisection over k = n−U."""
    dt, dev = values.dtype, values.device

    def cond_k(k):
        return _sum_filter(values, n - k.to(dt)) >= 1.0

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lo = _bisect(cond_k, zero, zero + n, max(1, (n + 1).bit_length()))
    return n - lo.to(dt)


def _lower_bound_device(values):
    """L = eps + 0.05·k, smallest k with Σ λₖ/(λₖ+L) ≤ q,
    q = 1-based argmin |λₖ − λ₁/1000|, with the analytic bracket
    k ≤ n·λ₁/q/0.05 (saturated before the integer cast)."""
    dt, dev = values.dtype, values.device
    n = values.shape[0]
    q = (torch.argmin(torch.abs(values - values[0] / 1000.0)) + 1).to(dt)

    def cond_k(k):
        return _sum_filter(values, _EPS + 0.05 * k.to(dt)) <= q

    k_hi = torch.clamp_max(torch.ceil((n * values[0] / q) / 0.05) + 1.0,
                           2.0 ** 31 - 1).to(torch.int64)
    lo = _bisect(cond_k, torch.zeros((), dtype=torch.int64, device=dev),
                 k_hi, 48)
    return _EPS + 0.05 * lo.to(dt)


def postkernel_device(K, y_std, eigtrunc: float, tol: float,
                      log: Optional[Callable[[str], None]] = None,
                      heartbeat: bool = False):
    """Returns ``(values, vectors, lastkeeper, lam, Le, coeffs, spectrum,
    iters)`` like the JAX function: ``vectors`` is the full eigenbasis,
    ``spectrum`` the masked ``1/(λₖ+λ)²`` filter, ``lastkeeper`` and
    ``lam`` host numbers (one read). ``log`` receives the golden-section
    brackets; ``heartbeat`` ticks the iterations into the registered
    sink."""
    from .eig import _eigh_desc

    n = K.shape[0]
    dt = y_std.dtype
    values, vectors = _eigh_desc(K)

    keep = values >= eigtrunc * values[0]
    idx = torch.arange(n, device=K.device)
    lastkeeper = torch.clamp_min(
        torch.max(torch.where(keep, idx, -1)) + 1, 1)
    mask = (idx < lastkeeper).to(dt)

    U = _upper_bound_device(values, n)
    L = torch.clamp_min(_lower_bound_device(values), _EPS)

    lam, Le, coeffs, it = golden_solve(
        vectors, values, y_std, L, U, tol, mask=mask, log=log,
        progress=_heartbeat() if heartbeat else None)
    spectrum = mask / (values + lam) ** 2
    lk, lam_h = torch.stack([lastkeeper.to(torch.float64),
                             lam.to(torch.float64)]).tolist()
    return (values, vectors, int(lk), lam_h, Le, coeffs, spectrum, it)
