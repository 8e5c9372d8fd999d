"""Ring-pass Gaussian kernel and kernel-free ring product, ported from
``bigkrls_tpu/parallel/ring_kernel.py``.

X is row-sharded over a 1-D ring of D shards. At each of D steps every
shard works against a *visiting* row block and then passes that block to
its ring neighbour (shard k receives shard k+1's block, the JAX package's
``ppermute`` permutation), so no shard needs more than its own rows and
one visiting block:

* :func:`ring_gauss_kernel` builds the shard's (N/D × N) stripe of K from
  one kernel tile per step;
* :func:`make_ring_matmul` computes Y = K(X)·V with X and V both rotating:
  each step is one call of the kernel-free product's cross entry,
  ``ops/matvec.kernel_matmul_cross(X_own, X_visit, V_visit, init=acc,
  out=acc)``, on the shard's device, so a D-shard product is D² launches of
  the hand-written kernel (where the JAX package's ring runs XLA tiles). It
  takes and returns row shards, so a streaming fit's basis never leaves
  them.

Virtual shards (a ring of 4 over one device) alias: moving a block to the
device it is on returns the same tensor. The visiting blocks are only ever
read, and the rotation passes references (or, between devices, copies),
so no step writes into a buffer another shard still reads. Between
processes the rotation is ``torch.distributed.batch_isend_irecv``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .sharded import (Mesh, ShardedTensor, _rank, count_between_cards, dense,
                      move, spans_processes)


def make_ring_mesh(devices=None) -> Mesh:
    """A 1-D ring mesh (axis "r") over ``devices`` (default every visible
    CUDA device; entries may repeat)."""
    from .sharded import _default_devices
    devices = _default_devices() if devices is None else [
        torch.device(d) for d in devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, axis_names=("r",))


def ring_mesh_of(mesh: Mesh) -> Mesh:
    """Any mesh's devices, flattened in order into a ring (axis "r")."""
    if mesh.axis_names == ("r",):
        return mesh
    return Mesh(mesh.devices.reshape(-1), axis_names=("r",),
                processes=mesh.processes.reshape(-1))


def _rotate(blocks, mesh: Mesh):
    """One ring step over ``blocks``, a list of tuples of tensors, one per
    shard: shard k's new visiting tuple is shard k+1's current one. In one
    process that is a reference (or a copy to k's device); across
    processes the tensors travel by ``batch_isend_irecv``."""
    d = mesh.size
    if not spans_processes(mesh):
        return [tuple(move(t, mesh.devices[k]) for t in blocks[(k + 1) % d])
                for k in range(d)]
    import torch.distributed as dist

    from .distributed import comm_device
    # NCCL takes the tensors of one card a process: its current one. A
    # block that leaves or reaches another of the process's cards goes
    # through that card.
    comm = comm_device()
    me = _rank()
    ops, new, landed = [], [None] * d, []
    for k in range(d):
        src = (k + 1) % d
        owner_k, owner_src = int(mesh.processes[k]), int(mesh.processes[src])
        if owner_k == me and owner_src == me:
            new[k] = tuple(move(t, mesh.devices[k]) for t in blocks[src])
        elif owner_k == me:
            # same shapes as this shard's own tuple: ring blocks are equal
            new[k] = tuple(torch.empty_like(t, device=comm)
                           for t in blocks[k])
            ops += [dist.P2POp(dist.irecv, t, owner_src) for t in new[k]]
            landed.append(k)
        elif owner_src == me:
            for t in blocks[src]:
                t = move(t, comm)
                count_between_cards(t.numel() * t.element_size())
                ops.append(dist.P2POp(dist.isend, t, owner_k))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for k in landed:
        new[k] = tuple(move(t, mesh.devices[k]) for t in new[k])
    return new


def _ring_blocks(X, mesh: Mesh, npad: int):
    """X zero-padded to ``npad`` rows and split into the ring's row blocks
    (views of one contiguous buffer where no padding is needed); blocks of
    another process are None."""
    X = X.contiguous()
    n = X.shape[0]
    if npad != n:
        Xp = X.new_zeros((npad,) + tuple(X.shape[1:]))
        Xp[:n] = X
        X = Xp
    b = npad // mesh.size
    return [move(X[k * b:(k + 1) * b], mesh.devices[k]) if mesh.local(k)
            else None for k in range(mesh.size)]


def ring_gauss_kernel(mesh: Mesh, X_std, sigma) -> ShardedTensor:
    """The N×N Gaussian kernel, row-sharded over the ring: at each step a
    shard builds the tile of its rows against the visiting block
    (``ops/kernels.gauss_tile``; the plain version for CPU tensors and
    float64) and places it in its stripe. N must be divisible by the ring
    size (:func:`padded_ring_kernel` pads). Unlike ``gauss_kernel``, the
    stripe holds the rank-P formula's diagonal, as the JAX ring's does."""
    from ..ops.kernels import _use_tile, gauss_tile, gauss_tile_plain
    X = dense(X_std)
    d = mesh.size
    n = X.shape[0]
    if n % d:
        raise ValueError(f"N={n} not divisible by ring size {d}")
    b = n // d
    tile = gauss_tile if _use_tile(X, "auto") else gauss_tile_plain
    own = _ring_blocks(X, mesh, n)
    stripes = [torch.empty((b, n), dtype=X.dtype, device=mesh.devices[k])
               if mesh.local(k) else None for k in range(d)]
    visit = [(t,) for t in own]
    for s in range(d):
        for k in range(d):
            if stripes[k] is None:
                continue
            col = ((k + s) % d) * b
            stripes[k][:, col:col + b] = tile(own[k], visit[k][0],
                                              float(sigma), False)
        if s + 1 < d:
            visit = _rotate(visit, mesh)
    return ShardedTensor(mesh, "row", (n, n), stripes)


def padded_ring_kernel(mesh: Mesh, X_std, sigma):
    """The ring kernel for any N: rows zero-padded to a multiple of the
    ring size (exact: padded rows only fill stripe rows and columns that
    are sliced away), gathered and cut to N × N."""
    X = dense(X_std)
    d = mesh.size
    n = X.shape[0]
    npad = -(-n // d) * d
    Xp = X
    if npad != n:
        Xp = X.new_zeros((npad, X.shape[1]))
        Xp[:n] = X
    return ring_gauss_kernel(mesh, Xp, sigma).full()[:n, :n]


@functools.lru_cache(maxsize=8)
def make_ring_matmul(mesh: Mesh, impl: str = "auto"):
    """The kernel-free ring product over ``mesh``'s shards, with the
    signature of ``ops/matvec.kernel_matmul``:

        ring_matmul(X, V, sigma, *, init=None, out_scale=None,
                    fast_accum=False, out=None) -> (K(X)·V + init)·out_scale

    so ``eigensystem_streaming`` (including the Chebyshev flow's fused
    step), ``derivatives_streaming`` and the fit take it as their
    ``matmul``. Each shard's output block starts from its rows of ``init``
    at step 0; every step is one ``kernel_matmul_cross(X_own, X_visit,
    V_visit, init=acc, out=acc)``; ``out_scale`` is applied by the last
    step. ``fast_accum`` is passed to every step (TF32 on tile·V only),
    where the JAX package's ring ignores it.

    A row-sharded V (over this ring, N divisible by its size) gives a
    row-sharded result: X (row-sharded alike, or dense), ``init`` and
    ``out`` are row-sharded too, each shard's block of ``out`` is written
    in place (it may be ``init``'s), and no shard holds X, V or Y whole. A
    dense V gives a dense result: the operands are zero-padded to a
    multiple of the ring size (the padded rows of V are 0, so the padded
    columns of K add exactly 0 even though K of a zero row is not 0), and
    the result is gathered and cut to N rows; ``out`` receives it and may
    be ``init``. Cached per mesh and ``impl``, as the JAX package caches
    its ring product."""
    from ..ops.matvec import kernel_matmul_cross
    d = mesh.size

    def steps(xs, vs, inits, accs, sigma, out_scale, fast_accum):
        visit = list(zip(xs, vs))
        for s in range(d):
            last = s + 1 == d
            for k in range(d):
                if xs[k] is None:
                    continue
                xv, vv = visit[k]
                kernel_matmul_cross(
                    xs[k], xv, vv, sigma,
                    init=inits[k] if s == 0 else accs[k],
                    out_scale=out_scale if last else None,
                    fast_accum=fast_accum, impl=impl, out=accs[k])
            if not last:
                visit = _rotate(visit, mesh)

    def sharded(X, V, sigma, init, out_scale, fast_accum, out):
        n, m = V.shape
        for t in (X, init, out):
            if isinstance(t, ShardedTensor) and (t.mesh is not mesh
                                                 or t.spec != "row"):
                raise ValueError(f"ring product: {t} is not row-sharded "
                                 f"over this ring")
        if V.mesh is not mesh or V.spec != "row" or n % d:
            raise ValueError(f"ring product: a sharded V must be "
                             f"row-sharded over this ring with N divisible "
                             f"by {d}, got {V}")
        xs = (X.shards if isinstance(X, ShardedTensor)
              else _ring_blocks(X, mesh, n))
        vs = [None if v is None else v.contiguous() for v in V.shards]
        inits = init.shards if init is not None else [None] * d
        accs = (out.shards if out is not None else
                [None if v is None else v.new_empty((n // d, m))
                 for v in vs])
        steps(xs, vs, inits, accs, sigma, out_scale, fast_accum)
        if out is not None:
            return out
        return ShardedTensor(mesh, "row", (n, m), accs, V.dtype)

    def ring_matmul(X, V, sigma, *, init=None, out_scale=None,
                    fast_accum: bool = False, out=None):
        if isinstance(V, ShardedTensor):
            return sharded(X, V, sigma, init, out_scale, fast_accum, out)
        X = dense(X, label="ring product: X of a dense V")
        init = dense(init, label="ring product: init of a dense V")
        n, m = X.shape[0], V.shape[1]
        if V.shape[0] != n:
            raise ValueError(f"ring matmul: X has {n} rows, V {V.shape[0]}")
        npad = -(-n // d) * d
        xs = _ring_blocks(X, mesh, npad)
        vs = _ring_blocks(V, mesh, npad)
        inits = (_ring_blocks(init, mesh, npad) if init is not None
                 else [None] * d)
        if (out is not None and npad == n and not spans_processes(mesh)
                and all(dev == out.device for dev in mesh.devices.flat)):
            # every shard writes its rows of ``out`` in place
            accs = [out[k * (n // d):(k + 1) * (n // d)] for k in range(d)]
        else:
            accs = [xs[k].new_empty((npad // d, m)) if xs[k] is not None
                    else None for k in range(d)]
        steps(xs, vs, inits, accs, sigma, out_scale, fast_accum)
        if out is not None and accs[0] is not None and \
                accs[0].data_ptr() == out.data_ptr():
            return out
        Y = ShardedTensor(mesh, "row", (npad, m), accs, X.dtype).full(
            X.device, label="ring product: the result of a dense V")[:n]
        if out is None:
            return Y
        out.copy_(Y)
        return out

    ring_matmul.takes_fast_accum = True
    return ring_matmul
