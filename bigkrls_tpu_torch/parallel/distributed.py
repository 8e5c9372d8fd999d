"""Multi-process initialization, ported from
``bigkrls_tpu/parallel/distributed.py`` onto ``torch.distributed``.

One process per host (or per card) joins a process group; a mesh built
by :func:`global_mesh` then holds every process's shards, each process
keeping its own (``parallel/sharded.py``). The ring's rotation across a
process boundary, and a shard that another process's block needs, travel
by point-to-point sends (:func:`exchange`); reductions over shards
all-gather the per-shard partials (:func:`all_partials`) and sum them in
shard order on every process, and the small results every process uses
are process 0's, broadcast (:func:`broadcast_from_zero`), so no process
takes another branch. The backend is gloo for CPU shards and NCCL for
CUDA ones.

The JAX semantics are kept: with no arguments and no cluster environment
the call is a no-op (one process); with explicit arguments, a group that
cannot form raises; a second call changes nothing.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

log = logging.getLogger("bigkrls_tpu_torch")

# the environment a launcher such as torchrun sets for every process
_CLUSTER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
# and the process's place among those of its host
_LOCAL_ENV = ("LOCAL_RANK", "LOCAL_WORLD_SIZE")


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _launcher_device_ids():
    """This process's share of the host's cards under a launcher
    (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``): per = visible cards // local
    processes, and local rank r takes cards r·per … r·per + per − 1, as
    ``jax.distributed.initialize`` gives each process its own devices.
    None outside a launcher."""
    if not all(k in os.environ for k in _LOCAL_ENV):
        return None
    rank, size = (int(os.environ[k]) for k in _LOCAL_ENV)
    count = torch.cuda.device_count()
    per = count // size
    if per < 1 or not 0 <= rank < size:
        raise RuntimeError(f"local rank {rank} of {size} processes cannot "
                           f"take its own card of the {count} visible")
    return range(rank * per, (rank + 1) * per)


def _local_devices(device_type: str, local_device_ids=None):
    """This process's devices: ``local_device_ids`` where given, else its
    share of the cards under a launcher, else every visible card (one
    ``cpu``, or ``len(local_device_ids)`` of them, for CPU shards)."""
    if device_type == "cuda":
        ids = local_device_ids
        if ids is None:
            ids = _launcher_device_ids()
        if ids is None:
            ids = range(torch.cuda.device_count())
        return [torch.device("cuda", int(i)) for i in ids]
    n = 1 if local_device_ids is None else len(local_device_ids)
    return [torch.device("cpu")] * n


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
    timeout_s: float = 60.0,
) -> int:
    """Join the process group; returns the global device count (this
    process's local devices, summed over processes).

    ``coordinator_address`` is "host:port" of rank 0; ``num_processes``
    the world size and ``process_id`` this process's rank. With none of
    them and no cluster environment (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``, as a launcher sets them) the call is the single-process
    no-op. An explicit request that cannot form, including a world of
    more than one process without an address, raises. ``device_type``
    ("cuda" or "cpu", default "cuda" when a card is visible) picks NCCL or
    gloo; ``local_device_ids`` names this process's CUDA devices (for
    "cpu", its length is the number of virtual CPU shards); without it a
    process under a launcher takes its own share of the host's cards
    (:func:`_launcher_device_ids`). Under NCCL the process's current
    device is set to its first card before the group forms."""
    import torch.distributed as dist
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    local = _local_devices(device_type, local_device_ids)
    if is_initialized():
        return _global_count(len(local))

    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    env = all(k in os.environ for k in _CLUSTER_ENV)
    if not explicit and not env:
        log.debug("single-process run: no cluster arguments or environment")
        return len(local)
    if explicit and (coordinator_address is None or num_processes is None
                     or process_id is None):
        raise ValueError(
            "initialize_distributed: an explicit multi-process request needs "
            "coordinator_address, num_processes and process_id")
    backend = "nccl" if device_type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl" and local:
        torch.cuda.set_device(local[0])
    if explicit:
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
    else:
        dist.init_process_group(backend=backend, init_method="env://",
                                timeout=timeout)
    return _global_count(len(local))


def _global_count(n_local: int) -> int:
    """Every process's local device count, summed (a collective)."""
    import torch.distributed as dist
    if not is_initialized():
        return n_local
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(n_local))
    return sum(counts)


def global_mesh(shape: Optional[Sequence[int]] = None,
                local_devices: Optional[Sequence] = None):
    """A 2-D ("i", "j") mesh over every process's devices, rank by rank.
    ``local_devices`` are this process's (default: its cards, as
    :func:`initialize_distributed` took them, else one ``cpu``; CPU shards
    may repeat ``cpu``)."""
    import torch.distributed as dist

    from .sharded import Mesh, make_mesh
    if local_devices is None:
        local_devices = _local_devices(
            "cuda" if torch.cuda.is_available() else "cpu")
    local_devices = [torch.device(d) for d in local_devices]
    if not is_initialized():
        return make_mesh(shape=shape, devices=local_devices)
    world = dist.get_world_size()
    everyone = [None] * world
    dist.all_gather_object(everyone, [str(d) for d in local_devices])
    devices, procs = [], []
    for rank, names in enumerate(everyone):
        devices += [torch.device(nm) for nm in names]
        procs += [rank] * len(names)
    mesh = make_mesh(shape=shape, devices=devices)
    return Mesh(mesh.devices, mesh.axis_names,
                processes=np.asarray(procs).reshape(mesh.devices.shape))


def process_info(local_devices: Optional[int] = None) -> dict:
    """This process's index, the process count and the device split (the
    JAX keys). ``local_devices`` defaults to this process's cards, as
    :func:`initialize_distributed` took them (one, the CPU, without a
    card)."""
    import torch.distributed as dist
    n_local = local_devices
    if n_local is None:
        n_local = len(_local_devices("cuda")) if torch.cuda.is_available() \
            else 1
    init = is_initialized()
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": dist.get_world_size() if init else 1,
        "local_devices": int(n_local),
        "global_devices": _global_count(int(n_local)),
    }


# ---------------------------------------------------------------------------
# collectives of a mesh that spans processes (``parallel/sharded.py``)
# ---------------------------------------------------------------------------

def comm_device() -> torch.device:
    """The device the process group's collectives take: the current CUDA
    device under NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_partials(partials, owners, shapes, dtype, device):
    """Every shard's partial result on every process: ``partials[s]`` is
    this process's tensor for shard ``s`` (None where another process,
    ``owners[s]``, holds it) of shape ``shapes[s]``. Each process
    all-gathers the flat concatenation of its own slots (zeros elsewhere)
    and takes slot ``s`` from its owner's copy, so every process holds the
    same bits and sums them in the same order."""
    import torch.distributed as dist
    comm = comm_device()
    sizes = [int(np.prod(s)) for s in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    mine = torch.zeros(int(offs[-1]), dtype=dtype, device=comm)
    for s, p in enumerate(partials):
        if p is not None:
            mine[offs[s]:offs[s + 1]] = p.reshape(-1).to(comm)
    bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, mine)
    return [bufs[int(owners[s])][offs[s]:offs[s + 1]].reshape(shapes[s])
            .to(device) for s in range(len(shapes))]


def broadcast_from_zero(tensors):
    """``tensors`` as process 0 holds them, on every process: the small
    results a mesh fit computes once and replicates (a Ritz ``eigh``, a
    Cholesky factor, λ*), so that no process takes another branch."""
    import torch.distributed as dist
    comm = comm_device()
    out = []
    for t in tensors:
        buf = t.detach().to(comm).contiguous().clone()
        dist.broadcast(buf, src=0)
        out.append(buf.to(t.device))
    return out


def exchange(sends, recvs):
    """Point-to-point transfers: ``sends`` are (tensor, rank), ``recvs``
    (buffer, rank), listed in the same global order on every process so
    that each pair's messages match in turn."""
    import torch.distributed as dist
    comm = comm_device()
    keep = [(t.to(comm).contiguous(), r) for t, r in sends]
    ops = ([dist.P2POp(dist.isend, t, r) for t, r in keep]
           + [dist.P2POp(dist.irecv, b, r) for b, r in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
