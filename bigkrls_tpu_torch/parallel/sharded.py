"""Multi-device sharding for the KRLS fit, ported from
``bigkrls_tpu/parallel/sharded.py``.

The JAX design is GSPMD: a 2-D ``Mesh`` of devices on axes ("i", "j"),
``NamedSharding`` layouts on the arrays, and XLA partitions the products.
PyTorch has no such compiler, so the port keeps the JAX package's
single-controller shape, one Python process driving every shard of the
mesh it holds, and makes the partitioned operations explicit:

* :class:`Mesh` holds a numpy object array of ``torch.device`` with axis
  names. Devices may repeat: a mesh of 4 shards over ``cuda:0`` (or over
  ``cpu``) runs the multi-device logic on one device, the way the JAX
  suite runs it on virtual CPU devices;
* :class:`ShardedTensor` is a global shape, a spec (``"row"``: rows split
  over the mesh's first axis; ``"block"``: rows over "i" and columns over
  "j"; ``"replicated"``) and the per-shard tensors;
* :func:`sharded_gauss_kernel` builds block (i, j) of K with one launch of
  the dense kernel (``ops/kernels.gauss_tile``) on that shard's device;
* ``K @ B`` for a block-sharded K and a dense or row-sharded B is the
  block product: block (i, j) computes K_ij·B_j where it lies, and block
  row i is the sum of those partials in ascending j on shard (i, 0)'s
  device; the result is row-sharded;
* the N-row objects of a fit (X, Q, c, ŷ, the derivatives, the Krylov
  basis) stay row-sharded: :func:`rows_map` runs a function shard by
  shard, :func:`gram` reduces Σₛ AₛᵀBₛ, :func:`rows_reduce` any per-shard
  partial (a column sum, a min or max), and :func:`collect` fetches small
  per-shard results (TSQR's R factors). Only such k-vectors, k×k blocks
  and scalars cross shards.

Reductions are deterministic: the partials are combined in ascending
shard order, on every process the same way, so a mesh that spans
processes takes the same branches (the golden search's comparisons) on
each. The small results that every shard then uses (a Ritz ``eigh``, a
Cholesky factor, λ*) are computed on each process's first shard and,
across processes, broadcast from process 0 (:func:`replicate`).

A mesh may span processes (``parallel/distributed.py``): each process
then holds only its own shards, a shard another process needs travels by
point-to-point sends (:func:`fetch_rows`, :func:`fetch_region`), and a
gather (:meth:`ShardedTensor.full`) sums zero-filled buffers with
``all_reduce``.

Every whole-tensor gather goes through :meth:`ShardedTensor.full` or
:func:`host_gather`, and records its label and shape in every active
:func:`record_gathers` log; ``GATHER_ALLOWED`` names the ones a mesh fit
may make.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import progress

SPECS = ("row", "block", "replicated")

# the gathers a mesh fit may make of an N-row object, by label, with the
# reason; any other N-row gather, and any N×N gather, is a fault
GATHER_ALLOWED = {
    "host_gather": "the model's numpy fields (coefficients, fitted values, "
                   "derivatives), fetched once at the end, as the JAX "
                   "package's host_gather does",
    "acf: X": "neffective_acf reads X_std's O(N·P) rows whole; its N×N "
              "Gram accumulation stays blocked",
}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


# ---------------------------------------------------------------------------
# the gather log
# ---------------------------------------------------------------------------

class GatherLog:
    """The whole-tensor gathers made while it recorded: ``entries`` of
    ``(label, shape)``."""

    def __init__(self):
        self.entries = []

    @property
    def count(self) -> int:
        return len(self.entries)

    @property
    def elements(self) -> int:
        return int(sum(np.prod(s) for _, s in self.entries))

    def offending(self, n: int, allowed=GATHER_ALLOWED):
        """Entries that gather an N×N object, or an N-row object under a
        label not in ``allowed``."""
        return [(lab, s) for lab, s in self.entries
                if (len(s) == 2 and s[0] >= n and s[1] >= n)
                or (len(s) >= 1 and s[0] >= n and lab not in allowed)]

    def summary(self) -> dict:
        return {"count": self.count, "elements": self.elements,
                "entries": [[lab, list(s)] for lab, s in self.entries]}


_RECORDING = []


@contextlib.contextmanager
def record_gathers():
    """``with record_gathers() as log:`` collects every gather made inside
    the block into ``log`` (a :class:`GatherLog`)."""
    log = GatherLog()
    _RECORDING.append(log)
    try:
        yield log
    finally:
        _RECORDING.remove(log)


def _note_gather(label: str, shape) -> None:
    for log in _RECORDING:
        log.entries.append((label, tuple(int(d) for d in shape)))


def _caller_label() -> str:
    frame = sys._getframe(2)
    return f"{frame.f_globals.get('__name__', '?')}.{frame.f_code.co_name}"


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class Mesh:
    """Devices on named axes. ``devices`` is a numpy object array of
    ``torch.device``; ``processes`` (same shape) the rank that owns each
    entry, all this process's by default."""

    def __init__(self, devices, axis_names: Sequence[str],
                 processes=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if processes is None:
            processes = np.full(devices.shape, _rank(), dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(
            devices.shape)

    @property
    def shape(self):
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local(self, index) -> bool:
        """True where entry ``index`` (a flat index or a tuple) belongs to
        this process."""
        if isinstance(index, tuple):
            return int(self.processes[index]) == _rank()
        return int(self.processes.flat[index]) == _rank()

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard: where the port runs
        what XLA runs replicated."""
        for d, p in zip(self.devices.flat, self.processes.flat):
            if int(p) == _rank():
                return d
        raise ValueError("mesh holds no device of this process")

    @property
    def local_devices(self):
        """This process's devices of the mesh, each once, in mesh order."""
        return list(dict.fromkeys(
            d for d, p in zip(self.devices.flat, self.processes.flat)
            if int(p) == _rank()))

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def _default_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; pass devices= (for "
            "example [torch.device('cpu')] * 4 for virtual CPU shards)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ("i", "j") mesh. ``devices`` defaults to every visible CUDA
    device; entries may repeat (virtual shards). ``shape=None`` picks the
    most-square factorization of the device count, as the JAX package
    does."""
    devices = _default_devices() if devices is None else [
        torch.device(d) for d in devices]
    d = len(devices)
    if shape is None:
        a = int(np.floor(np.sqrt(d)))
        while d % a:
            a -= 1
        shape = (a, d // a)
    arr = np.empty(d, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names=("i", "j"))


def spans_processes(mesh: Mesh) -> bool:
    """True when the mesh holds devices of another process."""
    return bool(np.any(mesh.processes != _rank()))


def bounds(n: int, parts: int):
    """Row ranges of ``parts`` shards of ``n`` rows: the first ``n % parts``
    shards get one row more (``numpy.array_split``'s rule)."""
    base, extra = divmod(int(n), int(parts))
    out, lo = [], 0
    for s in range(parts):
        hi = lo + base + (1 if s < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _grid(mesh: Mesh):
    """(row shards, column shards) of the mesh's block layout; a 1-D mesh
    splits rows only."""
    shape = mesh.shape
    return shape[0], (shape[1] if len(shape) > 1 else 1)


def _entry(mesh: Mesh, i: int, j: int = 0):
    return (i, j) if mesh.devices.ndim > 1 else (i,)


def _device_of(mesh: Mesh, i: int, j: int = 0) -> torch.device:
    return mesh.devices[_entry(mesh, i, j)]


def _local(mesh: Mesh, i: int, j: int = 0) -> bool:
    return mesh.local(_entry(mesh, i, j))


def _owner(mesh: Mesh, i: int, j: int = 0) -> int:
    return int(mesh.processes[_entry(mesh, i, j)])


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------

class ShardedTensor:
    """A tensor laid out over a :class:`Mesh`.

    ``spec`` is ``"row"`` (``shards[i]`` holds rows ``row_bounds[i]``, on
    device (i, 0) of the mesh), ``"block"`` (``shards[i][j]`` holds rows
    ``row_bounds[i]`` and columns ``col_bounds[j]``, on device (i, j)) or
    ``"replicated"`` (``shards[0]``, on the first device). Shards of
    another process are ``None``; ``dtype`` is needed only where this
    process holds none."""

    def __init__(self, mesh: Mesh, spec: str, shape, shards, dtype=None):
        if spec not in SPECS:
            raise ValueError(f"spec must be one of {SPECS}, got {spec!r}")
        self.mesh = mesh
        self.spec = spec
        self.shape = torch.Size(shape)
        self.shards = shards
        a, b = _grid(mesh)
        self.row_bounds = bounds(self.shape[0], a)
        self.col_bounds = (bounds(self.shape[1], b) if spec == "block"
                           else None)
        local = self._local_shards()
        self._dtype = local[0].dtype if local else dtype

    def _local_shards(self):
        if self.spec == "block":
            return [t for row in self.shards for t in row if t is not None]
        return [t for t in self.shards if t is not None]

    # -- the shards by key: i (row spec) or (i, j) (block spec) --
    def keys(self):
        if self.spec == "block":
            return [(i, j) for i in range(len(self.row_bounds))
                    for j in range(len(self.col_bounds))]
        return list(range(len(self.row_bounds)))

    def shard(self, key):
        if self.spec == "block":
            return self.shards[key[0]][key[1]]
        return self.shards[key]

    def owner(self, key) -> int:
        return _owner(self.mesh, *(key if self.spec == "block" else (key,)))

    def key_bounds(self, key):
        """(r0, r1, c0, c1) of a shard; c0:c1 spans every column of a row
        shard."""
        if self.spec == "block":
            return (*self.row_bounds[key[0]], *self.col_bounds[key[1]])
        cols = self.shape[1] if len(self.shape) > 1 else 0
        return (*self.row_bounds[key], 0, cols)

    def key_shape(self, key):
        r0, r1, c0, c1 = self.key_bounds(key)
        if self.spec == "block":
            return (r1 - r0, c1 - c0)
        return (r1 - r0,) + tuple(self.shape[1:])

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def n_shards(self) -> int:
        """Distinct pieces of the tensor: row shards, blocks, or 1."""
        if self.spec == "block":
            return len(self.row_bounds) * len(self.col_bounds)
        return len(self.row_bounds) if self.spec == "row" else 1

    @property
    def shard_shape(self):
        if self.spec == "replicated":
            return tuple(self.shape)
        return self.key_shape(self.keys()[0])

    def full(self, device=None, label: Optional[str] = None):
        """The whole tensor on ``device`` (default the mesh's first), a
        gather recorded under ``label`` (default the caller's name). On a
        mesh that spans processes every process gets it."""
        device = self.mesh.first_device if device is None else device
        if self.spec == "replicated":
            return self.shards[0].to(device)
        _note_gather(label or _caller_label(), self.shape)
        if spans_processes(self.mesh):
            return _gather_across(self, device)
        if self.spec == "row":
            return torch.cat([t.to(device) for t in self.shards], dim=0)
        return torch.cat([torch.cat([t.to(device) for t in row], dim=1)
                          for row in self.shards], dim=0)

    def region(self, r0: int, r1: int, c0: int, c1: int, device=None):
        """Rows r0:r1 and columns c0:c1 of a block-sharded matrix, put
        together from the blocks that hold them. On a mesh that spans
        processes every process calls it with the same arguments and
        receives the blocks it lacks."""
        device = self.mesh.first_device if device is None else device
        ranks = sorted({int(p) for p in self.mesh.processes.flat})
        got = fetch_region(self, [(r, r0, r1, c0, c1) for r in ranks])
        return got[(r0, r1, c0, c1)].to(device)

    def __matmul__(self, B):
        return matmul(self, B)

    def __repr__(self):
        return (f"ShardedTensor({self.spec}, shape={tuple(self.shape)}, "
                f"shards={self.n_shards}, mesh={self.mesh})")


def _gather_across(x: ShardedTensor, device):
    """``full()`` on a mesh that spans processes: each process writes its
    shards into a zero buffer and ``all_reduce`` sums the buffers."""
    import torch.distributed as dist

    from .distributed import comm_device
    buf = torch.zeros(tuple(x.shape), dtype=x.dtype, device=comm_device())
    for key in x.keys():
        t = x.shard(key)
        if t is not None:
            r0, r1, c0, c1 = x.key_bounds(key)
            if x.spec == "block":
                buf[r0:r1, c0:c1] = t.to(buf.device)
            else:
                buf[r0:r1] = t.to(buf.device)
    dist.all_reduce(buf)
    return buf.to(device)


def place(arr, mesh: Mesh, spec: str) -> ShardedTensor:
    """Lay ``arr`` (a tensor every process holds whole, as the fit's inputs
    are) out over ``mesh``; each process keeps only its own shards. Row
    shards of a contiguous tensor on the shard's device are views, not
    copies."""
    if isinstance(arr, ShardedTensor):
        return commit(arr, mesh, spec)
    arr = torch.as_tensor(arr)
    a, b = _grid(mesh)
    if spec == "replicated":
        return ShardedTensor(mesh, spec, arr.shape,
                             [arr.to(mesh.first_device)])
    rb = bounds(arr.shape[0], a)
    if spec == "row":
        shards = [arr[r0:r1].to(_device_of(mesh, i)) if _local(mesh, i)
                  else None for i, (r0, r1) in enumerate(rb)]
        return ShardedTensor(mesh, spec, arr.shape, shards, arr.dtype)
    if spec != "block":
        raise ValueError(f"spec must be one of {SPECS}, got {spec!r}")
    cb = bounds(arr.shape[1], b)
    shards = [[arr[r0:r1, c0:c1].contiguous().to(_device_of(mesh, i, j))
               if _local(mesh, i, j) else None
               for j, (c0, c1) in enumerate(cb)]
              for i, (r0, r1) in enumerate(rb)]
    return ShardedTensor(mesh, spec, arr.shape, shards, arr.dtype)


def commit(arr, mesh: Mesh, spec: str) -> ShardedTensor:
    """Re-lay an existing tensor or sharded tensor out as ``spec``."""
    if isinstance(arr, ShardedTensor):
        if arr.mesh is mesh and arr.spec == spec:
            return arr
        arr = arr.full(label="commit")
    return place(arr, mesh, spec)


def dense(arr, label: Optional[str] = None):
    """``arr`` as one tensor: a sharded tensor gathered onto its mesh's
    first device (recorded under ``label``), anything else as it is."""
    if isinstance(arr, ShardedTensor):
        return arr.full(label=label or _caller_label())
    return arr


def host_gather(arr, label: str = "host_gather",
                dst: Optional[int] = None) -> Optional[np.ndarray]:
    """Fetch to host numpy (in the tensor's own dtype), shard by shard, so
    that no device holds a sharded tensor whole. Across processes every
    process receives it, or only process ``dst`` (the others get None):
    each shard travels from its owner on its own. Each copy to the host
    counts as one of the open span's ``host_reads``."""
    if not isinstance(arr, ShardedTensor):
        if isinstance(arr, torch.Tensor):
            progress.count("host_reads")
            return arr.detach().cpu().numpy()
        return np.asarray(arr)
    if arr.spec == "replicated":
        progress.count("host_reads")
        return arr.shards[0].detach().cpu().numpy()
    _note_gather(label, arr.shape)
    me, span = _rank(), spans_processes(arr.mesh)
    keep = dst is None or dst == me
    out = (np.empty(tuple(arr.shape),
                    dtype=torch.empty((), dtype=arr.dtype).numpy().dtype)
           if keep else None)
    for key in arr.keys():
        t, owner = arr.shard(key), arr.owner(key)
        if span:
            import torch.distributed as dist

            from .distributed import comm_device, exchange
            if dst is None:
                buf = (t.to(comm_device()).contiguous() if owner == me else
                       torch.empty(arr.key_shape(key), dtype=arr.dtype,
                                   device=comm_device()))
                dist.broadcast(buf, src=owner)
                t = buf
            elif owner != dst:
                if owner == me:
                    exchange([(t, dst)], [])
                    continue
                if dst == me:
                    t = torch.empty(arr.key_shape(key), dtype=arr.dtype,
                                    device=comm_device())
                    exchange([], [(t, owner)])
                else:
                    continue
        if keep:
            r0, r1, c0, c1 = arr.key_bounds(key)
            sl = ((slice(r0, r1), slice(c0, c1)) if arr.spec == "block"
                  else slice(r0, r1))
            progress.count("host_reads")
            out[sl] = t.detach().cpu().numpy()
    return out


@contextlib.contextmanager
def process_zero_writes(*xs):
    """``with process_zero_writes(*xs) as writer:`` — ``writer`` is True in
    process 0 (or the only one), which writes files inside the block; where
    any of ``xs`` is sharded over processes, every process waits at the
    end of the block until the write is done, so that none reads the files
    before they exist."""
    try:
        yield _rank() == 0
    finally:
        if any(isinstance(x, ShardedTensor) and spans_processes(x.mesh)
               for x in xs):
            import torch.distributed as dist
            dist.barrier()


# ---------------------------------------------------------------------------
# point-to-point fetches of shards, slabs and regions
# ---------------------------------------------------------------------------

def _unique(items):
    seen, out = set(), []
    for it in items:
        if it not in seen:
            seen.add(it)
            out.append(it)
    return out


def _exchange_shards(x: ShardedTensor, wanted):
    """The shards of ``x`` named in ``wanted``, a list of (rank, key) the
    same on every process: returns {key: tensor} for this process's
    entries, its own shards as they are, the others received from their
    owners."""
    me = _rank()
    got, sends, recvs = {}, [], []
    for dest, key in _unique(wanted):
        owner = x.owner(key)
        if dest == me and owner == me:
            got[key] = x.shard(key)
        elif dest == me:
            from .distributed import comm_device
            buf = torch.empty(x.key_shape(key), dtype=x.dtype,
                              device=comm_device())
            recvs.append((buf, owner))
            got[key] = buf
        elif owner == me:
            sends.append((x.shard(key), dest))
    if sends or recvs:
        from .distributed import exchange
        exchange(sends, recvs)
    return got


def _overlap(a0, a1, b0, b1):
    return max(a0, b0), min(a1, b1)


def fetch_rows(x: ShardedTensor, requests):
    """Row slabs of a row-sharded ``x``: ``requests`` is a list of
    (rank, r0, r1), the same on every process; returns {(r0, r1): tensor}
    for this process's requests, built from the shards that hold the rows
    (views where one local shard holds them all)."""
    wanted = []
    for dest, r0, r1 in requests:
        for i, (a0, a1) in enumerate(x.row_bounds):
            lo, hi = _overlap(a0, a1, r0, r1)
            if lo < hi:
                wanted.append((dest, i))
    got = _exchange_shards(x, wanted)
    me, out = _rank(), {}
    for dest, r0, r1 in _unique(requests):
        if dest != me:
            continue
        parts = []
        for i, (a0, a1) in enumerate(x.row_bounds):
            lo, hi = _overlap(a0, a1, r0, r1)
            if lo < hi:
                parts.append(got[i][lo - a0:hi - a0])
        out[(r0, r1)] = (parts[0] if len(parts) == 1 else
                         torch.cat([p.to(parts[0].device) for p in parts]))
    return out


def fetch_region(x: ShardedTensor, requests):
    """Regions of a block-sharded ``x``: ``requests`` is a list of
    (rank, r0, r1, c0, c1), the same on every process; returns
    {(r0, r1, c0, c1): tensor} for this process's requests."""
    def blocks(r0, r1, c0, c1):
        return [(i, j) for i, (a0, a1) in enumerate(x.row_bounds)
                for j, (b0, b1) in enumerate(x.col_bounds)
                if _overlap(a0, a1, r0, r1)[0] < _overlap(a0, a1, r0, r1)[1]
                and _overlap(b0, b1, c0, c1)[0] < _overlap(b0, b1, c0, c1)[1]]

    wanted = [(req[0], key) for req in requests for key in blocks(*req[1:])]
    got = _exchange_shards(x, wanted)
    me, out = _rank(), {}
    for dest, r0, r1, c0, c1 in _unique(requests):
        if dest != me:
            continue
        rows = []
        for i, (a0, a1) in enumerate(x.row_bounds):
            lo, hi = _overlap(a0, a1, r0, r1)
            if lo >= hi:
                continue
            cols = []
            for j, (b0, b1) in enumerate(x.col_bounds):
                clo, chi = _overlap(b0, b1, c0, c1)
                if clo < chi:
                    cols.append(got[(i, j)][lo - a0:hi - a0,
                                            clo - b0:chi - b0])
            rows.append(cols[0] if len(cols) == 1 else
                        torch.cat([c.to(cols[0].device) for c in cols], 1))
        out[(r0, r1, c0, c1)] = (rows[0] if len(rows) == 1 else torch.cat(
            [r.to(rows[0].device) for r in rows], 0))
    return out


# ---------------------------------------------------------------------------
# row-sharded operations: maps, deterministic reductions, collects
# ---------------------------------------------------------------------------

def _is_rows(x) -> bool:
    return isinstance(x, ShardedTensor) and x.spec == "row"


def _rows_ref(args):
    ref = None
    for a in args:
        if _is_rows(a):
            if ref is None:
                ref = a
            elif a.row_bounds != ref.row_bounds or a.mesh is not ref.mesh:
                raise ValueError(f"row-sharded operands of different "
                                 f"layouts: {ref} and {a}")
    return ref


def _shard_args(args, i, device, meta: bool = False):
    out = []
    for a in args:
        if _is_rows(a):
            out.append(torch.empty(a.key_shape(i), dtype=a.dtype,
                                   device="meta") if meta else a.shards[i])
        elif isinstance(a, torch.Tensor):
            out.append(a.to("meta") if meta else a.to(device))
        else:
            out.append(a)
    return out


def _eval(fn, args, ref, i):
    """fn on shard i's operands: the real ones where this process holds
    the shard, meta tensors (shapes only) where it does not."""
    if ref.shards[i] is not None:
        return fn(*_shard_args(args, i, ref.shards[i].device))
    return None


def _meta(fn, args, i):
    return fn(*_shard_args(args, i, None, meta=True))


def rows_map(fn, *args):
    """``fn`` applied shard by shard: row-sharded arguments (one layout)
    give their shard, other tensors are moved to the shard's device,
    anything else is passed as it is. ``fn`` returns a row-aligned tensor,
    or a tuple of them; the result is row-sharded like the arguments.
    With no row-sharded argument, ``fn(*args)``."""
    ref = _rows_ref(args)
    if ref is None:
        return fn(*args)
    outs = [_eval(fn, args, ref, i) for i in range(len(ref.row_bounds))]
    proto = next((o for o in outs if o is not None), None)
    if proto is None:
        proto = _meta(fn, args, 0)
    n = ref.shape[0]

    def wrap(k):
        p = proto[k] if k is not None else proto
        shards = [None if o is None else (o[k] if k is not None else o)
                  for o in outs]
        return ShardedTensor(ref.mesh, "row", (n,) + tuple(p.shape[1:]),
                             shards, p.dtype)

    if isinstance(proto, tuple):
        return tuple(wrap(k) for k in range(len(proto)))
    return wrap(None)


def _partials(fn, args, ref):
    parts = [_eval(fn, args, ref, i) for i in range(len(ref.row_bounds))]
    shapes, dtype = [], None
    for i, p in enumerate(parts):
        q = p if p is not None else _meta(fn, args, i)
        shapes.append(tuple(q.shape))
        dtype = q.dtype
    return parts, shapes, dtype


def _all_partials(x, parts, shapes, dtype):
    """Every shard's partial (``parts`` in ``x.keys()`` order, None where
    another process holds the shard) on this process's first device:
    local ones moved there, and across processes the owners' copies."""
    device = x.mesh.first_device
    if not spans_processes(x.mesh):
        return [p.to(device) for p in parts]
    from .distributed import all_partials
    return all_partials(parts, [x.owner(k) for k in x.keys()], shapes,
                        dtype, device)


_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _fold(parts, op: str = "sum"):
    """The partials combined by ``op`` in their order."""
    total = parts[0]
    for p in parts[1:]:
        total = _COMBINE[op](total, p)
    return total


def rows_reduce(fn, *args, op: str = "sum", label: Optional[str] = None):
    """``fn``'s per-shard partials combined by ``op`` ("sum", "max",
    "min") in ascending shard order, on the mesh's first device; the same
    bits on every process. With no row-sharded argument, ``fn(*args)``
    (the single-device arithmetic, unchanged). A result with a dimension
    of N or more is recorded as a gather under ``label``."""
    ref = _rows_ref(args)
    if ref is None:
        return fn(*args)
    parts, shapes, dtype = _partials(fn, args, ref)
    total = _fold(_all_partials(ref, parts, shapes, dtype), op)
    if total.dim() and max(total.shape) >= ref.shape[0]:
        _note_gather(label or _caller_label(), total.shape)
    return total


def gram(A, B, label: Optional[str] = None):
    """AᵀB for (N, a) and (N, b) (or (N,)) operands: Σₛ AₛᵀBₛ over row
    shards, deterministic; ``A.T @ B`` for plain tensors."""
    return rows_reduce(lambda a, b: (a.T if a.dim() > 1 else a) @ b, A, B,
                       label=label or _caller_label())


def collect(x: ShardedTensor, parts, shapes, label: Optional[str] = None):
    """Per-shard results of a row-sharded ``x``'s shards (``parts[i]``,
    None where another process holds shard i, of shape ``shapes[i]``),
    every shard's, on the mesh's first device of every process, in shard
    order: TSQR's R factors. Results of N rows or more in all are
    recorded as a gather under ``label``."""
    if sum(s[0] for s in shapes) >= x.shape[0]:
        _note_gather(label or _caller_label(),
                     (sum(s[0] for s in shapes),) + tuple(shapes[0][1:]))
    return _all_partials(x, parts, shapes, x.dtype)


def replicate(mesh: Optional[Mesh], *tensors):
    """``tensors`` as process 0 computed them, where ``mesh`` spans
    processes (the small results every shard uses); as they are
    otherwise. Returns a tuple."""
    if mesh is None or not spans_processes(mesh):
        return tensors
    from .distributed import broadcast_from_zero
    return tuple(broadcast_from_zero(tensors))


def mesh_of(*xs) -> Optional[Mesh]:
    """The mesh of the first sharded tensor among ``xs``, else None."""
    for x in xs:
        if isinstance(x, ShardedTensor):
            return x.mesh
    return None


# ---------------------------------------------------------------------------
# products with a block-sharded K
# ---------------------------------------------------------------------------

def matmul(K: ShardedTensor, B):
    """``K @ B`` for a block-sharded K and a dense or row-sharded B (a
    row-sharded K takes a dense B); the result is row-sharded like K's
    rows. Block (i, j) computes K_ij·B[cols j] on its device, with the
    rows of a sharded B fetched from the shards that hold them; block row
    i sums its partials in ascending j on shard (i, 0)'s device."""
    if isinstance(B, ShardedTensor):
        vec = len(B.shape) == 1
        if vec:
            B = rows_map(lambda t: t[:, None], B)
    else:
        vec = B.dim() == 1
        if vec:
            B = B[:, None]
    mesh = K.mesh
    m = B.shape[1]
    if K.spec == "row":
        if isinstance(B, ShardedTensor):
            raise ValueError("a row-sharded K takes a dense B")
        shards = [None if t is None else t @ B.to(t.device)
                  for t in K.shards]
        Y = ShardedTensor(mesh, "row", (K.shape[0], m), shards, K.dtype)
    else:
        if isinstance(B, ShardedTensor):
            slabs = fetch_rows(B, [(K.owner(key), *K.col_bounds[key[1]])
                                   for key in K.keys()])
        else:
            slabs = {cb: B[cb[0]:cb[1]] for cb in K.col_bounds}
        parts = {}
        for key in K.keys():
            blk = K.shard(key)
            if blk is not None:
                parts[key] = blk @ slabs[K.col_bounds[key[1]]].to(blk.device)
        a, b = len(K.row_bounds), len(K.col_bounds)
        P = ShardedTensor(mesh, "block", (K.shape[0], m * b),
                          [[parts.get((i, j)) for j in range(b)]
                           for i in range(a)], K.dtype)
        got = _exchange_shards(P, [(_owner(mesh, i), (i, j))
                                   for i, j in K.keys()])
        shards = []
        for i in range(len(K.row_bounds)):
            if not _local(mesh, i):
                shards.append(None)
                continue
            dev = _device_of(mesh, i)
            y = None
            for j in range(len(K.col_bounds)):
                part = got[(i, j)].to(dev)
                y = part if y is None else y + part
            shards.append(y)
        Y = ShardedTensor(mesh, "row", (K.shape[0], m), shards, K.dtype)
    return rows_map(lambda t: t[:, 0], Y) if vec else Y


def map_blocks(A: ShardedTensor, fn) -> ShardedTensor:
    """A block-sharded matrix whose block (i, j) is ``fn(i, j, block,
    (r0, r1), (c0, c1))``, computed where the block lies."""
    shards = [[None if A.shards[i][j] is None else
               fn(i, j, A.shards[i][j], A.row_bounds[i], A.col_bounds[j])
               for j in range(len(A.col_bounds))]
              for i in range(len(A.row_bounds))]
    return ShardedTensor(A.mesh, "block", A.shape, shards, A.dtype)


def block_product(A: ShardedTensor, B: ShardedTensor) -> ShardedTensor:
    """A·B for two block-sharded N×N matrices on one mesh: block (i, j) is
    Σ_k A_ik·B[cols_k, cols_j], summed in ascending k on shard (i, j).
    Each block's owner fetches the blocks of its block row of A, and,
    column stripe by column stripe, the regions of B it lacks
    (point-to-point), so no process holds more than its block rows of A
    and one stripe of B. A block's device holds, beside what it holds
    already, its accumulator, one partial and the two operands of that
    partial (copies where they lie on another device)."""
    shards = [[None] * len(A.col_bounds) for _ in A.row_bounds]
    arows = fetch_region(A, [(A.owner(key), *A.row_bounds[key[0]], k0, k1)
                             for key in A.keys() for k0, k1 in A.col_bounds])
    for j, (c0, c1) in enumerate(A.col_bounds):
        reqs = [(A.owner((i, j)), k0, k1, c0, c1)
                for i in range(len(A.row_bounds))
                for k0, k1 in A.col_bounds]
        regions = fetch_region(B, reqs)
        for i in range(len(A.row_bounds)):
            if not _local(A.mesh, i, j):
                continue
            dev = _device_of(A.mesh, i, j)
            out = None
            for k0, k1 in A.col_bounds:
                a = arows[(*A.row_bounds[i], k0, k1)].to(dev)
                b = regions[(k0, k1, c0, c1)].to(dev)
                part = a @ b
                del a, b
                out = part if out is None else out.add_(part)
                del part
            shards[i][j] = out
        del regions
    return ShardedTensor(A.mesh, "block", A.shape, shards, A.dtype)


def _reduce_blocks(A: ShardedTensor, partials: dict):
    """Σ over blocks, in (i, j) order, of per-block scalars (None where
    the block is another process's); the same bits on every process."""
    keys = A.keys()
    return _fold(_all_partials(A, [partials.get(k) for k in keys],
                               [()] * len(keys), A.dtype))


def trace(A: ShardedTensor):
    """tr(A) of a block-sharded square matrix, summed block by block."""
    partials = {}
    for key in A.keys():
        blk = A.shard(key)
        if blk is None:
            continue
        r0, r1, c0, c1 = A.key_bounds(key)
        lo, hi = _overlap(r0, r1, c0, c1)
        if lo < hi:
            idx = torch.arange(lo, hi, device=blk.device)
            partials[key] = blk[idx - r0, idx - c0].sum()
        else:
            partials[key] = blk.new_zeros(())
    return _reduce_blocks(A, partials)


def inner(A: ShardedTensor, B: ShardedTensor):
    """Σ A∘B (the Frobenius inner product) of two block-sharded matrices
    of one layout, summed block by block."""
    return _reduce_blocks(A, {key: torch.sum(A.shard(key) * B.shard(key))
                              for key in A.keys()
                              if A.shard(key) is not None})


def shard_fit_arrays(mesh: Mesh, X_std, y_std):
    """The standardized inputs of a sharded fit: X and y row-sharded over
    "i" (the rows of the kernel and the eigenvectors live with their
    device row)."""
    return place(X_std, mesh, "row"), place(y_std, mesh, "row")


def _fill_diagonal_overlap(tile, r0: int, r1: int, c0: int, c1: int):
    """Set to exactly 1 the entries of a block that lie on K's diagonal."""
    lo, hi = max(r0, c0), min(r1, c1)
    if lo < hi:
        idx = torch.arange(lo, hi, device=tile.device)
        tile[idx - r0, idx - c0] = 1.0
    return tile


@functools.lru_cache(maxsize=8)
def sharded_gauss_kernel(mesh: Mesh, impl: str = "auto"):
    """A function ``build(X_std, sigma)`` of the Gaussian kernel whose N×N
    output is block-sharded over ("i", "j"); X a tensor or row-sharded
    (each block's owner then fetches the row slabs it lacks).

    Block (i, j) is one launch of the dense kernel,
    ``gauss_tile(X_i, X_j, sigma, symmetric_diag=(i == j))``, on shard
    (i, j)'s device (its plain version for CPU tensors, float64, or
    ``impl="plain"``). A diagonal block whose rows and columns are the same
    range takes the kernel's symmetric mode, which writes the exact-1
    diagonal of the single-device K; on a mesh whose row and column splits
    differ, the entries a block holds of K's diagonal are set to 1 after
    the launch."""
    from ..ops.kernels import _use_tile, gauss_tile, gauss_tile_plain

    def build(X_std, sigma):
        n = X_std.shape[0]
        a, b = _grid(mesh)
        rb, cb = bounds(n, a), bounds(n, b)
        keys = [(i, j) for i in range(a) for j in range(b)]
        if isinstance(X_std, ShardedTensor):
            slabs = fetch_rows(X_std, [(_owner(mesh, i, j), *rng)
                                       for i, j in keys
                                       for rng in (rb[i], cb[j])])
        else:
            slabs = {r: X_std[r[0]:r[1]] for r in set(rb) | set(cb)}
        probe = next(iter(slabs.values()), None)
        use = probe is not None and _use_tile(probe, impl)
        tile = gauss_tile if use else gauss_tile_plain
        shards = [[None] * b for _ in range(a)]
        for i, j in keys:
            if not _local(mesh, i, j):
                continue
            (r0, r1), (c0, c1) = rb[i], cb[j]
            dev = _device_of(mesh, i, j)
            Xi = slabs[(r0, r1)].to(dev)
            if (r0, r1) == (c0, c1):
                shards[i][j] = tile(Xi, Xi, float(sigma), True)
            else:
                shards[i][j] = _fill_diagonal_overlap(
                    tile(Xi, slabs[(c0, c1)].to(dev), float(sigma), False),
                    r0, r1, c0, c1)
        return ShardedTensor(mesh, "block", (n, n), shards, X_std.dtype)

    return build


def shard_info(arr, mesh: Optional[Mesh] = None) -> Optional[dict]:
    """Placement summary of one array for ``KRLSModel.sharding_report``:
    the JAX keys, with ``devices`` the number of distinct shards. A plain
    tensor of a mesh fit (``mesh`` given) is reported as it lay: whole, on
    one device, replicated."""
    if not isinstance(arr, ShardedTensor):
        if mesh is None or arr is None:
            return None
        return {"shape": tuple(arr.shape), "shard_shape": tuple(arr.shape),
                "devices": 1, "replicated": True}
    return {
        "shape": tuple(arr.shape),
        "shard_shape": tuple(arr.shard_shape),
        "devices": arr.n_shards,
        "replicated": arr.spec == "replicated",
    }
