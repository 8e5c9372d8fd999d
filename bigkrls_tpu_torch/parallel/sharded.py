"""Multi-device sharding for the KRLS fit, ported from
``bigkrls_tpu/parallel/sharded.py``.

The JAX design is GSPMD: a 2-D ``Mesh`` of devices on axes ("i", "j"),
``NamedSharding`` layouts on the arrays, and XLA partitions the products.
PyTorch has no such compiler, so the port keeps the JAX package's
single-controller shape, one Python process driving every shard of the
mesh, and makes the partitioned products explicit:

* :class:`Mesh` holds a numpy object array of ``torch.device`` with axis
  names. Devices may repeat: a mesh of 4 shards over ``cuda:0`` (or over
  ``cpu``) runs the multi-device logic on one device, the way the JAX
  suite runs it on virtual CPU devices;
* :class:`ShardedTensor` is a global shape, a spec (``"row"``: rows split
  over the mesh's first axis; ``"block"``: rows over "i" and columns over
  "j"; ``"replicated"``) and the per-shard tensors;
* :func:`sharded_gauss_kernel` builds block (i, j) of K with one launch of
  the dense kernel (``ops/kernels.gauss_tile``) on that shard's device;
* ``K @ B`` for a block-sharded K is the block product: block row i is
  Σ_j K_ij·B_j, summed in ascending j on shard (i, 0)'s device, and comes
  back row-sharded.

Where XLA runs an operation replicated (a full ``eigh``, the small QR and
``eigh`` of a Ritz step, the golden search), the port runs it on the
mesh's first shard on gathered operands (:meth:`ShardedTensor.full`).

A mesh may span processes (``parallel/distributed.py``): each process
then holds only its own shards, and a gather sums zero-filled buffers
with ``all_reduce`` (exact: every element has one nonzero contribution).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

SPECS = ("row", "block", "replicated")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


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


def _device_of(mesh: Mesh, i: int, j: int = 0) -> torch.device:
    return mesh.devices[(i, j) if mesh.devices.ndim > 1 else i]


def _local(mesh: Mesh, i: int, j: int = 0) -> bool:
    return mesh.local((i, j) if mesh.devices.ndim > 1 else (i,))


class ShardedTensor:
    """A tensor laid out over a :class:`Mesh`.

    ``spec`` is ``"row"`` (``shards[i]`` holds rows ``row_bounds[i]``, on
    device (i, 0) of the mesh), ``"block"`` (``shards[i][j]`` holds rows
    ``row_bounds[i]`` and columns ``col_bounds[j]``, on device (i, j)) or
    ``"replicated"`` (``shards[0]``, on the first device). Shards of
    another process are ``None``."""

    def __init__(self, mesh: Mesh, spec: str, shape, shards):
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

    def _local_shards(self):
        if self.spec == "block":
            return [t for row in self.shards for t in row if t is not None]
        return [t for t in self.shards if t is not None]

    @property
    def dtype(self):
        return self._local_shards()[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    def element_size(self) -> int:
        return self._local_shards()[0].element_size()

    @property
    def n_shards(self) -> int:
        """Distinct pieces of the tensor: row shards, blocks, or 1."""
        if self.spec == "block":
            return len(self.row_bounds) * len(self.col_bounds)
        return len(self.row_bounds) if self.spec == "row" else 1

    @property
    def shard_shape(self):
        t = self._local_shards()[0]
        return tuple(t.shape)

    def full(self, device=None):
        """The whole tensor on ``device`` (default the mesh's first). On a
        mesh that spans processes every process gets it."""
        device = self.mesh.first_device if device is None else device
        if self.spec == "replicated":
            return self.shards[0].to(device)
        if spans_processes(self.mesh):
            return _gather_across(self, device)
        if self.spec == "row":
            return torch.cat([t.to(device) for t in self.shards], dim=0)
        return torch.cat([torch.cat([t.to(device) for t in row], dim=1)
                          for row in self.shards], dim=0)

    def region(self, r0: int, r1: int, c0: int, c1: int, device=None):
        """Rows r0:r1 and columns c0:c1 of a block-sharded matrix, put
        together from the blocks that hold them."""
        device = self.mesh.first_device if device is None else device
        if self.spec != "block" or spans_processes(self.mesh):
            return self.full(device)[r0:r1, c0:c1]
        rows = []
        for i, (a0, a1) in enumerate(self.row_bounds):
            lo, hi = max(a0, r0), min(a1, r1)
            if lo >= hi:
                continue
            cols = []
            for j, (b0, b1) in enumerate(self.col_bounds):
                clo, chi = max(b0, c0), min(b1, c1)
                if clo < chi:
                    cols.append(self.shards[i][j][lo - a0:hi - a0,
                                                  clo - b0:chi - b0]
                                .to(device))
            rows.append(torch.cat(cols, dim=1))
        return torch.cat(rows, dim=0)

    def __matmul__(self, B):
        return matmul(self, B)

    def __repr__(self):
        return (f"ShardedTensor({self.spec}, shape={tuple(self.shape)}, "
                f"shards={self.n_shards}, mesh={self.mesh})")


def _gather_across(x: ShardedTensor, device):
    """``full()`` on a mesh that spans processes: each process writes its
    shards into a zero buffer and ``all_reduce`` sums the buffers."""
    import torch.distributed as dist
    dtype = x.dtype
    buf = torch.zeros(tuple(x.shape), dtype=dtype, device=_comm_device())
    if x.spec == "row":
        for i, (r0, r1) in enumerate(x.row_bounds):
            if x.shards[i] is not None:
                buf[r0:r1] = x.shards[i].to(buf.device)
    else:
        for i, (r0, r1) in enumerate(x.row_bounds):
            for j, (c0, c1) in enumerate(x.col_bounds):
                if x.shards[i][j] is not None:
                    buf[r0:r1, c0:c1] = x.shards[i][j].to(buf.device)
    dist.all_reduce(buf)
    return buf.to(device)


def _comm_device() -> torch.device:
    """The device the process group's collectives take: the current CUDA
    device under NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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
        return ShardedTensor(mesh, spec, arr.shape, shards)
    if spec != "block":
        raise ValueError(f"spec must be one of {SPECS}, got {spec!r}")
    cb = bounds(arr.shape[1], b)
    shards = [[arr[r0:r1, c0:c1].contiguous().to(_device_of(mesh, i, j))
               if _local(mesh, i, j) else None
               for j, (c0, c1) in enumerate(cb)]
              for i, (r0, r1) in enumerate(rb)]
    return ShardedTensor(mesh, spec, arr.shape, shards)


def commit(arr, mesh: Mesh, spec: str) -> ShardedTensor:
    """Re-lay an existing tensor or sharded tensor out as ``spec``."""
    if isinstance(arr, ShardedTensor):
        if arr.mesh is mesh and arr.spec == spec:
            return arr
        arr = arr.full()
    return place(arr, mesh, spec)


def dense(arr):
    """``arr`` as one tensor: a sharded tensor gathered onto its mesh's
    first device, anything else as it is."""
    return arr.full() if isinstance(arr, ShardedTensor) else arr


def host_gather(arr) -> np.ndarray:
    """Fetch to host numpy, gathering across processes where the tensor's
    mesh spans them (coefficients, derivatives and fitted values of a
    multi-process fit)."""
    t = dense(arr)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def matmul(K: ShardedTensor, B):
    """``K @ B`` for a row- or block-sharded K and a dense (or sharded) B;
    the result is row-sharded like K's rows. A block row's partial
    products are summed in ascending j on shard (i, 0)'s device."""
    vec = False
    if isinstance(B, ShardedTensor):
        B = B.full()
    if B.dim() == 1:
        B, vec = B[:, None], True
    mesh = K.mesh
    out_shape = (K.shape[0],) + (() if vec else (B.shape[1],))
    shards = []
    for i in range(len(K.row_bounds)):
        if K.spec == "row":
            if K.shards[i] is None:
                shards.append(None)
                continue
            y = K.shards[i] @ B.to(K.shards[i].device)
        else:
            if not _local(mesh, i):
                shards.append(None)
                continue
            dev = _device_of(mesh, i)
            y = None
            for j, (c0, c1) in enumerate(K.col_bounds):
                blk = K.shards[i][j]
                part = (blk @ B[c0:c1].to(blk.device)).to(dev)
                y = part if y is None else y + part
        shards.append(y[:, 0] if vec else y)
    return ShardedTensor(mesh, "row", out_shape, shards)


def matmul_dense(K, B):
    """``K @ B`` as one tensor, for a plain or sharded K: the consumers of
    the dense route (``ops/eig``, ``ops/adaptive``, ``ops/effects``) take
    either."""
    if isinstance(K, ShardedTensor):
        return matmul(K, B).full()
    return K @ B


def map_blocks(A: ShardedTensor, fn) -> ShardedTensor:
    """A block-sharded matrix whose block (i, j) is ``fn(i, j, block,
    (r0, r1), (c0, c1))``, computed where the block lies."""
    shards = [[None if A.shards[i][j] is None else
               fn(i, j, A.shards[i][j], A.row_bounds[i], A.col_bounds[j])
               for j in range(len(A.col_bounds))]
              for i in range(len(A.row_bounds))]
    return ShardedTensor(A.mesh, "block", A.shape, shards)


def block_product(A: ShardedTensor, B: ShardedTensor) -> ShardedTensor:
    """A·B for two block-sharded N×N matrices on one mesh: block (i, j) is
    Σ_k A_ik·B[cols_k, cols_j], summed in ascending k on shard (i, j)."""
    def blk(i, j, _, rows, cols):
        out = None
        for k, (k0, k1) in enumerate(A.col_bounds):
            a = A.shards[i][k].to(_device_of(A.mesh, i, j))
            part = a @ B.region(k0, k1, cols[0], cols[1], device=a.device)
            out = part if out is None else out + part
        return out
    return map_blocks(A, blk)


def trace(A: ShardedTensor):
    """tr(A) of a block-sharded square matrix, summed block by block."""
    total = None
    for i, (r0, r1) in enumerate(A.row_bounds):
        for j, (c0, c1) in enumerate(A.col_bounds):
            lo, hi = max(r0, c0), min(r1, c1)
            if lo < hi and A.shards[i][j] is not None:
                idx = torch.arange(lo, hi, device=A.shards[i][j].device)
                t = A.shards[i][j][idx - r0, idx - c0].sum().to(
                    A.mesh.first_device)
                total = t if total is None else total + t
    return total


def inner(A: ShardedTensor, B: ShardedTensor):
    """Σ A∘B (the Frobenius inner product) of two block-sharded matrices
    of one layout, summed block by block."""
    total = None
    for i in range(len(A.row_bounds)):
        for j in range(len(A.col_bounds)):
            if A.shards[i][j] is not None:
                t = torch.sum(A.shards[i][j] * B.shards[i][j]).to(
                    A.mesh.first_device)
                total = t if total is None else total + t
    return total


def shard_fit_arrays(mesh: Mesh, X_std, y_std):
    """The standardized inputs of a sharded fit: X row-sharded over "i"
    (the rows of the kernel and the eigenvectors live with their device
    row), y replicated."""
    return place(X_std, mesh, "row"), place(y_std, mesh, "replicated")


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
    output is block-sharded over ("i", "j"); X a tensor or row-sharded.

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
        X = dense(X_std)
        tile = gauss_tile if _use_tile(X, impl) else gauss_tile_plain
        n = X.shape[0]
        a, b = _grid(mesh)
        rb, cb = bounds(n, a), bounds(n, b)
        shards = []
        for i, (r0, r1) in enumerate(rb):
            row = []
            for j, (c0, c1) in enumerate(cb):
                if not _local(mesh, i, j):
                    row.append(None)
                    continue
                dev = _device_of(mesh, i, j)
                Xi = X[r0:r1].to(dev)
                if (r0, r1) == (c0, c1):
                    blk = tile(Xi, Xi, float(sigma), True)
                else:
                    blk = _fill_diagonal_overlap(
                        tile(Xi, X[c0:c1].to(dev), float(sigma), False),
                        r0, r1, c0, c1)
                row.append(blk)
            shards.append(row)
        return ShardedTensor(mesh, "block", (n, n), shards)

    return build


def shard_info(arr) -> Optional[dict]:
    """Placement summary of one array for ``KRLSModel.sharding_report``:
    the JAX keys, with ``devices`` the number of distinct shards."""
    if not isinstance(arr, ShardedTensor):
        return None
    return {
        "shape": tuple(arr.shape),
        "shard_shape": arr.shard_shape,
        "devices": arr.n_shards,
        "replicated": arr.spec == "replicated",
    }
