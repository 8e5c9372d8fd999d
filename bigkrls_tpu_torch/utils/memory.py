"""Device-memory lookup for the sizing rules that plan against it, and a
count of the large blocks a computation holds at once.

Port of ``bigkrls_tpu/utils/memory.py``. A CUDA device reports its total
memory through ``torch.cuda.mem_get_info``; the CPU has no such figure, so
a fixed default stands in for it. :class:`LiveBlocks` has no JAX
counterpart: it counts what a mesh fit holds per device.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

DEFAULT_BUDGET = 8 * 1024 ** 3


def device_memory_budget(device=None, default: int = DEFAULT_BUDGET) -> int:
    """Bytes of memory to plan against on ``device``: a CUDA device's
    total memory, ``default`` for the CPU (or no device)."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return default


class LiveBlocks(TorchDispatchMode):
    """``with LiveBlocks(nbytes) as live:`` counts, after every operation
    inside the block, the storages of exactly ``nbytes`` bytes that live
    tensors made inside it hold, per device (a view counts once, with its
    storage); ``live.peak_by_device`` is the most held at once on each
    device, ``live.peak`` the most on any one. Sized to one block of a
    block-sharded N×N matrix, it is the number of such blocks a card holds
    at the fit's peak. Tensors made before the block are not seen."""

    def __init__(self, nbytes: int):
        super().__init__()
        self.nbytes = int(nbytes)
        self._refs = []
        self.peak_by_device = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().nbytes() == self.nbytes):
                self._refs.append(weakref.ref(t))
        self._count()
        return out

    def _count(self) -> None:
        held = collections.defaultdict(set)
        alive = []
        for ref in self._refs:
            t = ref()
            if t is not None:
                alive.append(ref)
                held[str(t.device)].add(t.untyped_storage().data_ptr())
        self._refs = alive
        for dev, ptrs in held.items():
            self.peak_by_device[dev] = max(self.peak_by_device[dev],
                                           len(ptrs))

    @property
    def peak(self) -> int:
        return max(self.peak_by_device.values(), default=0)
