"""Device-memory lookup for the sizing rules that plan against it.

Port of ``bigkrls_tpu/utils/memory.py``. A CUDA device reports its total
memory through ``torch.cuda.mem_get_info``; the CPU has no such figure, so
a fixed default stands in for it.
"""
from __future__ import annotations

import torch

DEFAULT_BUDGET = 8 * 1024 ** 3


def device_memory_budget(device=None, default: int = DEFAULT_BUDGET) -> int:
    """Bytes of memory to plan against on ``device``: a CUDA device's
    total memory, ``default`` for the CPU (or no device)."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return default
