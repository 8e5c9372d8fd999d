"""Per-phase wall-clock timing (``PhaseTimer.mark``) and the fit's
profiler trace (``trace``), ported from ``bigkrls_tpu/utils/progress.py``.

PyTorch returns from a CUDA call before the card has run it, so a host
clock read without a synchronize books queued work to whichever phase
happens to wait for it next. ``PhaseTimer.mark`` therefore synchronizes
the fit's CUDA devices (every card of a mesh, each once) before reading
the clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Union

import torch


class PhaseTimer:
    """``device`` is the fit's device, or the devices of its mesh (they may
    repeat: virtual shards); ``mark`` synchronizes each distinct CUDA
    device among them."""

    def __init__(self, device: Union[None, torch.device, str,
                                     Sequence] = None):
        if device is None:
            device = []
        elif isinstance(device, (torch.device, str)):
            device = [device]
        cuda = [torch.device(d) for d in device
                if torch.device(d).type == "cuda"]
        self.devices = list(dict.fromkeys(cuda))
        self.phases: List[Dict] = []
        self._last = time.perf_counter()

    def _sync(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)

    def mark(self, name: str) -> None:
        """Record the time since the previous mark (or construction) as
        one phase, after the device has finished the phase's work."""
        self._sync()
        now = time.perf_counter()
        self.phases.append({"phase": name,
                            "seconds": round(now - self._last, 4)})
        self._last = now


@contextlib.contextmanager
def trace(logdir: Optional[str], device=None):
    """Run the region under ``torch.profiler`` and write a TensorBoard /
    Chrome trace (``*.pt.trace.json``) into ``logdir``: host activity,
    plus the device's kernels when ``device`` is a CUDA device. The
    counterpart of the JAX package's ``xla_trace``; no-op without
    ``logdir``."""
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
