"""Per-phase wall-clock timing (``PhaseTimer.mark``), ported from
``bigkrls_tpu/utils/progress.py``.

PyTorch returns from a CUDA call before the card has run it, so a host
clock read without a synchronize books queued work to whichever phase
happens to wait for it next. ``PhaseTimer.mark`` therefore synchronizes
the fit's CUDA device before reading the clock.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


class PhaseTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.phases: List[Dict] = []
        self._last = time.perf_counter()

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str) -> None:
        """Record the time since the previous mark (or construction) as
        one phase, after the device has finished the phase's work."""
        self._sync()
        now = time.perf_counter()
        self.phases.append({"phase": name,
                            "seconds": round(now - self._last, 4)})
        self._last = now
