"""Shared pieces of the benchmark's own tests (``python -m pytest
krlsbench/tests``; the ``cuda``-marked ones run on a card and skip
elsewhere)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_cell(workload: str, **config):
    """A cell of BENCHMARK.json at a size the CPU runs in seconds."""
    from krlsbench import spec
    cell = spec.cell(spec.load_benchmark(ROOT), workload, ROOT)
    cell.config = dict(cell.config, **config)
    fit = dict(cell.config["fit"], dtype="float64")
    if "neig" in fit:
        fit.update(neig=60, streaming=True)
    cell.config["fit"] = fit
    cell.traffic = dict(cell.traffic, check=3, trace_seconds=0.3)
    return cell
