"""The controls come out not correct under the configuration's limits,
at the cell's own size, while the program at the configuration's own
precision passes: the program's own lower-precision path
(``precision="high"``: TF32 on cuBLAS products and K2's one-pass mode),
and the reference itself in float32 with TF32 products (for the numbers
that path leaves untouched). On a card only (TF32 exists nowhere else):
``python -m pytest krlsbench/tests -m cuda``."""
from __future__ import annotations

from pathlib import Path

import pytest

from krlsbench import calibrate, check, spec
from krlsbench.tests.conftest import ROOT


def _limits_pass(cell, nums) -> bool:
    ok, _ = check.judge(nums, cell.config["limits"][cell.traffic["kind"]])
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["election-dense.fit",
                                      "election-dense.predict"])
def test_controls_fail_and_the_program_passes(card, workload):
    cell = spec.cell(spec.load_benchmark(Path(ROOT)), workload, Path(ROOT))
    seed = 2 ** 31 + 101
    sound = calibrate.readings(cell, seed, "highest", "cuda")
    assert _limits_pass(cell, sound), sound
    for control in ("high", "reference"):
        nums = calibrate.readings(cell, seed, control, "cuda")
        assert not _limits_pass(cell, nums), (control, nums)
