"""Traffic kind ``fit``: each job is ``fit`` then ``summary`` on the next
dataset of the configuration's pool (``config["pool"]`` datasets drawn
from the seed, all of one shape), so no fit reuses another's inputs.

Parameters of the mix: ``warmup`` jobs in set-up, and ``check``, the number
of the window's fits, drawn from the seed, that the reference works out
again.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from krlsbench import check as checks
from krlsbench import data, loop as loops


class Loop:
    kind = "fit"

    def __init__(self, program, config: dict, traffic: dict, seed: int,
                 device, precision: Optional[str] = None, chips: int = 1):
        self.program, self.config, self.traffic = program, config, traffic
        self.device, self.chips = device, chips
        self.opts = loops.fit_options(config, precision)
        self.pool = [data.dataset(config, seed, i)
                     for i in range(int(config.get("pool", 1)))]

    def dataset(self, index: int):
        return self.pool[index % len(self.pool)]

    def warm_up(self) -> None:
        for i in range(int(self.traffic.get("warmup", 2))):
            self.job(i)

    def job(self, index: int) -> loops.Job:
        y, X = self.dataset(index)
        t0 = time.perf_counter()
        with loops.span("fit"):
            m = self.program.fit(y, X, device=self.device, **self.opts)
        t1 = time.perf_counter()
        with loops.span("summary"):
            s = self.program.summary(m)
        loops.sync(self.device, self.chips)
        t2 = time.perf_counter()
        return loops.Job(index, t2 - t0, t0,
                         {"fit": t1 - t0, "summary": t2 - t1}, m.timings,
                         loops.fit_outputs(m, s), index % len(self.pool))


def check(loop: Loop, jobs, config, traffic, seed,
          device) -> Dict[str, float]:
    """Numbers over a seeded sample of the window's fits, one reference
    decomposition per pool dataset sampled."""
    picks = [jobs[i] for i in checks.sample(len(jobs), int(traffic["check"]),
                                            seed)]
    rows = []
    for index in sorted({j.key for j in picks}):
        ref = checks.reference_fit(config, *loop.dataset(index), device)
        rows += [checks.fit_numbers(j.out, ref) for j in picks
                 if j.key == index]
        del ref
        checks.free(device)
    return checks.worst(rows)
