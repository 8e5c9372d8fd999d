"""Traffic kind ``predict``: set-up fits pool dataset 0; each request is
``predict(model, newdata, se_pred=True)`` on U rows drawn from X with one
covariate shifted by ``shift_sd`` of its standard deviation (a
counterfactual first difference).

Parameters of the mix: the sizes U are one fixed log-uniform grid of
``sizes`` values from ``rows_min`` to min(N, ``rows_max``), the same set
for every seed, in an order the seed permutes, cycle after cycle; the rows
and the column come from the seed. ``warmup`` sizes of the grid run in
set-up; ``check`` requests of the window, drawn from the seed with the
largest among them, are worked out again by the reference.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np

from krlsbench import check as checks
from krlsbench import data, loop as loops
from krlsbench.reference import krls


def request_sizes(n: int, traffic: dict) -> np.ndarray:
    """The fixed grid of request sizes: ``sizes`` log-uniform quantiles
    from ``rows_min`` to min(N, ``rows_max``)."""
    lo, hi = int(traffic["rows_min"]), min(n, int(traffic["rows_max"]))
    k = int(traffic["sizes"])
    q = (np.arange(k) + 0.5) / k
    u = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    return np.clip(np.rint(u), lo, hi).astype(int)


class Loop:
    kind = "predict"

    def __init__(self, program, config: dict, traffic: dict, seed: int,
                 device, precision: Optional[str] = None, chips: int = 1):
        self.program, self.config, self.traffic = program, config, traffic
        self.device, self.seed, self.chips = device, seed, chips
        self.opts = loops.fit_options(config, precision)
        self.precision = self.opts.get("precision", "highest")
        self.y, self.X = data.dataset(config, seed, 0)
        self.x_sd = self.X.std(0, ddof=1)
        sizes = request_sizes(config["n"], traffic)
        order = data.stream(seed, 2).permutation(len(sizes))
        self.sizes = sizes[order]
        self.model = None
        self.fit_out = None

    def newdata(self, index: int) -> np.ndarray:
        """Request ``index``'s rows, the same for the same seed."""
        u = int(self.sizes[index % len(self.sizes)])
        rng = data.stream(self.seed, 3, index)
        rows = self.X[rng.integers(0, self.X.shape[0], size=u)]
        j = int(rng.integers(0, self.X.shape[1]))
        rows[:, j] += float(self.traffic.get("shift_sd", 1.0)) * self.x_sd[j]
        return rows

    def warm_up(self) -> None:
        self.model = self.program.fit(self.y, self.X, device=self.device,
                                      **self.opts)
        self.fit_out = loops.fit_outputs(self.model, None)
        # ``warmup`` sizes spread over the grid, its largest and smallest
        # among them: the blocked path and the library handles start here,
        # not in the window (no size compiles anything)
        sizes = np.unique(self.sizes)
        picks = np.linspace(0, len(sizes) - 1,
                            int(self.traffic.get("warmup", 8)))
        for u in sizes[np.unique(np.rint(picks).astype(int))][::-1]:
            self._predict(self.X[:int(u)])

    def _predict(self, newdata):
        return self.program.predict(self.model, newdata, se_pred=True,
                                    precision=self.precision)

    def job(self, index: int) -> loops.Job:
        new = self.newdata(index)
        t0 = time.perf_counter()
        with loops.span("predict"):
            p = self._predict(new)
        loops.sync(self.device, self.chips)
        t1 = time.perf_counter()
        return loops.Job(index, t1 - t0, t0, {"predict": t1 - t0}, None,
                         {"predicted": p.predicted, "se": p.se_pred,
                          "rows": new.shape[0]},
                         index % len(self.sizes))


def check(loop: Loop, jobs, config, traffic, seed,
          device) -> Dict[str, float]:
    """The set-up fit's numbers, and the predictions of a seeded sample of
    the window's requests, the largest among them: against the reference's
    from the model's own coefficients (``pred_c``), and end to end against
    its own fit at the model's lambda* (``pred``, ``pred_se_rel``)."""
    largest = max(range(len(jobs)), key=lambda i: jobs[i].out["rows"])
    picks = [jobs[i] for i in checks.sample(len(jobs), int(traffic["check"]),
                                            seed, must=largest)]
    ref = checks.reference_fit(config, loop.y, loop.X, device)
    nums = checks.fit_numbers(loop.fit_out, ref)
    o = krls.outputs(ref, loop.fit_out["lambda"], derivative=False)
    pred_c = pred = se = 0.0
    for j in picks:
        new = loop.newdata(j.index)
        yc = krls.predict_from_coeffs(ref, loop.fit_out["coeffs"], new)
        yr, ser = krls.predict(ref, o, new)
        p = j.out
        pred_c = max(pred_c, float(np.max(np.abs(p["predicted"] - yc)))
                     / ref.y_sd)
        pred = max(pred, float(np.max(np.abs(p["predicted"] - yr)))
                   / ref.y_sd)
        se = max(se, float(np.max(np.abs(p["se"] / ser - 1.0))))
    nums.update(pred_c=pred_c, pred=pred, pred_se_rel=se)
    del ref
    checks.free(device)
    return nums

