"""Readings that the limits in ``configs/*.json`` are set from.

    python3 -m krlsbench.calibrate --workload NAME --program P --seeds S...

For each seed, in one process, the cell's own loop runs its first
``check`` jobs at the cell's own sizes (for a fit mix as many pool
datasets; for a predict mix the set-up fit and that many requests of the
seed's stream), and the kind's own check works their numbers out against
the plain reference, as a run of ``krlsbench.run`` does. ``--program`` says what stands in the loop:

* ``highest``: the program at the configuration's own precision, which
  gives the lower readings;
* ``high``: the program's own lower-precision path (TF32 on cuBLAS
  products, K2's one-pass mode), the control;
* ``reference``: the reference itself in float32 with TF32 products, the
  control for the numbers that path leaves untouched (matrix-vector
  products, the kernels' distance parts);
* ``fault-lambda``: the program with its lambda search's answer doubled
  (each fit redone at twice its lambda*, so every later output follows the
  wrong lambda*);
* ``fault-se``: the program with the standard errors it reports (the
  summary's and the predictions') 25% high;
* ``fault-p``: the program with the summary's p-values halved (a one-sided
  test reported as two-sided);
* ``fault-trunc``: the program with its eigensystem cut at ten times the
  configured ``eigtrunc`` (0.01 of the largest value for bigKRLS's 0.001),
  every later output following the shorter basis.

``--check K`` reads K jobs a seed in place of the mix's ``check`` (fewer
for a control or a fault, which needs three seeds and not the window's
sample). One JSON line per seed, then the worst and the least reading of
each number over the seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import types

import numpy as np

PROGRAMS = ("highest", "high", "reference", "fault-lambda", "fault-se",
            "fault-p", "fault-trunc")


@contextlib.contextmanager
def _tf32():
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


class ReferenceProgram:
    """The reference in float32 with TF32 products, behind the program's
    entry points and with the fields the loops read."""

    def fit(self, y, X, *, device, **opts):
        import torch

        from .reference import krls
        which = opts.get("which_derivatives")
        with _tf32():
            r = krls.prepare(X, y, neig=opts.get("neig"),
                             eigtrunc=opts.get("eigtrunc"),
                             sigma=opts.get("sigma"), device=device,
                             dtype=torch.float32)
            o = krls.outputs(r, r.lambda_, which=which)
        return types.SimpleNamespace(
            lambda_=r.lambda_, looe=o.looe, neffective=o.neffective,
            coeffs=o.coeffs, yfitted=o.yfitted, R2=o.R2,
            lastkeeper=r.eig.lastkeeper, eig_path="reference-float32",
            K_eigenvalues=r.eig.values.double().cpu().numpy(),
            derivatives=o.derivatives, which_derivatives=which, timings=[],
            fit=(r, o))

    def summary(self, m):
        o = m.fit[1]
        return types.SimpleNamespace(ttests=np.stack(
            [o.avgderivatives, o.se, o.avgderivatives / o.se, o.pvalues], 1))

    def predict(self, m, newdata, se_pred=True, precision=None):
        from .reference import krls
        with _tf32():
            yhat, se = krls.predict(*m.fit, newdata)
        return types.SimpleNamespace(predicted=yhat, se_pred=se)


class FaultyProgram:
    """The program with one answer altered where it is produced."""

    def __init__(self, program, fault: str):
        self.program, self.fault = program, fault

    def fit(self, y, X, **kw):
        if self.fault == "trunc":
            kw = dict(kw, eigtrunc=10.0 * (kw.get("eigtrunc") or 0.001))
        m = self.program.fit(y, X, **kw)
        if self.fault == "lambda":
            m = self.program.fit(y, X, lambda_=2.0 * m.lambda_, **kw)
        return m

    def summary(self, m):
        s = self.program.summary(m)
        if self.fault == "se":
            s.ttests[:, 1] *= 1.25
        if self.fault == "p":
            s.ttests[:, 3] *= 0.5
        return s

    def predict(self, m, newdata, **kw):
        p = self.program.predict(m, newdata, **kw)
        if self.fault == "se":
            p.se_pred = p.se_pred * 1.25
        return p


def readings(cell, seed: int, program: str, device: str,
             warm: bool = True, check: int = 0) -> dict:
    import bigkrls_tpu_torch as bk

    from . import loop as loops

    precision = program if program in ("highest", "high") else None
    stand_in = {"reference": ReferenceProgram()}.get(program) or (
        FaultyProgram(bk, program[len("fault-"):])
        if program.startswith("fault-") else bk)
    # the first seed warms up as the mix says; later seeds only set up
    traffic = dict(cell.traffic, **({"check": check} if check else {}))
    if not warm:
        traffic["warmup"] = 0
    kind = loops.kind(traffic)
    loop = loops.make(stand_in, cell.config, traffic, seed, device,
                      precision)
    loop.warm_up()
    jobs = [loop.job(i) for i in range(int(traffic["check"]))]
    loop.model = None
    return kind.check(loop, jobs, cell.config, traffic, seed, device)


def main(argv=None) -> int:
    from pathlib import Path

    from . import spec
    ap = argparse.ArgumentParser(prog="python3 -m krlsbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=PROGRAMS, default="highest")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = spec.cell(spec.load_benchmark(root), args.workload, root)
    rows = []
    for k, seed in enumerate(args.seeds):
        nums = readings(cell, seed, args.program, args.device, warm=k == 0,
                        check=args.check)
        rows.append(nums)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.program, **nums}), flush=True)
    keys = list(rows[0])
    print(json.dumps({"workload": args.workload, "program": args.program,
                      "seeds": len(rows),
                      "worst": {k: max(r[k] for r in rows) for k in keys},
                      "least": {k: min(r[k] for r in rows) for k in keys}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
