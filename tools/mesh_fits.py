#!/usr/bin/env python3
"""Time one tree's mesh fits beside its single-device fits on one card.

    python3 tools/mesh_fits.py [--reps N]

Run from a tree's root (this one, or a parent commit unpacked beside it
with ``git archive``) on a CUDA card. Two cells, with chip_smoke.py's
data: the default fit at N=3106, P=67 over a 2×2 mesh of virtual shards of
cuda:0 (the adaptive route), and the streaming fit at N=50,000, P=20,
neig=500, five derivative columns, over a ring of 4. Each mesh fit is made
once cold under a count of its whole-tensor gathers, then warm in turns
with the same fit on the one device (mesh, one, one, mesh, ... ``--reps``
pairs). Prints the card, then one JSON line: per cell, the warm wall times
(synchronized), the peak of ``torch.cuda.max_memory_allocated`` above
what was allocated before each fit, and the gathers (count, elements, how
many were N×N, how many had N rows, by label). A tree with
``parallel/sharded.record_gathers`` is counted by it; an older tree by
counting ``ShardedTensor.full``, through which all of its gathers went.
No JAX is used.
"""
import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))


@contextlib.contextmanager
def gathers():
    """(label, shape) of every whole-tensor gather made inside."""
    from bigkrls_tpu_torch.parallel import sharded
    if hasattr(sharded, "record_gathers"):
        with sharded.record_gathers() as log:
            yield log.entries
        return
    entries, full = [], sharded.ShardedTensor.full

    def counted(self, *a, **k):
        if self.spec != "replicated":
            entries.append(("ShardedTensor.full", tuple(self.shape)))
        return full(self, *a, **k)

    sharded.ShardedTensor.full = counted
    try:
        yield entries
    finally:
        sharded.ShardedTensor.full = full


def warm(bt, y, X, **kw):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bt.fit(y, X, noisy=False, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30)


def cell(bt, y, X, mesh_kw, one_kw, reps):
    n = X.shape[0]
    with gathers() as entries:
        bt.fit(y, X, noisy=False, **mesh_kw)
        torch.cuda.synchronize()
    bt.fit(y, X, noisy=False, **one_kw)
    runs = {"mesh": [], "one": []}
    for r in range(reps):
        for side in (("mesh", "one") if r % 2 == 0 else ("one", "mesh")):
            runs[side].append(warm(bt, y, X, **(mesh_kw if side == "mesh"
                                                else one_kw)))
    labels = {}
    for lab, _ in entries:
        labels[lab] = labels.get(lab, 0) + 1
    return {side: {"warm_s": [t for t, _ in v], "peak_gib": [g for _, g in v]}
            for side, v in runs.items()} | {"gathers": {
                "count": len(entries),
                "elements": sum(math.prod(s) for _, s in entries),
                "n_by_n": sum(len(s) == 2 and s[0] >= n and s[1] >= n
                              for _, s in entries),
                "n_rows": sum(len(s) >= 1 and s[0] >= n for _, s in entries),
                "labels": labels}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_fits: no CUDA device", file=sys.stderr)
        return 1
    import bigkrls_tpu_torch as bt
    import chip_smoke as cs
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    y, X = cs.smoke_data()
    out = {"tree": Path.cwd().name,
           "dense_2x2": cell(bt, y, X, {"mesh": mesh}, {"device": "cuda"},
                             args.reps)}
    y, X = cs.streaming_data(cs.SN)
    kw = dict(neig=cs.SNEIG, which_derivatives=[0, 1, 2, 3, 4])
    out["ring_4"] = cell(bt, y, X, dict(kw, mesh=mesh),
                         dict(kw, device="cuda"), args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
