"""Traffic kind ``mesh_fit``: the ``fit`` kind's closed loop of one client
over the cards of a mesh. Each job is ``fit(mesh=...)`` then ``summary``
on the next dataset of the configuration's pool; the mesh
(``bigkrls_tpu_torch.parallel.sharded.make_mesh``, ``mesh`` rows ×
columns of the mix, default 2×2) is built once, over the cell's cards
(``loop.cards``; on the CPU, virtual shards of the one CPU), and every job
ends when each card has finished its work.

Parameters of the mix: ``mesh``, ``warmup`` jobs in set-up, and
``check``, the number of the window's fits, drawn from the seed, that the
reference works out again. The reference is the float64 one in blocks
(``reference/blocked.py``) over the same cards, each card holding one
block of K: the check's numbers are ``check.fit_numbers``', and beside
them ``ref_residual``, the reference's own Krylov residual over its
largest value.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from krlsbench import check as checks
from krlsbench import loop as loops
from krlsbench import spec
from krlsbench.reference import blocked, krls

_fit = spec.load_module("kinds", "fit", "traffic kind")


def mesh_cards(device, traffic: dict) -> list:
    """The mesh's devices: the cell's cards, or on the CPU as many
    virtual shards of it."""
    rows, cols = traffic.get("mesh", (2, 2))
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (rows * cols)
    return loops.cards(device, rows * cols)


class Loop(_fit.Loop):
    kind = "fit"

    def __init__(self, program, config: dict, traffic: dict, seed: int,
                 device, precision: Optional[str] = None, chips: int = 1):
        from bigkrls_tpu_torch.parallel.sharded import make_mesh
        rows, cols = traffic.get("mesh", (2, 2))
        super().__init__(program, config, traffic, seed, device, precision,
                         rows * cols)
        self.cards = mesh_cards(device, traffic)
        self.mesh = make_mesh(shape=(rows, cols), devices=self.cards)
        self.opts["mesh"] = self.mesh


def fit_numbers(out: dict, ref: blocked.Fit) -> Dict[str, float]:
    """``check.fit_numbers`` on the blocked reference: the same numbers by
    the same definitions, with the reference's outputs at the program's
    lambda* and what follows from the program's coefficients worked out in
    one pass over K's blocks; and ``ref_residual``."""
    which = out["which"]
    deriv = out["derivatives"] is not None
    o, (yhat_c, deriv_c, ame_c) = blocked.outputs(
        ref, out["lambda"], out["coeffs"], which=which, derivative=deriv)
    loss = ref.spectral.loo(out["lambda"])
    sd_y = ref.y_sd
    vals = ref.eig.values.cpu().numpy()
    k = min(ref.eig.lastkeeper, out["lastkeeper"], len(out["eigenvalues"]))
    near = checks.NEAR
    nums = {
        "ref_residual": ref.eig.residual,
        "eigvals": float(np.max(np.abs(out["eigenvalues"][:k] - vals[:k]))
                         / vals[0]),
        "lastkeeper": float(abs(out["lastkeeper"] - ref.eig.lastkeeper)),
        "lambda_rel": checks._rel(out["lambda"], ref.lambda_),
        "loo_excess": loss / ref.spectral.loo(ref.lambda_) - 1.0,
        "loo_local": loss / min(
            ref.spectral.loo(max(ref.L, out["lambda"] / near)),
            ref.spectral.loo(min(ref.U, out["lambda"] * near))) - 1.0,
        "neff_rel": checks._rel(out["neffective"], o.neffective),
        "yhat_c": float(np.max(np.abs(out["yfitted"] - yhat_c)) / sd_y),
        "looe_rel": checks._rel(out["looe"], o.looe),
        "coef": checks._gap(out["coeffs"], o.coeffs),
        "yhat": float(np.max(np.abs(out["yfitted"] - o.yfitted)) / sd_y),
        "r2_abs": abs(out["R2"] - o.R2),
    }
    if deriv:
        nums["deriv_c"] = checks._gap(out["derivatives"], deriv_c)
        nums["deriv"] = checks._gap(out["derivatives"], o.derivatives)
    if out.get("ame") is not None:
        nums["ame_c"] = checks._gap(out["ame"], ame_c)
        nums["ame"] = checks._gap(out["ame"], o.avgderivatives)
        nums["se_rel"] = float(np.max(np.abs(out["se"] / o.se - 1.0)))
        nums["p_abs"] = float(np.max(np.abs(out["pvalues"] - o.pvalues)))
        p = ref.X.shape[1]
        nums["p_c"] = float(np.max(np.abs(out["pvalues"] - krls.pvalues(
            out["ame"] / out["se"], out["neffective"] - p))))
    return nums


def check(loop: Loop, jobs, config, traffic, seed,
          device) -> Dict[str, float]:
    """Numbers over a seeded sample of the window's fits, one blocked
    reference per pool dataset sampled, over the loop's cards."""
    picks = [jobs[i] for i in checks.sample(len(jobs), int(traffic["check"]),
                                            seed)]
    fit = config.get("fit", {})
    checks.free(device)     # the program's cached blocks, on every card
    rows = []
    for index in sorted({j.key for j in picks}):
        y, X = loop.dataset(index)
        ref = blocked.prepare(X, y, devices=loop.cards,
                              eigtrunc=fit.get("eigtrunc"),
                              sigma=fit.get("sigma"))
        rows += [fit_numbers(j.out, ref) for j in picks if j.key == index]
        del ref
        checks.free(device)
    return checks.worst(rows)
