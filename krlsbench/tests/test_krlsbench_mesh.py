"""The four-card cell's pieces on the CPU: the float64 reference in blocks
against the unblocked one; the ``mesh_fit`` kind over a 2×2 of CPU shards
at a small N, sound and with its lambda* doubled; and the readers of the
deflated moments' span and the copies between cards, over a fabricated
log."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from krlsbench import calibrate, check, data, loop, spec
from krlsbench.reference import blocked, krls
from krlsbench.run import Run
from krlsbench.tests.conftest import tiny_cell


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("recipe,params", [("iid_normal", {}),
                                           ("low_rank", {"factors": 6,
                                                         "noise": 0.3})])
def test_blocked_reference_equals_the_unblocked_one(recipe, params):
    """Over a 2×2 grid of blocks, at eigtrunc 0.001, its Krylov residual
    taken to 1e-12 of the largest value (the cell's 1e-9 leaves the
    coefficients 6e-10 apart): the same kept eigenvalues, bounds and
    lambda*, and the same coefficients, fitted values, derivatives and SEs
    at that lambda*, to 1e-10."""
    torch.set_num_threads(2)
    y, X = data.recipe(recipe)(data.stream(11, 0), 2000, 6, **params)
    f = krls.prepare(X, y, eigtrunc=0.001)
    b = blocked.prepare(X, y, devices=["cpu"] * 4, eigtrunc=0.001,
                        rtol=1e-12)
    lk = f.eig.lastkeeper
    assert b.eig.lastkeeper == lk and b.eig.residual < 1e-12
    assert _rel(b.eig.values.numpy(), f.eig.values[:lk].numpy()) < 1e-10
    assert (b.L, b.U) == (f.L, f.U)
    assert b.lambda_ == pytest.approx(f.lambda_, rel=1e-10)
    o = krls.outputs(f, f.lambda_)
    ob, (yhat_c, deriv_c, ame_c) = blocked.outputs(b, f.lambda_, o.coeffs)
    for got, want in ((ob.coeffs, o.coeffs), (ob.yfitted, o.yfitted),
                      (ob.derivatives, o.derivatives), (ob.se, o.se),
                      (yhat_c, o.yfitted), (deriv_c, o.derivatives),
                      (ame_c, o.avgderivatives)):
        assert _rel(got, want) < 1e-10
    assert ob.neffective == pytest.approx(o.neffective, rel=1e-10)
    assert any(b.binary) == (recipe == "low_rank")


def test_blocked_reference_refuses_a_head_it_cannot_reach():
    y, X = data.recipe("iid_normal")(data.stream(3, 0), 400, 5)
    with pytest.raises(ValueError, match="too many"):
        blocked.prepare(X, y, devices=["cpu"] * 4, eigtrunc=0.0)


def _cell():
    return tiny_cell("dense-90k.mesh4", n=3200, p=5, pool=2)


def test_mesh_fit_kind_is_correct_and_sees_a_doubled_lambda():
    """The kind's loop over a 2×2 mesh of CPU shards and its check against
    the blocked reference: within the configuration's limits; the program
    with its lambda* doubled (``calibrate``'s fault) is not."""
    cell = _cell()
    limits = cell.config["limits"]["fit"]
    for program, sound in (("highest", True), ("fault-lambda", False)):
        nums = calibrate.readings(cell, 2 ** 31 + 7, program, "cpu",
                                  check=1)
        ok, rows = check.judge(nums, limits)
        assert ok is sound, (program, rows)
        assert nums["ref_residual"] < krls.KRYLOV_RTOL


def test_mesh_fit_kind_builds_its_mesh_once_over_the_cells_cards():
    kind = loop.kind(_cell().traffic)
    assert kind.mesh_cards("cpu", {"mesh": [2, 2]}) == \
        [torch.device("cpu")] * 4
    assert kind.mesh_cards("cuda", {"mesh": [2, 2]}) == \
        [torch.device("cuda", i) for i in range(4)]
    lp = loop.make(types.SimpleNamespace(), _cell().config, _cell().traffic,
                   5, "cpu")
    assert lp.chips == 4 and lp.opts["mesh"] is lp.mesh
    assert lp.mesh.shape == (2, 2)


def _span(path, call, t0, seconds, parent=0, **counters):
    return types.SimpleNamespace(path=path, name=path.split("/")[-1],
                                 call=call, parent=parent, t0=t0,
                                 seconds=seconds, counters=counters)


def test_readers_of_the_moments_and_the_copies(monkeypatch):
    from krlsbench import spans
    log = [
        _span("fit/eigendecomposition/krylov/moments", 1, 0.11, 2.0,
              bytes_between_cards=4_000_000_000),
        _span("fit/eigendecomposition/krylov", 1, 0.1, 5.0,
              bytes_between_cards=1_000_000_000),
        _span("fit", 1, 0.1, 9.0, parent=None),
        _span("fit/eigendecomposition/krylov/moments", 2, 10.11, 3.0,
              bytes_between_cards=8_000_000_000),
        _span("fit/eigendecomposition/krylov/moments", 2, 10.21, 1.0),
        _span("fit", 2, 10.1, 9.0, parent=None),
        # the traced job's fit, left out
        _span("fit/eigendecomposition/krylov/moments", 3, 20.11, 50.0,
              bytes_between_cards=1),
        _span("fit", 3, 20.1, 9.0, parent=None),
    ]
    monkeypatch.setattr(spans, "program_log", lambda: log)
    jobs = [loop.Job(i, 9.5, start, {})
            for i, start in enumerate((0.05, 10.05, 20.05))]
    window = loop.Window(jobs=jobs, seconds=30.0, failed=0, errors=[],
                         traced=[jobs[2]])
    run = Run("dense-90k.mesh4", "fit", 1.0, window, 0, None)
    assert spec.load_reader("adaptive_moments_ms.mesh4")(run) == \
        pytest.approx(1e3 * (2.0 + 4.0) / 2)
    assert spec.load_reader("card_copy_gb.mesh4")(run) == \
        pytest.approx((5.0 + 8.0) / 2)
    # a program without the span or the counter reads None
    monkeypatch.setattr(spans, "program_log", lambda: [
        _span("fit/eigendecomposition/krylov", 1, 0.1, 5.0),
        _span("fit", 1, 0.1, 9.0, parent=None)])
    assert spec.load_reader("adaptive_moments_ms.mesh4")(run) is None
    assert spec.load_reader("card_copy_gb.mesh4")(run) is None
