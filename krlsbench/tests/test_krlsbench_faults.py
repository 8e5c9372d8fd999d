"""A run whose timed path is broken underneath comes out not correct.

Each test drives the whole run on the CPU at a tiny size (past the look
for a card), with the configuration's own limits, and breaks the program
where the answer is produced: one fault of each kind a cell of this
system can have (a stage's answer altered, the mean taken over half the
rows, the lambda search's answer wrong with every later output following
it, the standard errors wrong). Neither a state left unchanged (no training) nor an
exchange between chips (one chip a cell) exists here.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

import bigkrls_tpu_torch
from krlsbench import run
from krlsbench.tests.conftest import tiny_cell

model_mod = importlib.import_module("bigkrls_tpu_torch.model")
predict_mod = importlib.import_module("bigkrls_tpu_torch.predict")


def _fit_fault(monkeypatch, change):
    real = model_mod._fit_impl

    def broken(*a, **kw):
        m = real(*a, **kw)
        change(m)
        return m
    monkeypatch.setattr(model_mod, "_fit_impl", broken)


def _run(workload):
    n = 400 if workload.startswith("streaming") else 150
    cell = tiny_cell(workload, n=n, p=6, pool=2)
    return run.execute(cell, 2 ** 31 + 3, 0.4, False, "cpu", time.time(),
                       log=lambda s: None)


def _eigenvalue_off(m):
    m.K_eigenvalues[1] *= 1.001


def _fitted_off(m):
    m.yfitted[7] += 0.05 * np.std(m.y, ddof=1)


def _half_batch(m):
    m.avgderivatives = m.derivatives[: m.n // 2].mean(0)


def _coeffs_off(m):
    m.coeffs[3] += 0.01 * abs(m.coeffs).max()


@pytest.mark.parametrize("workload", ["election-dense.fit",
                                      "streaming-50k.fit"])
@pytest.mark.parametrize("fault", [_eigenvalue_off, _fitted_off, _half_batch,
                                   _coeffs_off])
def test_a_broken_fit_is_not_correct(monkeypatch, workload, fault):
    assert _run(workload)["correct"]
    _fit_fault(monkeypatch, fault)
    res = _run(workload)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", ["election-dense.fit",
                                      "streaming-50k.fit"])
def test_a_fit_at_a_wrong_lambda_is_not_correct(monkeypatch, workload):
    """The search's answer ten times too large, and every later output
    consistent with it: only the judgment of lambda* itself can see it.
    (At the cells' own sizes a doubled lambda* reads 6-14% against limits
    of 2.5% and 0.5%; at this size, with every eigenpair kept, the loss is
    flatter and a doubling reads 1%. The predict cells judge their set-up
    fit with the same numbers.)"""
    real = bigkrls_tpu_torch.fit

    def refit(y, X, **kw):
        m = real(y, X, **kw)
        return real(y, X, **dict(kw, lambda_=10.0 * m.lambda_))
    monkeypatch.setattr(bigkrls_tpu_torch, "fit", refit)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload,column,factor", [
    # the standard errors high: 25% on the streaming route; 50% on the
    # dense one, whose sound runs read SEs up to 8% off and whose limit
    # is 25% (the float32 adaptive route's boundary Ritz vectors)
    ("election-dense.fit", 1, 1.5),
    ("streaming-50k.fit", 1, 1.25),
    ("election-dense.fit", 3, 0.5)])     # one-sided p-values
def test_a_summary_with_wrong_inference_is_not_correct(monkeypatch, workload,
                                                       column, factor):
    real = bigkrls_tpu_torch.summary

    def broken(m, *a, **kw):
        s = real(m, *a, **kw)
        s.ttests[:, column] *= factor
        return s
    monkeypatch.setattr(bigkrls_tpu_torch, "summary", broken)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", ["election-dense.predict",
                                      "streaming-50k.predict"])
@pytest.mark.parametrize("field", ["predicted", "se_pred"])
def test_a_broken_prediction_is_not_correct(monkeypatch, workload, field):
    real = predict_mod._predict_impl

    def broken(*a, **kw):
        p = real(*a, **kw)
        v = getattr(p, field)
        v[-1] += 0.01 * np.std(v) if field == "predicted" else 0.25 * v[-1]
        return p
    monkeypatch.setattr(predict_mod, "_predict_impl", broken)
    assert _run(workload)["correct"] is False
