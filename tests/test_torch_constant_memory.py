"""The constant-memory (Chebyshev-filtered) streaming fit, port vs JAX,
float64 on the CPU.

``fit()`` takes this flow by itself where the progressive block-Krylov
basis would pass 60% of the device's memory (``ops/eig._auto_krylov``).
Here both packages' ``utils.memory.device_memory_budget`` is replaced by a
1 MiB budget, so ``fit(streaming=True)`` picks the flow at N=2048 on both,
and the port is fed the JAX start block. The Krylov depth is the card's
f32 default (``eig_iters=6``) and the truncation the default above
N=3000 (``eigtrunc=0.001``), so the product plan is the one a card fit
runs: two Chebyshev applications of degree 2 (a start product, then one
recurrence step through the product's ``init``/``out`` epilogue), one
Rayleigh–Ritz product, then the derivatives' product, which also gives ŷ.

The same data through the progressive flow gives the gap between the two
flows; it is printed and held equal to the JAX package's own gap, not
asserted small."""
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu.utils.memory as jmem
import bigkrls_tpu_torch as bt
import bigkrls_tpu_torch.utils.memory as tmem
from bigkrls_tpu.ops import eig as jeig
from bigkrls_tpu_torch import bench
from bigkrls_tpu_torch.ops import eig as teig
from bigkrls_tpu_torch.ops import matvec

torch.set_num_threads(1)

N, P, NEIG, ITERS = 2048, 7, 150, 6
TINY_BUDGET = 2 ** 20
# the H100 80GB's memory as torch.cuda.mem_get_info reports it
CARD_BUDGET = 85_030_000_000
Q = NEIG + 40                    # the flow's block width


def _jax_start(n, q, seed=0):
    """The JAX package's start block: a normal draw from PRNGKey(seed)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, q),
                                      dtype=jnp.float64))


@pytest.fixture(scope="module")
def fits():
    """Both flows on both packages, with the flow each ``_auto_krylov``
    chose and the port's products in call order: (columns of V, init
    given, out is init)."""
    y, X = bench.smoke_data(N, P, seed=7)
    kw = dict(neig=NEIG, eigtrunc=0.001, streaming=True, eig_iters=ITERS,
              noisy=False)
    picks = {"port": [], "jax": []}
    products = []
    real_km = matvec.kernel_matmul
    real_tk, real_jk = teig._auto_krylov, jeig._auto_krylov

    def recording(X_, V, sigma, **k):
        init, out = k.get("init"), k.get("out")
        products.append((int(V.shape[1]), init is not None,
                         out is not None and out is init))
        return real_km(X_, V, sigma, **k)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teig, "start_block",
                   lambda n, q, dtype, device, seed=0: torch.as_tensor(
                       _jax_start(n, q, seed), dtype=dtype, device=device))
        mp.setattr(matvec, "kernel_matmul", recording)
        mp.setattr(teig, "_auto_krylov", lambda *a, **k: picks["port"].append(
            real_tk(*a, **k)) or picks["port"][-1])
        mp.setattr(jeig, "_auto_krylov", lambda *a, **k: picks["jax"].append(
            real_jk(*a, **k)) or picks["jax"][-1])
        out["progressive"] = (
            bt.fit(y, X, device="cpu", dtype=torch.float64, **kw),
            bk.fit(y, X, **kw))
        out["progressive_products"] = list(products)
        products.clear()
        mp.setattr(tmem, "device_memory_budget", lambda *a, **k: TINY_BUDGET)
        mp.setattr(jmem, "device_memory_budget", lambda *a, **k: TINY_BUDGET)
        out["constant"] = (
            bt.fit(y, X, device="cpu", dtype=torch.float64, **kw),
            bk.fit(y, X, **kw))
        out["constant_products"] = list(products)
    out["picks"] = picks
    return out


def test_each_package_picks_the_flow_by_its_budget(fits):
    """Progressive under the default budget, constant-memory under the
    tiny one, on both packages."""
    assert fits["picks"] == {"port": [True, False], "jax": [True, False]}
    for flow in ("progressive", "constant"):
        mt, mj = fits[flow]
        assert mt.eig_path == mj.eig_path == "streaming-krylov"


def test_constant_memory_product_plan(fits):
    """2 applications × (a start product, then a recurrence step through
    the epilogue with ``out`` over ``init``), the Ritz product, then the
    derivatives' product (2 + 4·P columns, ŷ its first): 6 products, the
    flow's signature beside the progressive flow's 6 power + 1 Ritz + 1."""
    stack = 2 + 4 * P
    assert fits["constant_products"] == [
        (Q, False, False), (Q, True, True), (Q, False, False),
        (Q, True, True), (Q, False, False), (stack, False, False)]
    assert fits["progressive_products"] == [(Q, False, False)] * 7 + [
        (stack, False, False)]


@pytest.mark.parametrize("name", ["lambda_", "coeffs", "yfitted",
                                  "avgderivatives", "var_avgderivatives",
                                  "neffective", "R2", "lastkeeper"])
def test_constant_memory_fit_matches_jax(fits, name):
    """λ*, Neff and R² relative, coefficients, ŷ and AMEs absolute at
    1e-10; the AMEs' variances relative at 1e-8; lastkeeper equal."""
    mt, mj = fits["constant"]
    got, want = getattr(mt, name), getattr(mj, name)
    if name == "lastkeeper":
        assert got == want
    elif name in ("lambda_", "neffective", "R2"):
        assert got == pytest.approx(float(want), rel=1e-10)
    elif name == "var_avgderivatives":
        want = np.asarray(want)
        assert np.max(np.abs(np.asarray(got) - want)
                      / np.abs(want)) <= 1e-8
    else:
        assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= 1e-10


def test_gap_between_the_flows_is_jax_gap(fits):
    """The gap between the constant-memory and the progressive flow on the
    same data (λ* rel, R² abs, AMEs of max|AME|, lastkeeper) equals the
    JAX package's gap to 1e-10. Printed; nothing more is asserted of it."""
    (pt, pj), (ct, cj) = fits["progressive"], fits["constant"]

    def gap(prog, const):
        ame = np.asarray(prog.avgderivatives)
        return (const.lambda_ / prog.lambda_ - 1.0, const.R2 - prog.R2,
                float(np.max(np.abs(np.asarray(const.avgderivatives) - ame))
                      / np.max(np.abs(ame))))

    g_t, g_j = gap(pt, ct), gap(pj, cj)
    print(f"constant-memory vs progressive at N={N}: lambda "
          f"{ct.lambda_:.10g} / {pt.lambda_:.10g} (rel {g_t[0]:.3e}), R2 "
          f"abs {g_t[1]:.3e}, AMEs {g_t[2]:.3e} of max|AME|, lastkeeper "
          f"{ct.lastkeeper} / {pt.lastkeeper}; JAX {g_j[0]:.3e}, "
          f"{g_j[1]:.3e}, {g_j[2]:.3e}, {cj.lastkeeper} / {pj.lastkeeper}")
    assert g_t == pytest.approx(g_j, abs=1e-10)
    assert (ct.lastkeeper, pt.lastkeeper) == (cj.lastkeeper, pj.lastkeeper)


@pytest.mark.parametrize("n, progressive", [(2_000_000, False),
                                            (1_600_000, True)])
def test_card_budget_flip(n, progressive):
    """With the H100's memory, a fit at N=2M takes the constant-memory
    flow and one at 1.6M the progressive one, on both packages (f32,
    q=540, the card's Krylov depth 6)."""
    q = bench.STREAM_Q
    assert teig._auto_krylov(n, q, 6, 4, budget=CARD_BUDGET) is progressive
    assert jeig._auto_krylov(n, q, 6, 4, budget=CARD_BUDGET) is progressive


@pytest.mark.parametrize("krylov", [False, True])
def test_start_block_is_freed_with_its_first_block(krylov, monkeypatch):
    """The solver holds its default start block no longer than the block
    orthonormalized from it: at every product it is gone. (It was held to
    the end of the solve: one dead N×q block, 4 GiB at N=2M.)"""
    refs, alive = [], []
    real_start, real_km = teig.start_block, matvec.kernel_matmul

    def start_block(*a, **k):
        t = real_start(*a, **k)
        refs.append(weakref.ref(t))
        return t

    def recording(X_, V, sigma, **k):
        alive.append(refs[0]() is not None)
        return real_km(X_, V, sigma, **k)

    monkeypatch.setattr(teig, "start_block", start_block)
    monkeypatch.setattr(matvec, "kernel_matmul", recording)
    X = torch.as_tensor(np.random.default_rng(3).normal(size=(3000, 5)),
                        dtype=torch.float32)
    teig.eigensystem_streaming(X, 5.0, neig=20, iters=ITERS, krylov=krylov)
    assert alive == [False] * (5 if not krylov else ITERS + 1)


@pytest.mark.parametrize("case, branch", [
    ("well-conditioned", "cholqr2"),
    ("collinear", "householder_after_check"),
    ("float64", "householder")])
def test_block_orth_counts_its_branch(case, branch):
    """``block_orth_counts`` names the branch each call took; a nearly
    collinear f32 block fails CholeskyQR²'s check and takes Householder
    QR, whose columns are orthonormal all the same."""
    rng = np.random.default_rng(11)
    W = rng.normal(size=(teig.CHOLQR_MIN_ROWS, 8))
    if case == "collinear":
        W[:, 1] = W[:, 0] + 1e-7 * W[:, 1]
    W = torch.as_tensor(W, dtype=torch.float64 if case == "float64"
                        else torch.float32)
    before = teig.block_orth_counts.copy()
    Q = teig._block_orth(W)
    assert teig.block_orth_counts - before == {branch: 1}
    G = (Q.T @ Q).double()
    assert torch.max(torch.abs(G - torch.eye(8, dtype=G.dtype))) < 1e-5


def test_planning_budget_is_read_and_restored():
    """``bench.planning_budget`` is what the flow choice reads inside the
    block, and the real lookup is back after it, also after an error."""
    real = tmem.device_memory_budget
    n = 200_000                  # flips at N ≈ 170,500 under 8 GiB
    with bench.planning_budget(bench.JAX_CHIP_BUDGET):
        assert tmem.device_memory_budget("cuda") == bench.JAX_CHIP_BUDGET
        assert not teig._auto_krylov(n, bench.STREAM_Q, ITERS, 4,
                                     device="cuda")
    assert tmem.device_memory_budget is real
    with pytest.raises(RuntimeError):
        with bench.planning_budget(1):
            raise RuntimeError("inside")
    assert tmem.device_memory_budget is real


def test_cross_bound_counts_init():
    """Reading ``init`` adds Na·m·4 bytes to the cross product's bound
    where bytes bound it, and nothing where operations do."""
    na, nb, p, m = 2_000_000, 8, 20, 540
    plain, by = bench.k2_cross_bound_ms(na, nb, p, m, "fast")
    with_init, by_init = bench.k2_cross_bound_ms(na, nb, p, m, "fast",
                                                 init=True)
    assert by == by_init == "bytes"
    assert with_init - plain == pytest.approx(
        1e3 * 4 * na * m / bench.PEAK_HBM, rel=1e-12)
    ops = bench.k2_cross_bound_ms(na, 2048, p, m, "fast")
    assert ops[1] == "operations"
    assert bench.k2_cross_bound_ms(na, 2048, p, m, "fast", init=True) == ops


@pytest.mark.parametrize("part", ["check", "big"])
def test_scale_fits_rehearses_the_constant_memory_parts(part):
    """``tools/scale_fits.py --constant-memory`` on the CPU at a small N
    under a tiny planning budget: each part exits 0 and its records are
    the constant-memory fit's (the check beside the progressive one)."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "tools" / "scale_fits.py"), "--device",
         "cpu", "--constant-memory", "--planning-budget", str(TINY_BUDGET),
         "--check-n", "2100", "--big-n", "2200", "--only", part],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["failures"] == [] and out["constant_memory"]
    fits = out[part]["fits"]
    assert all(f["planning_budget_gib"] == TINY_BUDGET / 2 ** 30
               and f["eig_path"] == "streaming-krylov" for f in fits)
    if part == "check":
        assert [f["fit"] for f in fits] == ["N=2100 auto", "N=2100 auto, warm",
                                            "N=2100 plain"]
        assert out["check"]["progressive"]["planning_budget_gib"] is None
        assert set(out["check"]["gap_to_progressive"]) == {
            "lambda_rel", "R2_abs", "ame_of_max", "lastkeeper"}
    else:
        assert out["big"]["end_rows"]["rows"] == 512
