"""Port vs JAX for multi-device fits: ``parallel/`` (mesh, the sharded
kernel, the ring product, block Jacobi, ``fit_step``) and ``fit(mesh=)``
on every route, float64 on the CPU.

The JAX side runs on the conftest's virtual CPU devices, the port on
``cpu`` shards of the same shape (a 2×2 mesh, a ring of 4). Every JAX
mesh fit is computed once, in a module-scoped fixture."""
import jax
import numpy as np
import pytest
import torch

import bigkrls_tpu as bk
import bigkrls_tpu_torch as bt
from bigkrls_tpu.parallel import jacobi as jjac
from bigkrls_tpu.parallel import ring_kernel as jring
from bigkrls_tpu.parallel import sharded as jsh
from bigkrls_tpu.parallel.fit_step import fit_step as jax_fit_step
from bigkrls_tpu_torch import cli
from bigkrls_tpu_torch.ops import matvec
from bigkrls_tpu_torch.parallel import fit_step as tfs
from bigkrls_tpu_torch.parallel import jacobi as tjac
from bigkrls_tpu_torch.parallel import ring_kernel as tring
from bigkrls_tpu_torch.parallel import sharded as tsh
from data_mtcars import mtcars_xy

torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64, noisy=False)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def meshes():
    """(JAX 2×2 mesh, port 2×2 mesh of cpu shards)."""
    return (jsh.make_mesh(devices=jax.devices()[:4]),
            tsh.make_mesh(devices=["cpu"] * 4))


@pytest.fixture(scope="module")
def rings():
    return (jring.make_ring_mesh(jax.devices()[:4]),
            tring.make_ring_mesh(["cpu"] * 4))


# ---------------------------------------------------------------------------
# the mesh, the sharded kernel, the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 4, 6, 8])
def test_make_mesh_shape_matches_jax(count):
    tm = tsh.make_mesh(devices=["cpu"] * count)
    jm = jsh.make_mesh(devices=jax.devices()[:count])
    assert tm.shape == jm.devices.shape
    assert tm.axis_names == jm.axis_names == ("i", "j")
    assert tsh.make_mesh(shape=(4, 2), devices=["cpu"] * 8).shape == (4, 2)


@pytest.mark.parametrize("count", [4, 8])
def test_sharded_gauss_kernel_matches_jax_block_by_block(count, rng):
    """Block (i, j) of the port's K (one tile call each) against the same
    rows and columns of the JAX block-sharded K; square (2×2) and
    non-square (2×4) meshes (whose diagonal crosses blocks off the
    block diagonal)."""
    X = rng.normal(size=(44, 4))
    tm = tsh.make_mesh(devices=["cpu"] * count)
    jm = jsh.make_mesh(devices=jax.devices()[:count])
    Kj = np.asarray(jsh.sharded_gauss_kernel(jm)(
        jax.numpy.asarray(X), jax.numpy.asarray(4.0)))
    Kt = tsh.sharded_gauss_kernel(tm)(tsh.place(_t(X), tm, "row"), 4.0)
    assert Kt.spec == "block" and Kt.n_shards == count
    for i, (r0, r1) in enumerate(Kt.row_bounds):
        for j, (c0, c1) in enumerate(Kt.col_bounds):
            blk = Kt.shards[i][j].numpy()
            assert np.max(np.abs(blk - Kj[r0:r1, c0:c1])) <= 1e-12, (i, j)
    assert np.all(np.diag(Kt.full().numpy()) == 1.0)


def test_block_product_and_region(meshes, rng):
    _, tm = meshes
    A = _t(rng.normal(size=(30, 30)))
    S = tsh.place(A, tm, "block")
    B = _t(rng.normal(size=(30, 4)))
    Y = S @ B
    assert Y.spec == "row" and Y.n_shards == 2
    assert torch.max(torch.abs(Y.full() - A @ B)) <= 1e-12
    assert torch.equal(S.region(3, 17, 5, 29), A[3:17, 5:29])
    P = tsh.block_product(S, S)
    assert torch.max(torch.abs(P.full() - A @ A)) <= 1e-12
    assert abs(float(tsh.trace(S)) - float(torch.trace(A))) <= 1e-12
    assert abs(float(tsh.inner(S, S)) - float(torch.sum(A * A))) <= 1e-10


@pytest.mark.parametrize("n", [64, 61])
def test_ring_matmul_matches_jax(rings, rng, n):
    """K(X)·V over a ring of 4, divisible and ragged N, 1e-10 relative."""
    jr, tr = rings
    X = rng.normal(size=(n, 3))
    V = rng.normal(size=(n, 5))
    Yj = np.asarray(jring.make_ring_matmul(jr)(
        jax.numpy.asarray(X), jax.numpy.asarray(V), 3.0))
    mm = tring.make_ring_matmul(tr)
    assert tring.make_ring_matmul(tr) is mm          # cached per mesh
    Yt = mm(_t(X), _t(V), 3.0).numpy()
    assert np.max(np.abs(Yt - Yj)) <= 1e-10 * np.max(np.abs(Yj))


@pytest.mark.parametrize("n", [64, 61])
def test_ring_matmul_epilogue_matches_jax(rings, rng, n):
    """``init``/``out_scale``, and ``out`` aliasing ``init``, against the
    JAX ring's K·V (which has no epilogue) plus the same arithmetic."""
    jr, tr = rings
    X = rng.normal(size=(n, 3))
    V = rng.normal(size=(n, 5))
    init = rng.normal(size=(n, 5))
    want = (np.asarray(jring.make_ring_matmul(jr)(
        jax.numpy.asarray(X), jax.numpy.asarray(V), 3.0)) + init) * -2.5
    mm = tring.make_ring_matmul(tr)
    got = mm(_t(X), _t(V), 3.0, init=_t(init), out_scale=-2.5).numpy()
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))
    buf = _t(init).clone()
    out = mm(_t(X), _t(V), 3.0, init=buf, out_scale=-2.5, out=buf)
    assert out is buf and np.array_equal(out.numpy(), got)


def test_ring_matmul_launches_cross_entry_per_step(rings, rng, monkeypatch):
    """D² calls of the cross entry per product, each with the caller's
    ``fast_accum`` (the JAX ring ignores it), init only at step 0 and
    out_scale only at the last step."""
    _, tr = rings
    calls = []
    real = matvec.kernel_matmul_cross

    def recording(Xa, Xb, V, sigma, **kw):
        calls.append(kw)
        return real(Xa, Xb, V, sigma, **kw)

    monkeypatch.setattr(matvec, "kernel_matmul_cross", recording)
    tring.make_ring_matmul.cache_clear()
    mm = tring.make_ring_matmul(tr)
    X, V = _t(rng.normal(size=(32, 3))), _t(rng.normal(size=(32, 2)))
    mm(X, V, 3.0, fast_accum=True, out_scale=2.0)
    assert len(calls) == 16
    assert all(c["fast_accum"] for c in calls)
    assert [c["out_scale"] for c in calls] == [None] * 12 + [2.0] * 4
    tring.make_ring_matmul.cache_clear()


def test_padded_ring_kernel_matches_jax(rings, rng):
    jr, tr = rings
    X = rng.normal(size=(30, 3))
    Kj = np.asarray(jring.padded_ring_kernel(jr, jax.numpy.asarray(X), 3.0))
    Kt = tring.padded_ring_kernel(tr, _t(X), 3.0).numpy()
    assert Kt.shape == (30, 30)
    assert np.max(np.abs(Kt - Kj)) <= 1e-12
    with pytest.raises(ValueError, match="divisible"):
        tring.ring_gauss_kernel(tr, _t(X), 3.0)
    assert tring.ring_mesh_of(tsh.make_mesh(devices=["cpu"] * 4)).shape \
        == (4,)


# ---------------------------------------------------------------------------
# block Jacobi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [2, 4, 6, 8, 10])
def test_round_robin_schedule_matches_jax(nb):
    s = tjac.round_robin_schedule(nb)
    assert np.array_equal(s, jjac.round_robin_schedule(nb))
    pairs = {tuple(p) for r in s for p in r}
    assert len(pairs) == nb * (nb - 1) // 2


def _sym(rng, n):
    A = rng.normal(size=(n, n))
    return A + A.T


def _match_vectors(Vt, Vj, tol):
    signs = np.sign(np.sum(Vt * Vj, axis=0))
    assert np.max(np.abs(Vt * signs - Vj)) <= tol


@pytest.mark.parametrize("n,block", [(64, 16), (103, 16)])
def test_block_jacobi_matches_jax(rng, n, block):
    """Eigenvalues to 1e-10, eigenvectors to 1e-8 up to sign; N=103 is
    padded (awkward N)."""
    A = _sym(rng, n)
    wj, Vj = jjac.block_jacobi_eigh(jax.numpy.asarray(A), target_block=block)
    wt, Vt = tjac.block_jacobi_eigh(_t(A), target_block=block)
    assert np.max(np.abs(wt.numpy() - np.asarray(wj))) <= 1e-10
    _match_vectors(Vt.numpy(), np.asarray(Vj), 1e-8)
    assert np.max(np.abs(wt.numpy() - np.linalg.eigvalsh(A))) <= 1e-10


def test_block_jacobi_under_mesh_matches_jax(meshes, rng):
    """The hybrid split: pair problems on one shard, stripe GEMMs split
    over the mesh; the same values as the JAX mesh run."""
    jm, tm = meshes
    A = _sym(rng, 72)
    wj, Vj = jjac.block_jacobi_eigh(jax.numpy.asarray(A), mesh=jm,
                                    target_block=12)
    wt, Vt = tjac.block_jacobi_eigh(tsh.place(_t(A), tm, "block"), mesh=tm,
                                    target_block=12)
    assert np.max(np.abs(wt.numpy() - np.asarray(wj))) <= 1e-10
    _match_vectors(Vt.numpy(), np.asarray(Vj), 1e-8)
    with pytest.raises(RuntimeError, match="did not converge"):
        tjac.block_jacobi_eigh(_t(A), target_block=12, max_sweeps=1)


# ---------------------------------------------------------------------------
# fit(mesh=) against the JAX mesh fits
# ---------------------------------------------------------------------------

def _synth(seed, n, p=3, binary=True):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, p))
    if binary:
        X[:, -1] = (X[:, -1] > 0).astype(float)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.2 * r.normal(size=n)
    return y, X


def _cases():
    y, X, _ = mtcars_xy()
    return {
        # the mtcars oracle, full spectrum: gathered eigh under the mesh
        "dense": (y, X, dict()),
        # a real truncation: block-Krylov with block products
        "truncated": (*_synth(5, 96), dict(neig=24)),
        # the adaptive route, forced at N=512 as the JAX suite does
        "adaptive": (*_synth(8, 512, binary=False),
                     dict(eig_method="adaptive", eigtrunc=0.001)),
        # the full spectrum by block Jacobi
        "jacobi": (*_synth(4, 64, p=4), dict(eig_method="jacobi")),
        # the kernel-free route over the ring of the same shards
        "streaming": (*_synth(3, 64), dict(neig=20, streaming=True)),
    }


@pytest.fixture(scope="module")
def mesh_fits(meshes):
    """Every case fitted once by the JAX package and by the port, each over
    its 2×2 mesh."""
    jm, tm = meshes
    out = {}
    for name, (y, X, kw) in _cases().items():
        mj = bk.fit(y, X, mesh=jm, noisy=False, **kw)
        mt = bt.fit(y, X, mesh=tm, **CPU64, **kw)
        out[name] = (mt, mj, y, X, kw)
    return out


@pytest.mark.parametrize("case", list(_cases()))
def test_mesh_fit_matches_jax(mesh_fits, case):
    """λ*, LOO error, coefficients, AMEs and their variances (the SEs) to
    1e-8; the same route."""
    mt, mj, _, _, _ = mesh_fits[case]
    assert mt.eig_path == mj.eig_path
    assert mt.lastkeeper == mj.lastkeeper
    assert mt.lambda_ == pytest.approx(mj.lambda_, rel=1e-8)
    assert mt.looe == pytest.approx(mj.looe, rel=1e-8)
    assert np.max(np.abs(mt.coeffs - np.asarray(mj.coeffs))) <= 1e-8
    if mt.derivatives is not None:
        assert np.max(np.abs(mt.avgderivatives
                             - np.asarray(mj.avgderivatives))) <= 1e-8
        assert np.allclose(mt.var_avgderivatives,
                           np.asarray(mj.var_avgderivatives), rtol=1e-8,
                           atol=1e-14)


@pytest.mark.parametrize("case", ["dense", "truncated", "jacobi",
                                  "streaming"])
def test_mesh_fit_matches_single_device_fit(mesh_fits, case):
    """The mesh changes nothing but summation order: the port's mesh fit
    against its own single-device fit, and summary/predict/save on it."""
    mt, _, y, X, kw = mesh_fits[case]
    m1 = bt.fit(y, X, **CPU64, **kw)
    assert mt.lambda_ == pytest.approx(m1.lambda_, rel=1e-9)
    assert np.max(np.abs(mt.coeffs - m1.coeffs)) <= 1e-9
    pt = bt.predict(mt, X[:5], se_pred=True)
    p1 = bt.predict(m1, X[:5], se_pred=True)
    assert np.max(np.abs(pt.predicted - p1.predicted)) <= 1e-9
    assert np.allclose(pt.se_pred, p1.se_pred, rtol=1e-7)
    assert bt.summary(mt).ttests.shape == bt.summary(m1).ttests.shape


def test_sharding_report(mesh_fits):
    """K split into 4 blocks, Q and the N-row objects into 2 row shards
    (the 2×2 mesh's "i" axis); on the ring, 4 row shards and no K."""
    rep = mesh_fits["dense"][0].sharding_report
    assert set(rep) == {"K", "Q", "yfitted", "X_std", "derivatives"}
    assert rep["K"]["devices"] == 4 and not rep["K"]["replicated"]
    assert rep["K"]["shard_shape"] == (16, 16)
    for name in ("Q", "yfitted", "X_std", "derivatives"):
        assert rep[name]["devices"] == 2 and not rep[name]["replicated"]
        assert rep[name]["shard_shape"][0] == 16
    ms = mesh_fits["streaming"][0]
    assert ms.K is None and "K" not in ms.sharding_report
    assert ms.sharding_report["Q"]["devices"] == 4
    assert ms.sharding_report["X_std"]["shard_shape"] == (16, 3)


# the budget fits: the adaptive route on a 2×2 mesh (progressive Krylov
# basis: 6·104 columns of 1024 rows) and the streaming route on a ring of 4
# (9·40 columns of 512 rows), both past the small-N flows whose basis is
# wider than N
_BUDGET = {"dense": (1024, dict(eig_method="adaptive", eigtrunc=0.001)),
           "ring": (512, dict(streaming=True, neig=16))}


@pytest.fixture(scope="module")
def budget_fits():
    """Each budget case fitted over the mesh under a gather log, and on
    one device."""
    mesh = tsh.make_mesh(devices=["cpu"] * 4)
    out = {}
    for name, (n, kw) in _BUDGET.items():
        y, X = _synth(21, n)
        with tsh.record_gathers() as log:
            m = bt.fit(y, X, mesh=mesh, **CPU64, **kw)
        out[name] = (m, bt.fit(y, X, **CPU64, **kw), log, y, X)
    return out


@pytest.mark.parametrize("case", list(_BUDGET))
def test_sharding_report_is_the_layout_the_work_ran_on(budget_fits, case):
    """The report describes the objects the fit computed with: Q is the
    model's row-sharded covariance factor, never gathered on the way (the
    gather log holds only the final fetch of the model's fields), and on a
    dense route K stays block-sharded on the model."""
    m, _, log, _, X = budget_fits[case]
    rep, Q = m.sharding_report, m.vcov_c_factored.Q
    assert isinstance(Q, tsh.ShardedTensor) and Q.spec == "row"
    assert rep["Q"] == tsh.shard_info(Q)
    assert rep["Q"]["devices"] == (4 if case == "ring" else 2)
    assert rep["X_std"]["shard_shape"][0] == X.shape[0] // rep["Q"]["devices"]
    assert {lab for lab, _ in log.entries} == {"host_gather"}, log.entries
    if case == "dense":
        assert isinstance(m.K, tsh.ShardedTensor) and m.K.spec == "block"
        assert rep["K"] == tsh.shard_info(m.K)
    else:
        assert m.K is None and "K" not in rep


@pytest.mark.parametrize("case", list(_BUDGET))
def test_mesh_fit_gather_budget(budget_fits, case, tmp_path):
    """No N×N object and no N-row object off ``GATHER_ALLOWED`` is gathered
    by the fit or by ``predict(se_pred=True)``; the fit matches the
    single-device fit; ``save_model`` writes the mesh model shard by shard
    and the loaded (single-device) model predicts as the mesh model does
    (1e-12 of the scale), SEs included."""
    m, m1, log, y, X = budget_fits[case]
    n = X.shape[0]
    assert log.offending(n) == [], log.entries
    assert m.lambda_ == pytest.approx(m1.lambda_, rel=1e-9)
    assert np.max(np.abs(m.coeffs - m1.coeffs)) <= 1e-9
    assert np.max(np.abs(m.derivatives - m1.derivatives)) <= 1e-8
    with tsh.record_gathers() as plog:
        p = bt.predict(m, X[:9], se_pred=True)
    assert plog.offending(n) == [], plog.entries
    p1 = bt.predict(m1, X[:9], se_pred=True)
    assert np.max(np.abs(p.predicted - p1.predicted)) <= 1e-9
    assert np.allclose(p.se_pred, p1.se_pred, rtol=1e-7)
    with tsh.record_gathers() as slog:
        folder = bt.save_model(m, str(tmp_path / "m"))
    assert all(lab == "save_model" for lab, _ in slog.entries), slog.entries
    back = bt.load_model(folder, device="cpu")
    assert isinstance(back.K, (torch.Tensor, type(None)))
    pb = bt.predict(back, X[:9], se_pred=True)
    scale = np.max(np.abs(p.predicted))
    assert np.max(np.abs(pb.predicted - p.predicted)) <= 1e-12 * scale
    assert np.max(np.abs(pb.se_pred - p.se_pred)) <= 1e-12 * scale
    assert np.array_equal(pb.newdataK, p.newdataK) or np.max(
        np.abs(pb.newdataK - p.newdataK)) <= 1e-12


def test_mesh_fit_through_crossvalidate_and_save(mesh_fits, tmp_path):
    """The mesh model (K block-sharded, Q row-sharded) saved and loaded as
    a single-device model predicts as it does: its sums over row shards
    and the loaded model's whole products differ by rounding only."""
    mt, _, y, X, _ = mesh_fits["dense"]
    folder = bt.save_model(mt, str(tmp_path / "m"))
    back = bt.load_model(folder, device="cpu")
    want = bt.predict(mt, X[:4]).predicted
    assert np.max(np.abs(bt.predict(back, X[:4]).predicted - want)) \
        <= 1e-12 * np.max(np.abs(want))
    cv = bt.crossvalidate(y, X, seed=1, ptesting=20,
                          mesh=tsh.make_mesh(devices=["cpu"] * 4), **CPU64)
    cv1 = bt.crossvalidate(y, X, seed=1, ptesting=20, **CPU64)
    assert cv.trained.lambda_ == pytest.approx(cv1.trained.lambda_,
                                               rel=1e-9)
    assert np.max(np.abs(cv.tested.predicted - cv1.tested.predicted)) <= 1e-9


def test_checkpoint_on_mesh_resumes_on_one_device(tmp_path):
    """The adaptive checkpoint written by a mesh fit (vectors gathered
    before the write) resumes on a single device, solution included."""
    y, X = _synth(8, 512, binary=False)
    kw = dict(eig_method="adaptive", eigtrunc=0.001, derivative=False,
              checkpoint_dir=str(tmp_path), **CPU64)
    mm = bt.fit(y, X, mesh=tsh.make_mesh(devices=["cpu"] * 4), **kw)
    assert mm.eig_path.startswith("adaptive-krylov")
    m1 = bt.fit(y, X, **kw)
    assert m1.eig_path == "checkpoint"
    assert m1.lambda_ == mm.lambda_
    assert np.array_equal(m1.coeffs, mm.coeffs)


# ---------------------------------------------------------------------------
# the CLI, fit_step, entry() and dryrun_multichip()
# ---------------------------------------------------------------------------

def test_cli_mesh(tmp_path, capsys, monkeypatch):
    # --x64 sets the package's default dtype; put it back afterwards
    monkeypatch.setattr(bt.model, "DEFAULT_DTYPE", bt.model.DEFAULT_DTYPE)
    y, X, _ = mtcars_xy()
    data = tmp_path / "d.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",")
    out = tmp_path / "m"
    assert cli.main(["fit", str(data), "--out", str(out), "--mesh", "all",
                     "--x64", "--device", "cpu"]) == 0
    assert '"device": "cpu"' in capsys.readouterr().out
    m = bt.load_model(str(out), device="cpu")
    ref = bt.fit(y, X, **CPU64)
    assert m.lambda_ == pytest.approx(ref.lambda_, rel=1e-9)
    for spec, msg in (("2x4", "needs 8 devices, only 1 visible"),
                      ("3", "only 1 devices visible"),
                      ("abc", "expected 'all'"), ("2x", "expected 'all'")):
        with pytest.raises(SystemExit, match=msg):
            cli._parse_mesh(spec, "cpu")
    assert cli._parse_mesh("1x1", "cpu").shape == (1, 1)


def test_fit_step_matches_jax(rng):
    import jax.numpy as jnp
    n, p = 40, 3
    X = rng.normal(size=(n, p))
    X[:, -1] = (X[:, -1] > 0).astype(float)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    mask = np.array([False, False, True])
    rj = jax_fit_step(jnp.asarray(X), jnp.asarray(y), jnp.asarray(0.5),
                      jnp.asarray(mask), sigma=3.0)
    rt = tfs.fit_step(_t(X), _t(y), 0.5, torch.as_tensor(mask), 3.0)
    assert isinstance(rt, tfs.FitStepResult)
    for name in rt._fields:
        assert np.max(np.abs(getattr(rt, name).numpy()
                             - np.asarray(getattr(rj, name)))) <= 1e-10, name


def test_entry_and_dryrun_multichip():
    fn, args = tfs.entry(device="cpu")
    out = fn(*args)
    assert np.isfinite(float(out.looloss))
    assert out.derivatives.shape == (256, 8)
    tfs.dryrun_multichip(4, device="cpu", dtype=torch.float64)
