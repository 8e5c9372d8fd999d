"""Multi-process meshes of the port (``parallel/distributed.py``), after
``tests/test_distributed.py``: two processes on the CPU join a gloo group,
each with 2 ``cpu`` shards, and form one global 2×2 mesh. On it a
row-sharded GEMM is checked against numpy on both ranks, and the ring
product across the process boundary (``batch_isend_irecv`` rotations)
against the single-process ring. Plus the no-argument no-op, the
idempotent second call and the explicit request that cannot form.

The workers are this file run as a script (``--worker RANK PORT``,
``--bad PORT``); they import no JAX."""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(*args):
    env = os.environ.copy()
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs, timeout=120):
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_two_process_gloo_mesh_gemm_and_ring():
    port = _free_port()
    procs = [_spawn("--worker", r, port) for r in (0, 1)]
    outs = _finish(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"OK rank={r}" in out, out
    # both ranks hold the same gathered results
    for key in ("gemm=", "ring=", "block="):
        v0 = outs[0].split(key)[1].split()[0]
        v1 = outs[1].split(key)[1].split()[0]
        assert v0 == v1, (key, v0, v1)


# the JAX worker's tolerances (tests/_distributed_worker.py)
_FIT_TOL = {"dense": (1e-9, 1e-9, 1e-8), "jacobi": (1e-9, 1e-8, 1e-8),
            "streaming": (1e-8, 1e-8, 1e-7), "adaptive": (1e-9, 1e-8, 1e-7)}


def _fit_data():
    """The JAX worker's seed-42 data: n=64, p=3 (one binary column), then
    the adaptive route's n=256 from the same generator."""
    rng = np.random.default_rng(42)
    n, p = 64, 3
    X = rng.normal(size=(n, p))
    X[:, 2] = (X[:, 2] > 0).astype(float)
    y = np.sin(X[:, 0]) + X[:, 1] + 0.8 * X[:, 2] + 0.2 * rng.normal(size=n)
    Xa = rng.normal(size=(256, p))
    Xa[:, 2] = (Xa[:, 2] > 0).astype(float)
    ya = (np.sin(Xa[:, 0]) + Xa[:, 1] + 0.8 * Xa[:, 2]
          + 0.2 * rng.normal(size=256))
    return {"dense": (y, X, {}),
            "jacobi": (y, X, {"eig_method": "jacobi"}),
            "streaming": (y, X, {"streaming": True, "neig": n // 4}),
            "adaptive": (ya, Xa, {"eigtrunc": 0.01,
                                  "eig_method": "adaptive"})}


def test_two_process_whole_fits_match_one_process_and_jax(tmp_path):
    """Four whole fits over one 2×2 mesh whose shards live in two gloo
    processes (dense stepwise, block Jacobi, the streaming ring, adaptive):
    each worker holds them against the port's single-process fit and
    checks that it holds only its own shards; here they are held against
    the JAX package's single-process fits, with the JAX worker's
    tolerances."""
    port = _free_port()
    out = tmp_path / "fits.npz"
    procs = [_spawn("--fits", r, port, out) for r in (0, 1)]
    outs = _finish(procs)
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
        assert f"FITS OK rank={r}" in text, text
    # both ranks reached the same λ* on every route, to the last bit
    assert outs[0].split("lams=")[1].split()[0] == \
        outs[1].split("lams=")[1].split()[0]

    import bigkrls_tpu as bk
    got = np.load(out)
    for name, (y, X, kw) in _fit_data().items():
        tl, tc, td = _FIT_TOL[name]
        mj = bk.fit(y, X, noisy=False, **kw)
        assert abs(float(got[f"{name}_lambda"]) - mj.lambda_) < tl, name
        assert np.max(np.abs(got[f"{name}_coeffs"]
                             - np.asarray(mj.coeffs))) < tc, name
        assert np.max(np.abs(got[f"{name}_yfitted"]
                             - np.asarray(mj.yfitted))) < tc, name
        if name != "adaptive":
            assert np.max(np.abs(got[f"{name}_derivatives"]
                                 - np.asarray(mj.derivatives))) < td, name
            assert np.allclose(got[f"{name}_var_avgderivatives"],
                               np.asarray(mj.var_avgderivatives)), name


def test_four_processes_one_shard_each():
    """A 2×2 mesh of four processes with one ``cpu`` shard each, the
    layout of one process per card: row shards live on (i, 0), so two of
    the four processes hold none and take part in the reductions and
    fetches only. The adaptive and the streaming fit match the
    one-process fits in every worker."""
    port = _free_port()
    procs = [_spawn("--four", r, port) for r in range(4)]
    outs = _finish(procs)
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
        assert f"FOUR OK rank={r}" in text, text


def test_explicit_cluster_that_cannot_form_raises():
    """A world of two whose second process never comes: the call raises
    after its timeout instead of running on alone."""
    proc = _spawn("--bad", _free_port())
    out = _finish([proc])[0]
    assert proc.returncode == 0, out
    assert "RAISED" in out, out


def test_noarg_initialize_is_a_noop(monkeypatch):
    from bigkrls_tpu_torch.parallel import distributed
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed(device_type="cpu") == 1
    assert not distributed.is_initialized()
    info = distributed.process_info(local_devices=4)
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 4, "global_devices": 4}


def test_explicit_request_without_address_raises():
    import pytest
    from bigkrls_tpu_torch.parallel import distributed
    with pytest.raises((ValueError, RuntimeError)):
        distributed.initialize_distributed(coordinator_address=None,
                                           num_processes=2, process_id=0,
                                           device_type="cpu")
    assert not distributed.is_initialized()


def test_global_mesh_single_process():
    from bigkrls_tpu_torch.parallel import distributed, sharded
    mesh = distributed.global_mesh(local_devices=["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.axis_names == ("i", "j")
    assert not sharded.spans_processes(mesh)


# ---------------------------------------------------------------------------
# the worker processes
# ---------------------------------------------------------------------------

def _worker(rank: int, port: int) -> None:
    import torch.distributed as dist

    from bigkrls_tpu_torch.parallel import distributed, ring_kernel, sharded
    torch.set_num_threads(1)
    kw = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
              process_id=rank, local_device_ids=[0, 1], device_type="cpu")
    assert distributed.initialize_distributed(**kw) == 4
    assert distributed.initialize_distributed(**kw) == 4   # idempotent
    info = distributed.process_info(local_devices=2)
    assert info == {"process_index": rank, "process_count": 2,
                    "local_devices": 2, "global_devices": 4}, info
    mesh = distributed.global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.shape == (2, 2)
    assert mesh.processes.tolist() == [[0, 0], [1, 1]]
    assert sharded.spans_processes(mesh)

    rng = np.random.default_rng(0)          # the same inputs on both ranks
    A = rng.normal(size=(40, 30))
    B = rng.normal(size=(30, 6))
    S = sharded.place(torch.as_tensor(A), mesh, "row")
    assert (S.shards[rank] is not None) and (S.shards[1 - rank] is None)
    Y = (S @ torch.as_tensor(B)).full().numpy()
    assert np.max(np.abs(Y - A @ B)) <= 1e-12
    H = sharded.host_gather(S)
    assert np.array_equal(H, A)

    Kb = sharded.place(torch.as_tensor(A[:30]), mesh, "block")
    Z = (Kb @ torch.as_tensor(B)).full().numpy()
    assert np.max(np.abs(Z - A[:30] @ B)) <= 1e-12

    ring = ring_kernel.ring_mesh_of(mesh)
    assert ring.processes.tolist() == [0, 0, 1, 1]
    X = torch.as_tensor(rng.normal(size=(61, 3)))
    V = torch.as_tensor(rng.normal(size=(61, 5)))
    init = torch.as_tensor(rng.normal(size=(61, 5)))
    got = ring_kernel.make_ring_matmul(ring)(X, V, 3.0, init=init,
                                             out_scale=0.5)
    local = ring_kernel.make_ring_mesh(["cpu"] * 4)     # this process only
    want = ring_kernel.make_ring_matmul(local)(X, V, 3.0, init=init,
                                               out_scale=0.5)
    assert torch.equal(got, want), float(torch.max(torch.abs(got - want)))
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "bigkrls_tpu" not in sys.modules
    print(f"OK rank={rank} gemm={Y.sum():.12e} block={Z.sum():.12e} "
          f"ring={float(got.sum()):.12e}", flush=True)


def _fits(rank: int, port: int, out: str) -> None:
    """One rank of the whole-fit case: the four fits over the global mesh
    and over this process alone, their agreement (the JAX worker's
    tolerances), the layouts, a mesh model's save and a mesh checkpoint's
    resume, and rank 0's fields written to ``out``."""
    import torch.distributed as dist

    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize_distributed(
        f"127.0.0.1:{port}", 2, rank, local_device_ids=[0, 1],
        device_type="cpu")
    mesh = distributed.global_mesh(local_devices=["cpu", "cpu"])
    kw = dict(device="cpu", dtype=torch.float64, noisy=False)
    fields, lams = {}, []
    for name, (y, X, extra) in _fit_data().items():
        tl, tc, td = _FIT_TOL[name]
        n = X.shape[0]
        m1 = bt.fit(y, X, **kw, **extra)
        m = bt.fit(y, X, mesh=mesh, **kw, **extra)
        assert m.lastkeeper == m1.lastkeeper, name
        assert abs(m.lambda_ - m1.lambda_) < tl, (name, m.lambda_,
                                                  m1.lambda_)
        assert np.max(np.abs(m.coeffs - m1.coeffs)) < tc, name
        assert np.max(np.abs(m.yfitted - m1.yfitted)) < tc, name
        if m.derivatives is not None:
            assert np.max(np.abs(m.derivatives - m1.derivatives)) < td, name
            assert np.allclose(m.var_avgderivatives, m1.var_avgderivatives)
        rep, Q = m.sharding_report, m.vcov_c_factored.Q
        assert not rep["Q"]["replicated"], (name, rep)
        # this process addresses only its own shards of Q
        assert sum(t.shape[0] for t in Q.shards if t is not None) < n, name
        if name == "streaming":
            assert m.K is None
            assert rep["X_std"]["shard_shape"][0] == n // 4, rep
            assert rep["Q"]["shard_shape"][0] < n, rep
        else:
            # and only its own half of the kernel's rows
            assert rep["K"]["shard_shape"][0] < n, rep
            assert all(blk is None for blk in m.K.shards[1 - rank]), name
        lams.append(m.lambda_)
        for f in ("lambda_", "coeffs", "yfitted", "derivatives",
                  "var_avgderivatives"):
            v = getattr(m, f)
            if v is not None:
                fields[f"{name}_{f.rstrip('_')}"] = np.asarray(v)
        if name == "dense":
            # saved shard by shard (process 0 writes); loaded whole, it
            # predicts as the mesh model does
            folder = bt.save_model(m, os.path.join(os.path.dirname(out),
                                                   "model"))
            pm = bt.predict(m, X[:5], se_pred=True)
            if rank == 0:
                pb = bt.predict(bt.load_model(folder, device="cpu"), X[:5],
                                se_pred=True)
                assert np.max(np.abs(pb.predicted - pm.predicted)) <= 1e-12
                assert np.max(np.abs(pb.se_pred - pm.se_pred)) <= 1e-12
        if name == "adaptive":
            # a mesh checkpoint, written by process 0, resumed by both
            ck = dict(checkpoint_dir=os.path.join(os.path.dirname(out),
                                                  "ckpt"), mesh=mesh)
            first = bt.fit(y, X, **kw, **extra, **ck)
            again = bt.fit(y, X, **kw, **extra, **ck)
            assert again.eig_path == "checkpoint", again.eig_path
            assert again.lambda_ == first.lambda_
            assert np.array_equal(again.coeffs, first.coeffs)
    if rank == 0:
        np.savez(out, **fields)
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "bigkrls_tpu" not in sys.modules
    print(f"FITS OK rank={rank} lams={','.join(map(repr, lams))}",
          flush=True)


def _four(rank: int, port: int) -> None:
    import torch.distributed as dist

    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize_distributed(
        f"127.0.0.1:{port}", 4, rank, local_device_ids=[0],
        device_type="cpu")
    mesh = distributed.global_mesh(local_devices=["cpu"])
    assert mesh.processes.tolist() == [[0, 1], [2, 3]]
    y, X, _ = _fit_data()["adaptive"]
    kw = dict(device="cpu", dtype=torch.float64, noisy=False)
    for extra in (dict(eig_method="adaptive", eigtrunc=0.01),
                  dict(streaming=True, neig=16)):
        m1 = bt.fit(y, X, **kw, **extra)
        m = bt.fit(y, X, mesh=mesh, **kw, **extra)
        assert abs(m.lambda_ - m1.lambda_) < 1e-9, extra
        assert np.max(np.abs(m.coeffs - m1.coeffs)) < 1e-9, extra
        assert np.max(np.abs(m.derivatives - m1.derivatives)) < 1e-8, extra
        pm, p1 = (bt.predict(mm, X[:5], se_pred=True) for mm in (m, m1))
        assert np.max(np.abs(pm.predicted - p1.predicted)) < 1e-9, extra
        held = [t for t in m.vcov_c_factored.Q.shards if t is not None]
        assert len(held) == ((rank % 2 == 0) if "eig_method" in extra
                             else 1), (extra, len(held))
    dist.destroy_process_group()
    print(f"FOUR OK rank={rank}", flush=True)


def _bad(port: int) -> None:
    from bigkrls_tpu_torch.parallel import distributed
    try:
        distributed.initialize_distributed(f"127.0.0.1:{port}", 2, 0,
                                           device_type="cpu", timeout_s=3)
    except (RuntimeError, ValueError) as e:
        print(f"RAISED {type(e).__name__}", flush=True)
        return
    print("FORMED a group of two with one process", flush=True)
    sys.exit(1)


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1] == "--fits":
        _fits(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1] == "--four":
        _four(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1] == "--bad":
        _bad(int(sys.argv[2]))
