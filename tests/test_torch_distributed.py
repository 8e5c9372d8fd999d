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
    elif sys.argv[1] == "--bad":
        _bad(int(sys.argv[2]))
