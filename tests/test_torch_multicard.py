"""The port's mesh on several cards of one host, checked on the CPU.

- Under a launcher (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) each process takes
  its own share of the host's cards and makes the first its current device
  before the group forms (``parallel/distributed.py``); explicit
  ``local_device_ids`` and the gloo path are as before. The cards are
  ``torch.cuda`` functions replaced here, the group a stub.
- ``PhaseTimer`` on a mesh synchronizes each distinct card once per mark.
- The most (N/2)² blocks a card holds in the deflated moments of a 2×2 mesh
  (``ops/adaptive._deflated_moments_sharded``), counted in four gloo
  processes that hold one block each, as four cards do; the moments equal
  the JAX package's at f64.

``tests/test_torch_multicard_tool.py`` rehearses ``tools/multi_card.py``.
The workers are this file run as a script (``--moments RANK PORT DIR``);
they import no JAX. The ``cuda``-marked test runs on two or more cards
(per-card span intervals and the copies between cards) and skips
elsewhere."""
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from _port_threads import one_blas_thread  # noqa: F401

_ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = os.environ.copy()
    env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return env


# ---------------------------------------------------------------------------
# one process, its own cards
# ---------------------------------------------------------------------------

@pytest.fixture
def four_cards(monkeypatch):
    """Four visible cards, ``set_device`` and ``init_process_group``
    recorded (in call order) instead of run."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(("init", kw["backend"],
                                                   kw["init_method"])))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return calls


def _launcher(monkeypatch, rank, local_rank, local_size, world):
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("WORLD_SIZE", world),
                 ("RANK", rank), ("LOCAL_RANK", local_rank),
                 ("LOCAL_WORLD_SIZE", local_size)):
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize("local_rank,local_size,want", [
    (0, 4, [0]), (3, 4, [3]), (0, 2, [0, 1]), (1, 2, [2, 3]),
    (0, 1, [0, 1, 2, 3])])
def test_launcher_gives_each_process_its_own_cards(four_cards, monkeypatch,
                                                   local_rank, local_size,
                                                   want):
    """torchrun's environment: local rank r of L takes cards r·per …
    r·per + per − 1 (per = 4 // L), sets the first as its device before
    the NCCL group forms, and ``global_mesh`` / ``process_info`` see the
    same cards. Before, every process took all four, on cuda:0."""
    from bigkrls_tpu_torch.parallel import distributed
    _launcher(monkeypatch, local_rank, local_rank, local_size, local_size)
    n = distributed.initialize_distributed()
    assert n == len(want)
    assert four_cards == [("set_device", f"cuda:{want[0]}"),
                          ("init", "nccl", "env://")]
    mesh = distributed.global_mesh()
    assert [str(d) for d in mesh.devices.flat] == [f"cuda:{i}"
                                                   for i in want]
    assert distributed.process_info()["local_devices"] == len(want)


def test_launcher_with_more_processes_than_cards_raises(four_cards,
                                                        monkeypatch):
    """Eight local processes on four cards would share them (NCCL refuses
    two ranks on one card): the call raises before any group forms.
    Before, each process took every card."""
    from bigkrls_tpu_torch.parallel import distributed
    _launcher(monkeypatch, 5, 5, 8, 8)
    with pytest.raises(RuntimeError, match="its own card"):
        distributed.initialize_distributed()
    assert four_cards == []


def test_explicit_local_device_ids_keep_their_meaning(four_cards,
                                                      monkeypatch):
    """``local_device_ids`` win over the launcher's share, and an explicit
    request without them takes every card from cuda:0, as before. (The
    parent passes this test too: it guards what did not change.)"""
    from bigkrls_tpu_torch.parallel import distributed
    _launcher(monkeypatch, 1, 1, 4, 4)
    assert distributed.initialize_distributed(
        "127.0.0.1:1234", 4, 1, local_device_ids=[2]) == 1
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k)
    assert distributed.initialize_distributed("127.0.0.1:1234", 4, 1) == 4
    assert four_cards == [
        ("set_device", "cuda:2"), ("init", "nccl", "tcp://127.0.0.1:1234"),
        ("set_device", "cuda:0"), ("init", "nccl", "tcp://127.0.0.1:1234")]


def test_gloo_path_is_unchanged(four_cards, monkeypatch):
    """CPU shards under the launcher: gloo, one ``cpu`` device (or as many
    as ``local_device_ids`` names), and no card is touched. (The parent
    passes this test too: it guards what did not change.)"""
    from bigkrls_tpu_torch.parallel import distributed
    _launcher(monkeypatch, 0, 0, 2, 2)
    assert distributed.initialize_distributed(device_type="cpu") == 1
    assert distributed.initialize_distributed(
        device_type="cpu", local_device_ids=[0, 1]) == 2
    assert four_cards == [("init", "gloo", "env://")] * 2


# ---------------------------------------------------------------------------
# phases that end on every card
# ---------------------------------------------------------------------------

class _Event:
    """A CUDA event's host side: 1.5 ms between any two."""

    def __init__(self, enable_timing=False):
        self.stream = None

    def record(self, stream=None):
        self.stream = stream

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.5


def test_phase_timer_synchronizes_each_card_once(monkeypatch):
    """Each mark waits for every distinct CUDA device of the mesh once
    (virtual shards repeat a card; the CPU needs no wait). Before, only the
    first card was synchronized. On one card no mark synchronizes: a phase
    is the device interval between two CUDA events on its stream."""
    from bigkrls_tpu_torch.utils import progress
    from bigkrls_tpu_torch.utils.progress import PhaseTimer
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(str(d)))
    devs = [torch.device("cuda", i) for i in (0, 1, 0, 3)] + ["cpu"]
    timer = PhaseTimer(device=devs)
    timer.mark("kernel")
    timer.mark("eigendecomposition")
    assert synced == ["cuda:0", "cuda:1", "cuda:3"] * 2
    assert [p["phase"] for p in timer.phases] == ["kernel",
                                                  "eigendecomposition"]
    synced.clear()
    monkeypatch.setattr(progress, "RECORDER", progress.Recorder())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(
                            device_index=torch.device(d).index))
    with progress.span("fit", device="cuda:2"):
        one = PhaseTimer(device="cuda:2")
        one.mark("one")
    PhaseTimer(device="cpu").mark("none")
    assert synced == []
    assert one.finish() == [{"phase": "one", "seconds": 0.0015}]


def test_mesh_fit_times_every_local_device(monkeypatch):
    """``fit(mesh=)`` builds its timer from the mesh's own devices, each
    once (``Mesh.local_devices``), not from its first device alone."""
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch import model
    from bigkrls_tpu_torch.parallel.sharded import Mesh, make_mesh
    seen = []

    class Recording(model.PhaseTimer):
        def __init__(self, device=None):
            seen.append(device)
            super().__init__(device=device)

    monkeypatch.setattr(model, "PhaseTimer", Recording)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(64, 3))
    y = X[:, 0] + 0.1 * rng.normal(size=64)
    bt.fit(y, X, mesh=make_mesh(devices=["cpu"] * 4), noisy=False,
           dtype=torch.float64)
    assert seen == [[torch.device("cpu")]]
    mesh = Mesh(np.array([[torch.device("cuda", 0), torch.device("cuda", 0)],
                          [torch.device("cuda", 1), torch.device("cuda", 2)]],
                         dtype=object), ("i", "j"),
                processes=np.zeros((2, 2), dtype=np.int64))
    assert mesh.local_devices == [torch.device("cuda", i) for i in (0, 1, 2)]


# ---------------------------------------------------------------------------
# what a card holds in the deflated moments
# ---------------------------------------------------------------------------

_N, _P, _K, _ITERS = 96, 3, 10, 2
# the most (N/2)² blocks one card of a 2×2 mesh holds in the moments: K, R,
# R², and in the block products an accumulator, a partial and the two
# operands fetched from other cards; the moments' count that sized the
# N=90,000 fit (PERF.md §6)
LIVE_BLOCKS = 7


def _moments_worker(rank: int, port: int, work: str) -> None:
    """One card of the 2×2 mesh: its K block built and the moments taken
    under ``LiveBlocks``; writes its count (and rank 0 the moments)."""
    from bigkrls_tpu_torch.ops.adaptive import _deflated_moments
    from bigkrls_tpu_torch.parallel import distributed
    from bigkrls_tpu_torch.parallel.sharded import place, \
        sharded_gauss_kernel
    from bigkrls_tpu_torch.utils.memory import LiveBlocks
    torch.set_num_threads(1)
    distributed.initialize_distributed(f"127.0.0.1:{port}", 4, rank,
                                       device_type="cpu")
    mesh = distributed.global_mesh((2, 2), local_devices=["cpu"])
    d = np.load(Path(work) / "inputs.npz")
    X = torch.as_tensor(d["X"])
    vals, vecs = torch.as_tensor(d["vals"]), torch.as_tensor(d["vecs"])
    half = _N // 2
    with LiveBlocks(half * half * 8) as live:
        K = sharded_gauss_kernel(mesh, "plain")(place(X, mesh, "row"),
                                                float(_P))
        m = _deflated_moments(K, vals, place(vecs, mesh, "row"))
    out = {"rank": rank, "live": live.peak,
           "moments": m.tolist() if rank == 0 else None}
    (Path(work) / f"rank{rank}.json").write_text(json.dumps(out))


def test_moments_hold_seven_blocks_a_card_and_equal_jax(tmp_path):
    """Four gloo processes, one block of a 2×2 mesh each (the layout of
    one process per card): every process holds at most 7 blocks of
    (N/2)² at once while it builds its K block and takes the deflated
    moments, and the moments equal the JAX package's (its
    ``_krylov_moments`` on the same K, vals and vectors) at f64. Before,
    R0 stayed to the end and each block product summed into a new block:
    9 blocks."""
    import jax
    import jax.numpy as jnp

    from bigkrls_tpu.ops.adaptive import _krylov_moments
    from bigkrls_tpu.ops.kernels import gauss_kernel
    rng = np.random.default_rng(2024)
    X = rng.normal(size=(_N, _P))
    K = gauss_kernel(jnp.asarray(X), float(_P))
    vals, negvecs, want = _krylov_moments(K, jax.random.PRNGKey(3), _K,
                                          _ITERS)
    np.savez(tmp_path / "inputs.npz", X=X, vals=np.asarray(vals),
             vecs=-np.asarray(negvecs))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--moments",
                               str(r), str(port), str(tmp_path)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(4)]
    assert [g["live"] for g in got] == [LIVE_BLOCKS] * 4
    np.testing.assert_allclose(got[0]["moments"], np.asarray(want),
                               rtol=1e-11)


# ---------------------------------------------------------------------------
# on the cards themselves
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_mesh_fit_spans_are_timed_on_every_card():
    """On two or more cards, each span of a mesh fit holds one device
    interval per card, ``device_s`` the longest, and the fit copies bytes
    between its cards (``bytes_between_cards``). Run on the card with
    ``python -m pytest --noconftest -p no:randomly -q
    tests/test_torch_multicard.py -k every_card``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch import bench
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    from bigkrls_tpu_torch.utils import progress
    cards = [torch.device("cuda", i)
             for i in range(min(4, torch.cuda.device_count()))]
    y, X = bench.smoke_data(4096, 6, seed=3)
    m = bt.fit(y, X, mesh=make_mesh(devices=cards), noisy=False)
    assert m.eig_path.startswith("adaptive-krylov")
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == "fit"][-1]
    spans = [s for s in log if s.call == root.call and s is not root]
    assert "fit/eigendecomposition/krylov/moments" in [s.path for s in spans]
    for s in spans:
        if s.name == "library":      # loading the kernels: host time only
            continue
        assert len(s.device_s_by_card) == len(cards), s.path
        assert s.device_s == max(s.device_s_by_card) >= 0.0, s.path
    assert sum(s.counters.get("bytes_between_cards", 0) for s in spans) > 0


if __name__ == "__main__":
    if sys.argv[1] == "--moments":
        _moments_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
