"""The span recorder (``utils/progress``) and the copy counter
(``parallel/sharded``) on a mesh, on the CPU: a 2×2 mesh fit's span tree
with the deflated moments as ``krylov/moments``; the bytes a block
product copies between distinct devices; and a call on several cards
timed on each card's own line of events (the cards' events stood in for).
Imports no JAX."""
import types

import numpy as np
import pytest
import torch

import bigkrls_tpu_torch as bt
from bigkrls_tpu_torch import bench
from bigkrls_tpu_torch.parallel import sharded
from bigkrls_tpu_torch.parallel.sharded import (block_product, make_mesh,
                                                place)
from bigkrls_tpu_torch.utils import progress
from _port_threads import one_blas_thread  # noqa: F401

torch.set_num_threads(1)


def _call(name):
    log = progress.spans()
    root = [s for s in log if s.parent is None and s.name == name][-1]
    return [s for s in log if s.call == root.call], root


def test_mesh_fit_records_the_moments_under_krylov():
    y, X = bench.smoke_data(512, 6, seed=3)
    m = bt.fit(y, X, eigtrunc=0.01, eig_method="adaptive",
               mesh=make_mesh(devices=["cpu"] * 4), dtype=torch.float64,
               noisy=False)
    assert m.eig_path.startswith("adaptive-krylov")
    spans, root = _call("fit")
    eig = [s.path[len("fit/eigendecomposition/"):] for s in spans
           if s.path.startswith("fit/eigendecomposition/")]
    attempts = eig.count("krylov")
    assert attempts >= 1
    assert eig == ["krylov/moments", "krylov", "bounds", "lambda_search",
                   "check"] * attempts
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "moments":
            up = by_id[s.parent]
            assert up.name == "krylov" and up.t0 <= s.t0 <= s.t1 <= up.t1
    # virtual shards of one device copy nothing between cards; the CPU
    # has host intervals alone
    assert all("bytes_between_cards" not in s.counters for s in spans)
    assert all(s.device_s is None and s.device_s_by_card is None
               for s in spans)


@pytest.mark.parametrize("devices,blocks", [
    (["cpu"] * 4, 0),
    # block (i, j) takes A's (i, k) and B's (k, j) for k = 0, 1: of its
    # four operands the two that lie elsewhere, eight blocks in all
    ([torch.device("cpu", i) for i in range(4)], 8)])
def test_block_product_counts_the_bytes_it_copies_between_cards(
        devices, blocks, monkeypatch):
    n = 10
    rng = np.random.default_rng(6)
    a, b = (torch.as_tensor(rng.normal(size=(n, n))) for _ in range(2))
    mesh = make_mesh(devices=devices)
    A, B = place(a, mesh, "block"), place(b, mesh, "block")
    # the CPU keeps every shard on the one CPU: a tensor stands on the
    # mesh device of the shard whose storage it views
    card = sharded._card
    homes = {X.shard(key).untyped_storage().data_ptr():
             card(sharded._device_of(mesh, *key))
             for X in (A, B) for key in X.keys()}
    monkeypatch.setattr(sharded, "_card", lambda x: homes.get(
        x.untyped_storage().data_ptr(), card(x))
        if isinstance(x, torch.Tensor) else card(x))
    with progress.span("probe", device=None) as s:
        C = block_product(A, B)
    torch.testing.assert_close(C.full(), a @ b, rtol=1e-12, atol=1e-12)
    assert s.counters.get("bytes_between_cards", 0) == \
        blocks * (n // 2) ** 2 * a.element_size()


class _CardEvent:
    """A CUDA event's host side on a stand-in card: its time is the
    card's clock when recorded, which the test advances."""
    clock = {}

    def __init__(self, enable_timing=False):
        self.card, self.at = None, None

    def record(self, stream=None):
        self.card = stream.device_index
        self.at = self.clock[self.card]

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        assert other.card == self.card
        return other.at - self.at


@pytest.fixture
def stand_in_cards(monkeypatch):
    monkeypatch.setattr(progress, "RECORDER", progress.Recorder())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _CardEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(
                            device_index=torch.device(d).index))
    _CardEvent.clock = {0: 0.0, 1: 0.0, 3: 0.0}
    return _CardEvent.clock


def test_a_call_on_several_cards_is_timed_on_each(stand_in_cards):
    clock = stand_in_cards
    cards = progress.cards([torch.device("cuda", i) for i in (0, 1, 0, 3)]
                           + ["cpu"])
    assert cards == tuple(torch.device("cuda", i) for i in (0, 1, 3))
    with progress.span("fit", device=cards):
        with progress.span("a"):
            clock.update({0: 2.0, 1: 5.0, 3: 1.0})
        with progress.span("b"):
            clock.update({0: 2.5, 1: 5.5, 3: 4.0})   # b's own work first
            with progress.span("inner", mark=True):
                clock.update({0: 3.0, 1: 6.0, 3: 9.0})
            clock.update({0: 7.0, 1: 6.5, 3: 9.0})
    spans, root = _call("fit")
    got = {s.path: (s.device_s_by_card, s.device_s) for s in spans}
    assert got == {"fit/a": ((2e-3, 5e-3, 1e-3), 5e-3),
                   "fit/b/inner": ((0.5e-3, 0.5e-3, 5e-3), 5e-3),
                   "fit/b": ((5e-3, 1.5e-3, 8e-3), 8e-3),
                   "fit": (None, None)}
    # each card's events go back to that card's pool: the root's, a's,
    # inner's two (it is marked) and b's
    pools = progress.RECORDER._pool
    assert sorted(pools) == [0, 1, 3]
    assert all(len(p) == 5 and {e.card for e in p} == {c}
               for c, p in pools.items())


def test_one_card_and_virtual_shards_keep_one_line(stand_in_cards):
    clock = stand_in_cards
    cards = progress.cards([torch.device("cuda", 1)] * 4)
    assert cards == (torch.device("cuda", 1),)
    assert progress.cards(["cpu", "cpu"]) is None
    with progress.span("fit", device=cards):
        with progress.span("a"):
            clock[1] = 4.0
            with progress.span("b", mark=True):
                clock[1] = 4.5
    spans, _ = _call("fit")
    assert [(s.path, s.device_s, s.device_s_by_card) for s in spans] == \
        [("fit/a/b", 0.5e-3, None), ("fit/a", 4.5e-3, None),
         ("fit", None, None)]
    assert len(progress.RECORDER._pool[1]) == 4
