#!/usr/bin/env python3
"""The port's mesh fits on the four CUDA cards of one host, each held
against its reference, with records.

    python3 tools/multi_card.py --only PART [--ref DIR] [--out DIR]
                                [--device cpu]

Run from a tree's root. With fewer than 4 visible cards it refuses and
exits 1 (``ring-ref`` excepted, which needs one card): it never fits on
one card in their place. Every part writes ``OUT/PART.json`` (default OUT
``multi_card_out``) and prints it as its last line; a part with a
failed check exits 1. The references that a later part reads
(``dense-90k.npz``, ``ring-ref.npz``) are read from ``--ref`` (default
OUT). The card's name and power limit, ``nvidia-smi topo -m`` and peer
access between every pair of cards come first.

The parts (PERF.md §2's limits: ``bench.compare_fits``):

* ``kernels``: K1 at (3106, 67) symmetric and (45000, 20) cross, K2 at
  (50000, 20, 540) precise and fast and its cross entry at 250000×250000,
  m=540, on each of cuda:0..3 in turn: each within its plain version's
  tolerance (K1 1e-5; K2 ``k2_tol``, fast ``K2_FAST_TOL`` against plain
  TF32) and bit-equal to cuda:0's result; ms per card beside the bound
  and the plain version's ms.
  Run from a parent tree's root it shows whether that tree's kernels
  launch on a second card (each failure is recorded, the cards go on);
* ``dense-small``: the default fit at N=3106, P=67 (``bench.smoke_data``)
  over a 2×2 mesh of cuda:0..3, against the same fit over a 2×2 of
  virtual shards of cuda:0 (bit-equal, else the largest difference per
  field, held to §2) and the fit on one card; K1 launches per card, cold
  and warm times, and the golden search + solve of a warm fit timed
  apart on the cards and on the virtual shards;
* ``dense-64k``: the default fit of ``bench.streaming_data(64000)`` over
  the 2×2 of cards in float32 and in float64, held against each other;
  peak memory and the most live (N/2)² blocks per card, phases; and the
  one-card fit at N=32,000 (f32), whose peak sizes what one card holds;
* ``dense-90k``: the same at N=90,000 in float32, then ``summary`` and
  ``predict(X[:10], se_pred=True)``; the route, the capture checks' log,
  K1 launches per card (in the fit and in predict), saved as the
  reference of ``procs``; then the fit again, warm;
* ``ring-ref``: the streaming fit of ``bench.streaming_data(1_000_000)``
  (``neig=500``, five derivative columns) on cuda:0 alone: λ*, LOO, Neff,
  R², AMEs, lastkeeper and every 100th ŷ, saved for ``ring-1m``;
* ``ring-1m``: that fit over a ring of cuda:0..3 (16 K2 cross launches a
  product, 4 a card) against ``ring-ref``, the LOO errors compared at the
  reference's λ* (each at its own λ* printed beside); peak per card;
* ``procs``: ``torchrun --nproc-per-node 4`` (one card each: the 2×2
  dense-small fit, the ring-4 streaming fit at N=50,000 and dense-90k) and
  ``--nproc-per-node 2`` (two cards each: the first two), NCCL, each fit
  cold and then warm, against the single-process fit of the same mesh
  (dense-90k: the ``dense-90k`` part's record), with whether it is
  bit-equal; each rank's cards; the golden search + solve of a further
  warm fit, timed apart. ``--procs-fits dense-small,ring`` leaves
  dense-90k out;
* ``cli``: ``python -m bigkrls_tpu_torch fit data.csv --mesh 2x2 --device
  cuda`` at N=3106, then ``summary`` and ``predict --se`` on the saved
  model, against the same fit in this process; each subcommand's device.

Every mesh fit runs under ``parallel/sharded.record_gathers``: an N×N
gather, or an N-row gather off ``GATHER_ALLOWED``, fails. ``--device cpu``
rehearses every part at a small N on ``cpu`` shards (gloo for ``procs``),
where the kernels are their plain versions. No JAX is used.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))

PARTS = ("kernels", "dense-small", "dense-64k", "dense-90k", "ring-ref",
         "ring-1m", "procs", "cli")
CARDS = 4
PROCS_FITS = ("dense-small", "ring", "dense-90k")
GIB = 2 ** 30
# what the fits may use of an 80 GB card (the streaming planner's and
# PERF.md's ceiling)
CARD_LIMIT_GIB = 79.2
STREAM_COLS = [0, 1, 2, 3, 4]

# the sizes on the cards, and the CPU rehearsal's
SIZES = {
    "cuda": dict(small=(3106, 67), d64=64_000, one_card=32_000, d90=90_000,
                 ring=1_000_000, procs_ring=50_000, neig=500, stream_p=20,
                 k1=[(3106, 3106, 67, True), (45_000, 45_000, 20, False)],
                 k2=(50_000, 20, 540), k2_cross=(250_000, 250_000, 20, 540),
                 small_kw={}, stream_kw={}),
    "cpu": dict(small=(1024, 8), d64=2048, one_card=1024, d90=1280,
                ring=2048, procs_ring=1024, neig=40, stream_p=6,
                k1=[(300, 300, 8, True), (256, 256, 4, False)],
                k2=(512, 4, 32), k2_cross=(256, 256, 4, 32),
                small_kw={"eigtrunc": 1e-3, "eig_method": "adaptive"},
                stream_kw={"streaming": True}),
}


# ---------------------------------------------------------------------------
# the machine
# ---------------------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def print_topology() -> dict:
    """``nvidia-smi topo -m`` and peer access between every pair."""
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True).stdout.rstrip()
    print(topo, flush=True)
    n = torch.cuda.device_count()
    peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
             for i in range(n) for j in range(n) if i != j}
    print(f"peer access: {json.dumps(peers)}", flush=True)
    return peers


def cards(dev_type: str):
    if dev_type == "cpu":
        return [torch.device("cpu")] * CARDS
    return [torch.device("cuda", i) for i in range(CARDS)]


def sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def reset_peaks(devices) -> None:
    sync(devices)
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def peaks_gib(devices) -> dict:
    """Peak allocated memory (GiB) per distinct card; "not measured" on
    the CPU."""
    sync(devices)
    return {str(d): (torch.cuda.max_memory_allocated(d) / GIB
                     if d.type == "cuda" else "not measured")
            for d in dict.fromkeys(devices)}


def free(devices) -> None:
    sync(devices)
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def device_ms(fn, device, reps: int = 3, warmup: int = 1) -> float:
    """Mean ms of ``fn`` on ``device`` (CUDA events; the host clock on the
    CPU)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# fits and their comparison
# ---------------------------------------------------------------------------

FIELDS = ("lambda_", "looe", "neffective", "R2", "coeffs", "yfitted",
          "avgderivatives", "var_avgderivatives")


@contextlib.contextmanager
def timed_searches(devices):
    """Times every golden-section search and solve (``golden_solve``, as
    the fit's modules call it) made inside, each between two syncs of
    ``devices``: yields the list of seconds."""
    from bigkrls_tpu_torch import lambda_search
    from bigkrls_tpu_torch.ops import adaptive, fused
    times, saved = [], []
    for mod in (adaptive, fused, lambda_search):
        fn = mod.golden_solve

        def timed(*a, _fn=fn, **kw):
            sync(devices)
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            sync(devices)
            times.append(time.perf_counter() - t0)
            return out
        saved.append((mod, fn))
        mod.golden_solve = timed
    try:
        yield times
    finally:
        for mod, fn in saved:
            mod.golden_solve = fn


def counts_reset():
    from bigkrls_tpu_torch.ops import kernels, matvec
    kernels.gauss_tile_launches_by_device.clear()
    matvec.kernel_matmul_launches_by_device.clear()
    matvec.kernel_matmul_shapes.clear()
    matvec.kernel_matmul_cross_launches = 0


def counts_read() -> dict:
    from bigkrls_tpu_torch.ops import kernels, matvec
    return {"k1_by_card": dict(kernels.gauss_tile_launches_by_device),
            "k2_by_card": dict(matvec.kernel_matmul_launches_by_device),
            "k2_cross": matvec.kernel_matmul_cross_launches,
            "k2_by_shape": {str(k): v for k, v in
                            matvec.kernel_matmul_shapes.items()}}


def timed_fit(tag, y, X, devices, block=None, **kw):
    """A cold fit under the gather log: (model, record). ``block`` (N×N
    row and column counts of a mesh block) adds the most such blocks live
    at once per card (``utils/memory.LiveBlocks``)."""
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.parallel.sharded import record_gathers
    from bigkrls_tpu_torch.utils.memory import LiveBlocks
    kw.setdefault("noisy", False)
    free(devices)
    reset_peaks(devices)
    counts_reset()
    lines = []
    live = contextlib.nullcontext()
    if block:
        with LiveBlocks(1):   # its first use costs seconds: not the fit's
            torch.zeros(1).add_(1)
        live = LiveBlocks(block[0] * block[1] * torch.empty(
            (), dtype=kw.get("dtype") or torch.float32).element_size())
    t0 = time.perf_counter()
    with record_gathers() as log, live:
        m = bt.fit(y, X, log=lines.append, **kw)
    sync(devices)
    sec = time.perf_counter() - t0
    n = X.shape[0]
    rec = {"n": n, "p": X.shape[1], "seconds": sec,
           "eig_path": m.eig_path, "lambda": m.lambda_, "looe": m.looe,
           "neffective": m.neffective, "R2": m.R2,
           "lastkeeper": m.lastkeeper, "timings": m.timings,
           "peak_gib": peaks_gib(devices), **counts_read(),
           "gathers": {"count": log.count, "elements": log.elements,
                       "offending": [[a, list(b)] for a, b in
                                     log.offending(n)]},
           "log": [ln for ln in lines if "adaptive eig" in ln
                   or "Lambda" in ln]}
    if block:
        rec["live_blocks_by_card"] = dict(live.peak_by_device)
        rec["block_gib"] = live.nbytes / GIB
    print(f"{tag}: {sec:.3f} s, {m.eig_path}, lambda {m.lambda_:.8g}, "
          f"lastkeeper {m.lastkeeper}, R2 {m.R2:.6f}; peak GiB "
          f"{json.dumps(rec['peak_gib'])}; K1 by card {rec['k1_by_card']}, "
          f"K2 by card {rec['k2_by_card']}; gathers {log.count}, off the "
          f"list {rec['gathers']['offending']}; phases "
          f"{json.dumps(m.timings)}", flush=True)
    return m, rec


def gathers_ok(tag, rec, failures):
    if rec["gathers"]["offending"]:
        failures.append(f"{tag}: gathered {rec['gathers']['offending']}")


def peaks_ok(tag, rec, failures):
    for dev, gib in rec["peak_gib"].items():
        if isinstance(gib, float) and not gib < CARD_LIMIT_GIB:
            failures.append(f"{tag}: {dev} peaked at {gib:.2f} GiB")


def fields(m) -> dict:
    return {f: np.asarray(getattr(m, f), dtype=np.float64) for f in FIELDS
            if getattr(m, f) is not None}


def bits(m, ref) -> dict:
    """Per field the largest |difference| (0.0 where bit-equal) and
    whether every field is bit-equal."""
    a, b = fields(m), fields(ref)
    diff = {f: float(np.max(np.abs(a[f] - b[f]))) if a[f].shape == b[f].shape
            else float("inf") for f in a if f in b}
    return {"bit_equal": all(v == 0.0 for v in diff.values()),
            "max_abs_diff": diff}


def compare(tag, m, ref, pred, pred_ref, y, failures):
    """PERF.md §2's limits and the bit comparison of two fits."""
    from bigkrls_tpu_torch.bench import compare_fits
    print(f"{tag}:", flush=True)
    before = len(failures)
    compare_fits(m, ref, pred, pred_ref, y, failures)
    failures[before:] = [f"{tag}: {f}" for f in failures[before:]]
    b = bits(m, ref)
    print(f"  bit-equal: {b['bit_equal']}; max |diff| per field "
          f"{json.dumps(b['max_abs_diff'])}", flush=True)
    return {**b, "within_limits": len(failures) == before}


def save_fit(path, m, pred, y, every: int = 1, **extra):
    """A fit's comparable fields (ŷ every ``every``-th row) as .npz."""
    np.savez(path, lambda_=m.lambda_, looe=m.looe, neffective=m.neffective,
             R2=m.R2, lastkeeper=m.lastkeeper,
             avgderivatives=m.avgderivatives,
             var_avgderivatives=m.var_avgderivatives, coeffs=m.coeffs[::every],
             yfitted=m.yfitted[::every], every=every, y_sd=np.std(y, ddof=1),
             predicted=pred.predicted, se_pred=pred.se_pred, **extra)


def load_fit(path):
    """(model-like, prediction-like) from :func:`save_fit`'s file."""
    d = np.load(path)
    m = SimpleNamespace(**{k: (d[k].item() if d[k].ndim == 0 else d[k])
                           for k in d.files})
    m.lastkeeper = int(m.lastkeeper)
    return m, SimpleNamespace(predicted=m.predicted, se_pred=m.se_pred)


def looe_at(m, y, lam: float) -> float:
    """The LOO error of a fitted model's eigensystem at ``lam`` (the fit's
    own spectral solve, on its row shards), in y's units."""
    from bigkrls_tpu_torch.ops.solve import loo_loss_batch, \
        solve_precompute
    from bigkrls_tpu_torch.ops.stats import standardize
    Q = m.vcov_c_factored.Q
    dev, dtype = Q.device, Q.dtype
    yd = torch.as_tensor(np.asarray(y, dtype=np.float64), dtype=dtype,
                         device=dev)
    _, y_std, *_ = standardize(yd[:, None], yd)
    vals = torch.as_tensor(m.K_eigenvalues[:m.lastkeeper], dtype=dtype,
                           device=dev)
    loo = loo_loss_batch(Q, vals, *solve_precompute(Q, y_std), [lam])
    return float(loo[0]) * float(m.y_sd)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------

def kernels_part(cfg, dev_type, out, ref, failures):
    """K1 and K2 on each card in turn, against their plain versions and
    bit-equal to cuda:0's results."""
    from bigkrls_tpu_torch.bench import (K2_FAST_TOL, k1_bound_ms,
                                         k2_bound_ms, k2_cross_bound_ms,
                                         k2_tol)
    from bigkrls_tpu_torch.ops import kernels, matvec
    gen = torch.Generator().manual_seed(13)
    rec = {"k1": [], "k2": []}

    def on_each_card(name, make, run, plain, tol, bound):
        """``run`` on each card on the same inputs: error vs ``plain`` (of
        max|plain| where ``tol`` is relative), bit-equality to the first
        card's result, ms."""
        first = None
        inputs = make()
        for dev in cards(dev_type):
            entry = {"shape": name, "device": str(dev)}
            try:
                args = [t.to(dev) for t in inputs]
                got = run(*args)
                want = plain(*args)
                sync([dev])
                err = (got - want).abs().max().item()
                scale = want.abs().max().item() if tol[1] else 1.0
                entry["max_abs_err"] = err
                entry["rel_err"] = err / scale
                entry["ok"] = err <= tol[0] * scale
                if first is None:
                    first = got
                    entry["bit_equal_to_first"] = True
                else:
                    entry["bit_equal_to_first"] = bool(
                        torch.equal(got, first.to(dev)))
                del want
                entry["ms"] = device_ms(lambda: run(*args), dev, reps=2)
                entry["plain_ms"] = device_ms(lambda: plain(*args), dev,
                                              reps=1, warmup=0)
                entry["bound_ms"], entry["bound_by"] = bound
                if not entry["ok"]:
                    failures.append(f"{name} on {dev}: {err / scale:.3e} > "
                                    f"{tol[0]:g}")
                if not entry["bit_equal_to_first"]:
                    failures.append(f"{name} on {dev}: differs from "
                                    f"{cards(dev_type)[0]}")
                del got, args
            except Exception as e:   # noqa: BLE001 - the next card goes on
                entry["error"] = f"{type(e).__name__}: {e}"
                failures.append(f"{name} on {dev}: {entry['error']}")
            print(f"{name} on {dev}: {json.dumps(entry)}", flush=True)
            yield entry
            free(cards(dev_type))
        del first

    for m_, n_, p_, sym in cfg["k1"]:
        def make(m_=m_, n_=n_, p_=p_, sym=sym):
            A = torch.randn((m_, p_), generator=gen)
            return [A] if sym else [A, torch.randn((n_, p_), generator=gen)]

        def run(A, B=None, p_=p_):
            return kernels.gauss_tile(A, A if B is None else B, float(p_),
                                      B is None)

        def plain(A, B=None, p_=p_):
            return kernels.gauss_tile_plain(A, A if B is None else B,
                                            float(p_), B is None)
        name = f"K1 ({m_},{n_},{p_},{'sym' if sym else 'cross'})"
        rec["k1"] += list(on_each_card(name, make, run, plain, (1e-5, False),
                                       k1_bound_ms(m_, n_, p_)))
    n_, p_, m_ = cfg["k2"]
    for fast in (False, True):
        def make(n_=n_, p_=p_, m_=m_):
            return [torch.randn((n_, p_), generator=gen),
                    torch.randn((n_, m_), generator=gen)]

        def run(X, V, fast=fast, p_=p_):
            return matvec.kernel_matmul(X, V, float(p_), fast_accum=fast)

        def plain(X, V, fast=fast, p_=p_):
            return matvec.kernel_matmul_plain(X, V, float(p_),
                                              fast_accum=fast)
        mode = "fast" if fast else "split"
        rec["k2"] += list(on_each_card(
            f"K2 ({n_},{p_},{m_},{mode})", make, run, plain,
            (K2_FAST_TOL if fast else k2_tol(n_), True),
            k2_bound_ms(n_, p_, m_, mode)))
    na, nb, p_, m_ = cfg["k2_cross"]

    def make_x():
        return [torch.randn((na, p_), generator=gen),
                torch.randn((nb, p_), generator=gen),
                torch.randn((nb, m_), generator=gen)]

    rec["k2"] += list(on_each_card(
        f"K2 cross ({na}x{nb},{p_},{m_},split)", make_x,
        lambda Xa, Xb, V: matvec.kernel_matmul_cross(Xa, Xb, V, float(p_)),
        lambda Xa, Xb, V: matvec.kernel_matmul_plain(Xa, V, float(p_),
                                                     Xb=Xb),
        (k2_tol(nb), True), k2_cross_bound_ms(na, nb, p_, m_, "split")))
    return rec


def dense_small_part(cfg, dev_type, out, ref, failures):
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import smoke_data
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    y, X = smoke_data(*cfg["small"])
    devs = cards(dev_type)
    mesh = make_mesh(devices=devs)
    virtual = make_mesh(devices=[devs[0]] * CARDS)
    kw = dict(cfg["small_kw"])
    m, rec = timed_fit("dense-small, 2x2 of cards, cold", y, X, devs,
                       mesh=mesh, **kw)
    gathers_ok("dense-small", rec, failures)
    want = {str(i): 1 for i in range(CARDS)} if dev_type == "cuda" else {}
    if {str(k): v for k, v in rec["k1_by_card"].items()} != want:
        failures.append(f"dense-small: K1 launches by card "
                        f"{rec['k1_by_card']}, expected one on each card")
    if not (m.eig_path or "").startswith("adaptive-krylov"):
        failures.append(f"dense-small took {m.eig_path!r}")
    warm, warm_search = {}, {}
    for side, kw_side in (("cards", dict(mesh=mesh)),
                          ("virtual", dict(mesh=virtual)),
                          ("virtual", dict(mesh=virtual)),
                          ("cards", dict(mesh=mesh))):
        sync(devs)
        t0 = time.perf_counter()
        bt.fit(y, X, noisy=False, **kw, **kw_side)
        sync(devs)
        warm.setdefault(side, []).append(time.perf_counter() - t0)
    for side, kw_side in (("cards", dict(mesh=mesh)),
                          ("virtual", dict(mesh=virtual))):
        with timed_searches(devs) as searches:
            bt.fit(y, X, noisy=False, **kw, **kw_side)
        warm_search[side] = searches
    print(f"dense-small warm fits (cards, virtual, virtual, cards): "
          f"{json.dumps(warm)}; golden search + solve of a further warm "
          f"fit each, synchronised apart: {json.dumps(warm_search)}",
          flush=True)
    m_v = bt.fit(y, X, noisy=False, mesh=virtual, **kw)
    m_1 = bt.fit(y, X, noisy=False, device=devs[0], **kw)
    preds = [bt.predict(x, X[:10], se_pred=True) for x in (m, m_v, m_1)]
    rec.update(warm_s=warm, warm_golden_solve_s=warm_search,
               vs_virtual=compare("dense-small: cards vs virtual shards",
                                  m, m_v, preds[0], preds[1], y, failures),
               vs_one_card=compare("dense-small: cards vs one card", m, m_1,
                                   preds[0], preds[2], y, failures))
    return rec


def dense_big_part(tag, n, cfg, dev_type, out, ref, failures, f64: bool):
    """The default fit at ``n`` over the 2×2 of cards (and in float64 when
    ``f64``), then summary and predict; saved as ``OUT/TAG.npz``."""
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import streaming_data
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    y, X = streaming_data(n, cfg["stream_p"])
    devs = cards(dev_type)
    mesh = make_mesh(devices=devs)
    half = (-(-n // 2), -(-n // 2))
    m, rec = timed_fit(f"{tag}, 2x2 of cards, f32", y, X, devs, block=half,
                       mesh=mesh, noisy=True, **cfg["small_kw"])
    gathers_ok(tag, rec, failures)
    peaks_ok(tag, rec, failures)
    if not (m.eig_path or "").startswith("adaptive-krylov"):
        failures.append(f"{tag} took {m.eig_path!r}, not the adaptive route")
    if dev_type == "cuda" and sorted(rec["k1_by_card"].values()) != [1] * 4:
        failures.append(f"{tag}: K1 by card {rec['k1_by_card']}")
    t0 = time.perf_counter()
    s = bt.summary(m)
    rec["summary_s"] = time.perf_counter() - t0
    counts_reset()
    t0 = time.perf_counter()
    pred = bt.predict(m, X[:10], se_pred=True)
    sync(devs)
    rec["predict_s"] = time.perf_counter() - t0
    rec["predict_k1_by_card"] = counts_read()["k1_by_card"]
    ok = (np.all(np.isfinite(pred.predicted)) and np.all(pred.se_pred > 0)
          and s.ttests.shape == (X.shape[1], 4)
          and np.all(np.isfinite(m.avgderivatives)))
    if not ok:
        failures.append(f"{tag}: summary/predict not finite or misshapen")
    print(f"{tag}: summary {rec['summary_s']:.3f} s, predict(10, se) "
          f"{rec['predict_s']:.3f} s, K1 in predict by card "
          f"{rec['predict_k1_by_card']}; AMEs {m.avgderivatives[:5]}",
          flush=True)
    save_fit(Path(out) / f"{tag}.npz", m, pred, y)
    if not f64:
        del m
        free(devs)
        t0 = time.perf_counter()
        bt.fit(y, X, mesh=mesh, noisy=False, **cfg["small_kw"])
        sync(devs)
        rec["warm_s"] = time.perf_counter() - t0
        print(f"{tag}: warm fit {rec['warm_s']:.3f} s", flush=True)
    if f64:
        del m
        m64, rec64 = timed_fit(f"{tag}, 2x2 of cards, f64", y, X, devs,
                               block=half, mesh=mesh,
                               dtype=torch.float64, **cfg["small_kw"])
        gathers_ok(f"{tag} f64", rec64, failures)
        peaks_ok(f"{tag} f64", rec64, failures)
        m32, _ = load_fit(Path(out) / f"{tag}.npz")
        rec["f64"] = rec64
        rec["f32_vs_f64"] = compare(f"{tag}: f32 vs f64", m32, m64, pred,
                                    bt.predict(m64, X[:10], se_pred=True), y,
                                    failures)
        del m64
        one = cfg["one_card"]
        y1, X1 = streaming_data(one, cfg["stream_p"])
        m1, rec1 = timed_fit(f"dense-{one} on one card, f32", y1, X1,
                             devs[:1], block=(one, one), device=devs[0],
                             **cfg["small_kw"])
        rec["one_card"] = rec1
        del m1
    return rec


def ring_ref_part(cfg, dev_type, out, ref, failures):
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import streaming_data
    n = cfg["ring"]
    y, X = streaming_data(n, cfg["stream_p"])
    dev = cards(dev_type)[0]
    m, rec = timed_fit(f"ring-ref: streaming fit N={n} on {dev}", y, X,
                       [dev], device=dev, neig=cfg["neig"],
                       which_derivatives=STREAM_COLS, **cfg["stream_kw"])
    pred = bt.predict(m, X[:10], se_pred=True)
    save_fit(Path(out) / "ring-ref.npz", m, pred, y, every=100)
    return rec


def ring_1m_part(cfg, dev_type, out, ref, failures):
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import (TOL_LOOE_REL, TOL_PRED_FRAC,
                                         streaming_data)
    from bigkrls_tpu_torch.parallel.ring_kernel import make_ring_mesh
    path = Path(ref) / "ring-ref.npz"
    if not path.exists():
        failures.append(f"ring-1m: no reference at {path} (run ring-ref)")
        return {}
    ref_m, ref_pred = load_fit(path)
    n = cfg["ring"]
    y, X = streaming_data(n, cfg["stream_p"])
    devs = cards(dev_type)
    ring = make_ring_mesh(devs)
    m, rec = timed_fit(f"ring-1m: streaming fit N={n} over a ring of 4",
                       y, X, devs, mesh=ring, neig=cfg["neig"],
                       which_derivatives=STREAM_COLS, **cfg["stream_kw"])
    gathers_ok("ring-1m", rec, failures)
    peaks_ok("ring-1m", rec, failures)
    if dev_type == "cuda":
        products = rec["k2_cross"] // CARDS ** 2
        by = rec["k2_by_card"]
        if rec["k2_cross"] % CARDS ** 2 or sorted(by.values()) != \
                [CARDS * products] * CARDS:
            failures.append(f"ring-1m: K2 launches {by}, cross "
                            f"{rec['k2_cross']}: not 16 a product, 4 a card")
        rec["products"] = products
    pred = bt.predict(m, X[:10], se_pred=True)
    # LOO errors at one λ: this fit's eigensystem at the reference's λ*
    looe_common = looe_at(m, y, ref_m.lambda_)
    m_cmp = SimpleNamespace(**{k: getattr(m, k) for k in (
        "lambda_", "neffective", "R2", "lastkeeper", "avgderivatives")},
        looe=looe_common)
    print(f"ring-1m vs one card: LOO at the reference's lambda* "
          f"{ref_m.lambda_:.8g}: {looe_common:.8g} vs {ref_m.looe:.8g}; at "
          f"each own lambda*: {m.looe:.8g} vs {ref_m.looe:.8g}", flush=True)
    rec["vs_one_card"] = {"looe_at_ref_lambda": looe_common,
                          "looe_own": m.looe, "looe_ref": ref_m.looe}
    before = len(failures)
    from bigkrls_tpu_torch.bench import compare_fits
    compare_fits(m_cmp, ref_m, pred, ref_pred, y, failures)
    yhat = np.asarray(m.yfitted)[::100]
    d = float(np.max(np.abs(yhat - ref_m.yfitted)) / ref_m.y_sd)
    print(f"  every 100th fitted value / sd(y): {d:.3e} (limit "
          f"{TOL_PRED_FRAC:g})", flush=True)
    if not d <= TOL_PRED_FRAC:
        failures.append(f"ring-1m: fitted values {d} > {TOL_PRED_FRAC}")
    rec["vs_one_card"].update(yhat_frac=d, within_limits=len(failures)
                              == before, looe_limit=TOL_LOOE_REL)
    return rec


def cli_part(cfg, dev_type, out, ref, failures):
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import TOL_PRED_FRAC, smoke_data
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    from bigkrls_tpu_torch.utils.io import design_from_csv
    y, X = smoke_data(*cfg["small"])
    rec = {}
    with tempfile.TemporaryDirectory() as work:
        data, new = os.path.join(work, "data.csv"), os.path.join(work,
                                                                 "new.csv")
        np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.17g",
                   header=",".join(["y"] + [f"x{j}" for j in
                                            range(X.shape[1])]),
                   comments="")
        np.savetxt(new, X[:10], delimiter=",", fmt="%.17g")
        mdir, pcsv = os.path.join(work, "model"), os.path.join(work, "p.csv")
        mesh_arg = "2x2" if dev_type == "cuda" else "1"
        extra = ([] if not cfg["small_kw"] else
                 ["--eigtrunc", str(cfg["small_kw"]["eigtrunc"])])
        runs = [("fit", ["fit", data, "--out", mdir, "--mesh", mesh_arg,
                         *extra]),
                ("summary", ["summary", mdir]),
                ("predict", ["predict", mdir, new, "--se", "--out", pcsv])]
        for name, argv in runs:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "bigkrls_tpu_torch",
                                   *argv, "--device", dev_type],
                                  capture_output=True, text=True)
            last = next((json.loads(ln) for ln in
                         proc.stdout.strip().splitlines()[::-1]
                         if ln.startswith("{")), {})
            rec[name] = {"rc": proc.returncode, "seconds":
                         time.perf_counter() - t0, "last_line": last}
            print(f"cli {name}: exit {proc.returncode}, "
                  f"{rec[name]['seconds']:.2f} s, last line "
                  f"{json.dumps(last)}", flush=True)
            if proc.returncode != 0 or not str(last.get(
                    "device", "")).startswith(dev_type):
                failures.append(f"cli {name}: exit {proc.returncode}, "
                                f"device {last.get('device')!r}")
                print(proc.stdout[-3000:] + proc.stderr[-3000:])
        yc, Xc = design_from_csv(data)
        devs = cards(dev_type)
        mesh = make_mesh(devices=devs if dev_type == "cuda" else devs[:1])
        # what the command line can express of the fit's arguments
        kw = {k: v for k, v in cfg["small_kw"].items() if k == "eigtrunc"}
        m = bt.fit(yc, Xc, mesh=mesh, noisy=False, **kw)
        want = bt.predict(m, Xc[:10], se_pred=True)
        if os.path.exists(pcsv):
            got = np.loadtxt(pcsv, delimiter=",", skiprows=1)
            d = float(np.max(np.abs(got[:, 0] - want.predicted))
                      / np.std(yc, ddof=1))
            saved = bt.load_model(mdir, device=devs[0])
            rec["vs_in_process"] = compare(
                "cli: the saved model vs the same fit in this process",
                saved, m, bt.predict(saved, Xc[:10], se_pred=True), want, yc,
                failures)
        else:
            d = float("inf")
        rec["predict_csv_frac"] = d
        print(f"cli predict --se vs the in-process fit / sd(y): {d:.3e} "
              f"(limit {TOL_PRED_FRAC:g})", flush=True)
        if not d <= TOL_PRED_FRAC:
            failures.append(f"cli predict: {d} > {TOL_PRED_FRAC}")
    return rec


# ---------------------------------------------------------------------------
# procs: the fits across processes, under torchrun
# ---------------------------------------------------------------------------

def _proc_fit(name, cfg, mesh, devs):
    """One of the procs part's fits on ``mesh``, cold, then its time warm:
    (y, X, model, record)."""
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import smoke_data, streaming_data
    if name == "dense-small":
        y, X = smoke_data(*cfg["small"])
        kw = dict(cfg["small_kw"])
        block = None
    elif name == "ring":
        y, X = streaming_data(cfg["procs_ring"], cfg["stream_p"])
        kw = dict(neig=cfg["neig"], which_derivatives=STREAM_COLS,
                  **cfg["stream_kw"])
        block = None
    else:
        n = cfg["d90"]
        y, X = streaming_data(n, cfg["stream_p"])
        kw = dict(cfg["small_kw"])
        block = (-(-n // 2), -(-n // 2))
    m, rec = timed_fit(f"{name} on {mesh}", y, X, devs, block=block,
                       mesh=mesh, **kw)
    free(devs)
    t0 = time.perf_counter()
    bt.fit(y, X, mesh=mesh, noisy=False, **kw)
    sync(devs)
    rec["warm_s"] = time.perf_counter() - t0
    with timed_searches(devs) as searches:
        bt.fit(y, X, mesh=mesh, noisy=False, **kw)
    rec["warm_golden_solve_s"] = searches
    print(f"{name}: warm {rec['warm_s']:.3f} s; golden search + solve of "
          f"a further warm fit, synchronised apart: {searches}", flush=True)
    return y, X, m, rec


def worker(fits, cfg, dev_type, wdir) -> int:
    """One torchrun process: join the group (NCCL on its own cards, gloo
    on cpu shards), build the global 2×2 mesh and run ``fits``; rank 0
    saves each fit, every rank its cards and records."""
    import bigkrls_tpu_torch as bt
    import torch.distributed as dist
    from bigkrls_tpu_torch.parallel import distributed
    distributed.initialize_distributed(device_type=dev_type, timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    local = ([torch.device("cpu")] * (CARDS // world) if dev_type == "cpu"
             else None)
    mesh = distributed.global_mesh((2, 2), local_devices=local)
    devs = mesh.local_devices
    shards = int((mesh.processes == rank).sum())
    info = {"rank": rank, "world": world,
            "local_rank": os.environ.get("LOCAL_RANK"),
            "cards": [str(d) for d in devs], "backend": dist.get_backend(),
            "shards": shards,
            "current_device": (torch.cuda.current_device()
                               if dev_type == "cuda" else None),
            "process_info": distributed.process_info(
                shards if dev_type == "cpu" else None),
            "mesh": repr(mesh), "fits": {}}
    print(f"rank {rank}: {json.dumps(info)}", flush=True)
    rc = 0
    try:
        for name in fits:
            y, X, m, rec = _proc_fit(name, cfg, mesh, devs)
            info["fits"][name] = rec
            pred = bt.predict(m, X[:10], se_pred=True)
            if rank == 0:
                save_fit(Path(wdir) / f"{name}.npz", m, pred, y)
            del m
            free(devs)
    except Exception:   # noqa: BLE001 - reported to the parent
        traceback.print_exc()
        info["error"] = traceback.format_exc()[-2000:]
        rc = 1
    (Path(wdir) / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()
    return rc


def procs_part(cfg, dev_type, out, ref, failures):
    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.bench import streaming_data
    from bigkrls_tpu_torch.parallel.sharded import make_mesh
    devs = cards(dev_type)
    mesh = make_mesh(devices=devs)
    refs, rec = {}, {"single_process": {}, "runs": {}}
    for name in ("dense-small", "ring"):
        y, X, m, r = _proc_fit(name, cfg, mesh, devs)
        refs[name] = (m, bt.predict(m, X[:10], se_pred=True), y)
        rec["single_process"][name] = r
    path90 = Path(ref) / "dense-90k.npz"
    with90 = "dense-90k" in cfg["procs_fits"]
    if with90 and not path90.exists():
        failures.append(f"procs: no reference at {path90} (run dense-90k)")
    free(devs)
    layouts = [(4, ["dense-small", "ring", "dense-90k"]),
               (2, ["dense-small", "ring"])]
    for nproc, fits in layouts:
        fits = [f for f in fits if f in cfg["procs_fits"]]
        with tempfile.TemporaryDirectory() as wdir:
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", f"--nproc-per-node={nproc}",
                   str(Path(__file__).resolve()), "--worker", ",".join(fits),
                   "--wdir", wdir, "--device", dev_type]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  env={**os.environ, "OMP_NUM_THREADS": "1"})
            run = {"rc": proc.returncode,
                   "seconds": time.perf_counter() - t0, "ranks": [],
                   "vs_single_process": {}}
            tail = (proc.stdout + proc.stderr)[-6000:]
            print(f"torchrun --nproc-per-node={nproc}: exit "
                  f"{proc.returncode}, {run['seconds']:.1f} s", flush=True)
            if proc.returncode != 0:
                failures.append(f"procs {nproc}: torchrun exit "
                                f"{proc.returncode}")
                print(tail, flush=True)
            for r in range(nproc):
                p = Path(wdir) / f"rank{r}.json"
                run["ranks"].append(json.loads(p.read_text()) if p.exists()
                                    else {"rank": r, "missing": True})
            for r in run["ranks"]:
                print(f"  rank {r.get('rank')}: {r.get('backend')}, cards "
                      f"{r.get('cards')}, {r.get('shards')} shards of the "
                      f"mesh", flush=True)
            for name in fits:
                p = Path(wdir) / f"{name}.npz"
                if not p.exists():
                    failures.append(f"procs {nproc}: {name} saved nothing")
                    continue
                got, got_pred = load_fit(p)
                if name == "dense-90k":
                    if not path90.exists():
                        continue
                    want, want_pred = load_fit(path90)
                    y = streaming_data(cfg["d90"], cfg["stream_p"])[0]
                else:
                    want, want_pred, y = refs[name]
                run["vs_single_process"][name] = compare(
                    f"procs {nproc}: {name} vs the single-process fit",
                    got, want, got_pred, want_pred, y, failures)
            rec["runs"][str(nproc)] = run
    return rec


def run_part(part, dev_type, out, ref, procs_fits=PROCS_FITS) -> dict:
    cfg = {**SIZES[dev_type], "procs_fits": procs_fits}
    failures = []
    t0 = time.perf_counter()
    fn = {"kernels": kernels_part, "dense-small": dense_small_part,
          "dense-64k": lambda *a: dense_big_part(part, cfg["d64"], *a,
                                                 f64=True),
          "dense-90k": lambda *a: dense_big_part(part, cfg["d90"], *a,
                                                 f64=False),
          "ring-ref": ring_ref_part, "ring-1m": ring_1m_part,
          "procs": procs_part, "cli": cli_part}[part]
    try:
        rec = fn(cfg, dev_type, out, ref, failures)
    except Exception as e:   # noqa: BLE001 - recorded, then exit 1
        traceback.print_exc()
        failures.append(f"{part}: {type(e).__name__}: {e}")
        rec = {}
    return {"part": part, "device": dev_type,
            "seconds": time.perf_counter() - t0, "failures": failures, **rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=PARTS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="multi_card_out")
    ap.add_argument("--ref", default=None)
    ap.add_argument("--procs-fits", default=",".join(PROCS_FITS),
                    help="the fits procs runs across processes (default "
                    "all; without dense-90k it needs no --ref)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.worker:
        return worker(args.worker.split(","), SIZES[args.device],
                      args.device, args.wdir)
    if args.only is None:
        ap.error("--only PART is required")
    head = {"device": args.device}
    if args.device == "cuda":
        need = 1 if args.only == "ring-ref" else CARDS
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < need:
            print(f"multi_card: {args.only} needs {need} CUDA cards, "
                  f"{seen} visible; refusing to run", file=sys.stderr)
            return 1
        head["card"] = card_line()
        print(head["card"], flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{seen} x {torch.cuda.get_device_name(0)}", flush=True)
        head["peer_access"] = print_topology()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    rec = {**head, **run_part(args.only, args.device, args.out,
                              args.ref or args.out,
                              tuple(args.procs_fits.split(",")))}
    (Path(args.out) / f"{args.only}.json").write_text(json.dumps(rec))
    if rec["failures"]:
        print("FAILED:\n  " + "\n  ".join(rec["failures"]), file=sys.stderr)
    print(json.dumps(rec), flush=True)
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
