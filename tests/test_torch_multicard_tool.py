"""``tools/multi_card.py`` (the mesh fits on four cards of one host)
rehearsed on the CPU: it refuses without four cards, and ``--device cpu``
runs every part at a small N on ``cpu`` shards, ``procs`` through
torchrun's gloo processes."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _port_threads import one_blas_thread  # noqa: F401

_ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _env():
    env = os.environ.copy()
    env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return env


_TOOL = _ROOT / "tools" / "multi_card.py"
_SUBPROCESS_PARTS = ("procs", "cli")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """``OUT`` of the rehearsal, with the parts that start processes of
    their own (torchrun's workers, the command line) started in the
    background at once, beside the file's other tests; ``procs`` reads
    ``dense-90k``'s record, so that part runs first."""
    sys.path.insert(0, str(_TOOL.parent))
    import multi_card
    out = tmp_path_factory.mktemp("multi_card")
    assert multi_card.main(["--only", "dense-90k", "--device", "cpu",
                            "--out", str(out)]) == 0
    procs = {part: subprocess.Popen(
        [sys.executable, str(_TOOL), "--only", part, "--device", "cpu",
         "--out", str(out)], cwd=_ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in _SUBPROCESS_PARTS}
    yield multi_card, out, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def test_multi_card_refuses_without_four_cards(rehearsal):
    """On a machine with fewer than 4 cards (here none) every four-card
    part exits 1 before it fits anything."""
    multi_card, out, _ = rehearsal
    for part in ("dense-small", "ring-1m"):
        assert multi_card.main(["--only", part, "--out", str(out)]) == 1
    assert not (out / "ring-1m.json").exists()


@pytest.mark.parametrize("part", ["kernels", "dense-small", "dense-64k",
                                  "ring-ref", "ring-1m"])
def test_multi_card_rehearses_on_the_cpu(rehearsal, part):
    """Each part in this process at a small N on ``cpu`` shards: it
    passes its checks and writes its record (``ring-1m`` against
    ``ring-ref``'s)."""
    multi_card, out, _ = rehearsal
    assert multi_card.main(["--only", part, "--device", "cpu",
                            "--out", str(out)]) == 0
    rec = json.loads((out / f"{part}.json").read_text())
    assert rec["failures"] == [] and rec["part"] == part
    if part == "dense-small":
        assert rec["vs_virtual"]["bit_equal"]
        assert rec["eig_path"].startswith("adaptive-krylov")
    if part == "dense-64k":
        assert rec["f32_vs_f64"]["within_limits"]
        assert rec["live_blocks_by_card"]["cpu"] > 0


@pytest.mark.parametrize("part", _SUBPROCESS_PARTS)
def test_multi_card_rehearses_its_processes(rehearsal, part):
    """``procs`` (torchrun: four gloo processes of one shard each, then
    two of two shards, against the single-process fits, bit-equal) and
    ``cli`` (the command line against the fit in process)."""
    _, out, procs = rehearsal
    text = procs[part].communicate(timeout=240)[0]
    assert procs[part].returncode == 0, text[-4000:]
    rec = json.loads((out / f"{part}.json").read_text())
    assert rec["failures"] == []
    if part == "procs":
        for nproc, fits in (("4", ["dense-small", "ring", "dense-90k"]),
                            ("2", ["dense-small", "ring"])):
            run = rec["runs"][nproc]
            assert sorted(run["vs_single_process"]) == sorted(fits)
            assert [r["shards"] for r in run["ranks"]] == \
                [4 // int(nproc)] * int(nproc)
            for name in ("dense-small", "ring"):
                assert run["vs_single_process"][name]["bit_equal"], name
    else:
        assert [rec[c]["rc"] for c in ("fit", "summary", "predict")] == \
            [0, 0, 0]


