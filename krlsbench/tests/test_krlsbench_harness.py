"""The harness on the CPU: names resolved from files alone, the import
guard, the end-to-end arithmetic, the trace reduction, a run without a
card, and a whole run at a tiny size."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from krlsbench import loop, readings, roofline, run, spec, trace
from krlsbench.tests.conftest import ROOT, tiny_cell

PY = sys.executable


def _python(code: str, cwd=ROOT, timeout=300):
    return subprocess.run([PY, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_forbidden_names_compare_the_top_level_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bigkrls_tpu_torch_x", types.ModuleType("x"))
    assert "bigkrls_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jaxlib.fake"]


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program():
    code = (
        "import sys, time, krlsbench.tests.conftest as c\n"
        "from krlsbench import run\n"
        "for m in ('election-dense.fit', 'election-dense.predict'):\n"
        "    cell = c.tiny_cell(m, n=120, p=4, pool=2)\n"
        "    assert run.execute(cell, 5, 0.3, True, 'cpu', time.time()) is not None\n"
        "print(run.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    ref = _python("import sys, krlsbench.reference.krls, krlsbench.check\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert ref.returncode == 0, ref.stderr[-3000:]
    tops = json.loads(ref.stdout.strip().replace("'", '"'))
    assert not {"bigkrls_tpu_torch", "bigkrls_tpu", "jax"} & set(tops)


NEW_KIND = """
import time

from krlsbench import data, loop as loops


class Loop:
    kind = "refit"

    def __init__(self, program, config, traffic, seed, device, precision,
                 chips):
        self.y, self.X = data.dataset(config, seed, 0)

    def warm_up(self):
        pass

    def job(self, index):
        time.sleep(0.001)
        return loops.Job(index, 0.001, time.perf_counter() - 0.001, {}, None,
                         {"rows": len(self.y), "sum": float(self.X.sum())}, 0)


def check(loop, jobs, config, traffic, seed, device):
    return {"rows": float(jobs[0].out["rows"])}
"""


def test_new_files_are_found_by_name_and_unknown_names_refused(tmp_path):
    shutil.copytree(ROOT / "krlsbench", tmp_path / "krlsbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    kb = tmp_path / "krlsbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "krlsbench/configs/election-dense.json")
                     .read_text())
    # a configuration with a data recipe of its own, a mix of a kind of its
    # own, a mix of an existing kind, and a metric: files only
    (kb / "recipes/ones.py").write_text(
        "import numpy as np\n\n\ndef make(rng, n, p, level=1.0):\n"
        "    return np.full(n, level), np.full((n, p), level)\n")
    (kb / "configs/tiny.json").write_text(json.dumps(dict(
        cfg, name="tiny", n=50, p=3, data={"recipe": "ones", "level": 2.0},
        limits={"refit": {"rows": 50}})))
    (kb / "kinds/refit.py").write_text(NEW_KIND)
    (kb / "traffic/refit.json").write_text(
        json.dumps({"kind": "refit", "check": 1}))
    (kb / "traffic/burst.json").write_text(
        json.dumps({"kind": "fit", "warmup": 0, "check": 1}))
    (kb / "traffic/nokind.json").write_text(json.dumps({"kind": "absent"}))
    (kb / "metrics/jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.window.jobs))\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="krlsbench/configs/tiny.json"))
    for traffic in ("refit", "burst", "nothing", "nokind"):
        bench["workloads"].append({"name": f"tiny.{traffic}",
                                   "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "fit_s",
                               "workloads": ["tiny.refit", "tiny.burst"]})
    bench["end_to_end"][0]["workloads"] += ["tiny.refit", "tiny.burst"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        f"sys.path.append({str(ROOT)!r})  # the program, not the benchmark\n"
        "from pathlib import Path\n"
        "from krlsbench import data, run, spec\n"
        "b = spec.load_benchmark(Path('.'))\n"
        "c = spec.cell(b, 'tiny.refit', Path('.'))\n"
        "print(c.config['n'], c.traffic['check'],"
        " [m.name for m in c.metrics])\n"
        "r = run.execute(c, 3, 0.05, False, 'cpu', time.time(),"
        " log=lambda s: None)\n"
        "print(r['correct'], r['checks'], r['metrics']['fit_s']['value'] > 0)\n"
        "print(data.dataset(c.config, 1, 0)[1][0].tolist())\n"
        "print(spec.cell(b, 'tiny.burst', Path('.')).traffic['kind'])\n"
        "for bad in ('tiny.nothing', 'tiny.nokind', 'no.such'):\n"
        "    try:\n"
        "        spec.cell(b, bad, Path('.'))\n"
        "    except spec.SpecError as e:\n"
        "        print('refused', bad)\n"
        "try:\n"
        "    data.recipe('absent')\n"
        "except spec.SpecError:\n"
        "    print('refused recipe')\n")
    out = _python(code, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("50 1 [")
    assert "'jobs_done'" in lines[0] and "'setup_s'" in lines[0]
    assert lines[1] == "True {'rows': {'value': 50.0, 'limit': 50.0}} True"
    assert lines[2] == "[2.0, 2.0, 2.0]"
    assert lines[3] == "fit"
    assert lines[4:] == ["refused tiny.nothing", "refused tiny.nokind",
                         "refused no.such", "refused recipe"]


def test_every_metric_has_a_reader_and_moves_a_metric_its_cells_report():
    bench = spec.load_benchmark(ROOT)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"], ROOT)
        names = {m.name for m in cell.metrics}
        assert "setup_s" in names
        for m in bench["per_layer"]:
            if spec.applies(m, w["name"]):
                assert spec.applies(e2e[m["moves"]], w["name"])


def test_roofline_counts_from_shapes():
    ops, nbytes = roofline.k1_work(3106, 3106, 67)
    assert ops == 2 * 3106 * 3106 * 67
    assert nbytes == 4 * (2 * 3106 * 67 + 3106 * 3106)
    s, by = roofline.bound_s(ops, nbytes)
    assert by == "bytes" and s == pytest.approx(nbytes / 3.35e12)
    ops, nbytes = roofline.k2_work(50000, 50000, 20, 540)
    assert ops == 2 * 50000 * 50000 * 560
    s, by = roofline.bound_s(ops, nbytes)
    assert by == "operations" and s * 1e3 == pytest.approx(5.657, abs=1e-3)
    assert roofline.k2_work(10, 20, 3, 4, init=True)[1] == \
        4 * (30 + 60 + 80 + 80)
    assert roofline.share_pct([(0.0, 3.35e9)], 2e-3) == pytest.approx(50.0)
    assert roofline.share_pct([], 1.0) is None


def _window(latencies, seconds, traced=()):
    jobs = [loop.Job(i, lat, 0.0, {"summary": 0.001 * i},
                     [{"phase": "kernel", "seconds": 0.002}])
            for i, lat in enumerate(latencies)]
    return loop.Window(jobs, seconds, 0, [], [jobs[i] for i in traced])


def test_end_to_end_arithmetic_takes_every_job():
    lat = list(np.linspace(0.01, 1.0, 100))
    r = run.Run("c", "fit", 3.0, _window(lat, 40.0, traced=(0, 1)), 2 ** 31,
                None)
    assert spec.load_reader("fit_s")(r) == pytest.approx(0.4)
    assert spec.load_reader("fit_p95_s")(r) == \
        pytest.approx(np.percentile(lat, 95))
    assert spec.load_reader("predict_p95_ms")(r) == \
        pytest.approx(1e3 * np.percentile(lat, 95))
    assert spec.load_reader("fit_peak_gib")(r) == 2.0
    assert spec.load_reader("setup_s")(r) == 3.0
    assert spec.load_reader("phase_kernel_ms")(r) == pytest.approx(2.0)
    # the traced jobs 0 and 1 are left out of the per-layer means
    assert spec.load_reader("summary_ms")(r) == pytest.approx(
        np.mean(np.arange(2, 100)))
    assert spec.load_reader("k2_roofline")(r) is None
    assert spec.load_reader("phase_eig_ms")(r) is None
    # a metric split by route or by what it moves keeps its base's reader
    assert spec.load_reader("fit_s.streaming")(r) == pytest.approx(0.4)
    assert spec.load_reader("summary_ms.streaming")(r) == \
        spec.load_reader("summary_ms")(r)
    with pytest.raises(spec.SpecError):
        spec.load_reader("no_such_metric.fit")


def test_the_idle_share_is_over_the_untraced_time_of_the_same_work():
    # keys 0 and 1 alternate; key 1's jobs take three times as long
    lat = [0.01 if i % 2 == 0 else 0.03 for i in range(40)]
    w = _window(lat, 1.0, traced=(36, 37, 38, 39))
    for j in w.jobs:
        j.key = j.index % 2
    summ = types.SimpleNamespace(busy_s=0.02)
    r = run.Run("c", "fit", 1.0, w, 0, summ)
    # untraced, the traced jobs take 2 x 0.01 + 2 x 0.03 = 0.08 s
    assert readings.untraced_wall_s(r) == pytest.approx(0.08)
    assert spec.load_reader("device_idle_pct.fit")(r) == pytest.approx(75.0)
    assert spec.load_reader("device_idle_pct")(
        run.Run("c", "fit", 1.0, w, 0, None)) is None


class _Ev:
    """A raw profiler event (the accessors of ``_KinetoEvent``), its times
    given in microseconds from the trace's start."""
    T0 = 10 ** 12

    def __init__(self, name, a, b, cuda, card=0, note=False):
        import torch
        self._name, self._a, self._b, self._card = name, a, b, card
        self._note = note
        self._type = (torch.autograd.DeviceType.CUDA if cuda
                      else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def start_ns(self):
        return self.T0 + round(self._a * 1000)

    def end_ns(self):
        return self.T0 + round(self._b * 1000)

    def device_type(self):
        return self._type

    def device_index(self):
        return self._card

    def is_user_annotation(self):
        return self._note

    def is_hidden_event(self):
        return False


def _profiled(evs):
    """A stand-in for a stopped ``torch.profiler.profile`` that kept
    ``evs``."""
    result = types.SimpleNamespace(events=lambda: evs,
                                   trace_start_ns=lambda: _Ev.T0)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=result))


def test_trace_reduction_busy_idle_and_labels():
    t = trace.Tracer()
    t.works["k1"] = [roofline.k1_work(1000, 1000, 10)]
    evs = [_Ev("krlsbench.fit", 0, 100, False, note=True),
           _Ev("krlsbench.summary", 100, 120, False, note=True),
           _Ev("krlsbench.fit", 0, 100, True, note=True),  # no work
           _Ev("void gauss_tile_kernel<64, 64>(...)", 5, 15, True),
           _Ev("Memcpy HtoD", 10, 30, True),
           _Ev("ampere_sgemm", 60, 70, True),
           _Ev("late kernel", 115, 130, True)]
    t.prof = _profiled(evs)
    job = loop.Job(0, 1.2e-4, 0.0, {}, [{"phase": "kernel", "seconds": 4e-5},
                                        {"phase": "eigendecomposition",
                                         "seconds": 6e-5}])
    s = t.summary([job])
    assert s.window_s == pytest.approx(120e-6)
    assert s.busy_s == pytest.approx(40e-6)        # 5-30, 60-70, 115-120
    assert s.kernel_s["k1"] == pytest.approx(10e-6)
    gaps = dict(s.idle_gaps)
    # gaps 0-5, 30-60 and 70-115, each named by the phase at its middle
    assert gaps == pytest.approx({"fit/kernel": 5e-6,
                                  "fit/eigendecomposition": 75e-6})
    assert s.roofline_pct("k1") == pytest.approx(
        100 * roofline.bound_s(*roofline.k1_work(1000, 1000, 10))[0] / 10e-6)


def test_request_sizes_are_one_grid_in_a_seeded_order():
    traffic = json.loads((ROOT / "krlsbench/traffic/predict.json")
                         .read_text())
    grid = loop.kind(traffic).request_sizes(3106, traffic)
    assert grid.min() == 1 and 2900 < grid.max() <= 3106
    assert len(grid) == traffic["sizes"]
    cell = tiny_cell("election-dense.predict", n=200, p=4)
    a = loop.make(None, cell.config, traffic, 1, "cpu")
    b = loop.make(None, cell.config, traffic, 2, "cpu")
    assert sorted(a.sizes) == sorted(b.sizes)
    assert list(a.sizes) != list(b.sizes)
    np.testing.assert_array_equal(a.newdata(7), a.newdata(7))


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [PY, "-m", "krlsbench.run", "--workload", "election-dense.fit",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_tiny_run_end_to_end_on_the_cpu():
    for workload in ("election-dense.fit", "election-dense.predict"):
        cell = tiny_cell(workload, n=150, p=4, pool=2)
        res = run.execute(cell, 2 ** 31 + 11, 0.5, False, "cpu",
                          time.time(), log=lambda s: None)
        assert res["correct"] and res["failed"] == 0
        assert list(res)[-1] == "checks"
        assert set(res["checks"]) == set(cell.config["limits"][
            cell.traffic["kind"]])
        assert "setup_s" in res["metrics"]
