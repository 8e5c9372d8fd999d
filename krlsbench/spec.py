"""Find a cell's configuration, traffic mix and metric readers by name.

``BENCHMARK.json`` names everything; the files live beside this module:
``configs/<file>`` (the path the configuration's entry gives),
``traffic/<traffic>.json`` (whose ``kind`` names ``kinds/<kind>.py``, the
loop and check of that kind of traffic), ``recipes/<recipe>.py`` (the data
a configuration's ``data`` names) and ``metrics/<metric>.py``. A metric
named ``<base>.<variant>`` without a file of its own is read by
``metrics/<base>.py``: one quantity split by route or by the end-to-end
metric it moves keeps one reader. Adding a cell, a mix, a kind of traffic,
a data recipe or a metric adds files and entries and edits no code. A name
that has no file is refused.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


class SpecError(ValueError):
    """A name in ``BENCHMARK.json`` that the benchmark cannot resolve."""


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str                      # "end_to_end" or "per_layer"
    read: Callable                 # read(run) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[Metric]


def load_benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} not found")
    return json.loads(path.read_text())


def _named(name: str, what: str) -> str:
    if not name or "/" in name or name.startswith(".") or "\\" in name:
        raise SpecError(f"bad {what} name {name!r}")
    return name


def load_module(folder: str, name: str, what: str):
    """The module ``<folder>/<name>.py`` beside this one, loaded once."""
    path = HERE / folder / f"{_named(name, what)}.py"
    if not path.is_file():
        raise SpecError(f"no {what} file {path} for {name!r}")
    key = f"krlsbench.{folder}.{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def load_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``, or of ``metrics/<base>.py`` for
    a ``<base>.<variant>`` that has no file of its own."""
    base = name.split(".")[0]
    if base != name and not (HERE / "metrics" / f"{name}.py").is_file():
        name = base
    return load_module("metrics", name, "metric").read


def load_traffic(name: str) -> dict:
    """The mix ``traffic/<name>.json``, whose ``kind`` must have a file."""
    path = HERE / "traffic" / f"{_named(name, 'traffic')}.json"
    if not path.is_file():
        raise SpecError(f"no traffic mix {path} for {name!r}")
    traffic = json.loads(path.read_text())
    load_module("kinds", traffic["kind"], "traffic kind")
    return traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path) -> Cell:
    """The cell ``name`` of ``bench``, with its files loaded."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"unknown workload {name!r}; known: "
                        f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    configs: Dict[str, dict] = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"unknown config {w['config']!r}")
    cfg_path = (root / configs[w["config"]]["file"]).resolve()
    if HERE not in cfg_path.parents or not cfg_path.is_file():
        raise SpecError(f"config file {cfg_path} is not a file under {HERE}")
    config = json.loads(cfg_path.read_text())
    metrics = [Metric(m["name"], m["unit"], kind, load_reader(m["name"]))
               for kind in ("end_to_end", "per_layer")
               for m in bench[kind] if applies(m, name)]
    return Cell(name, int(w["chips"]), config,
                load_traffic(w["traffic"]), metrics)
