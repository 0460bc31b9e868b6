"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's sizes are in the file its entry names
(``configs/<config>.json``), the traffic's parameters and driver in
``traffic/<traffic>.json``, and the cell's comparison limits and check
sizes in ``workloads/<cell>.json``.  A driver is ``drivers/<driver>.py`` and
a per-layer metric's reader ``metrics/<metric>.py``; both are loaded from
their path, so adding a cell or a metric adds files and edits none.

A cell that BENCHMARK.json does not list yet (its program has a fault
that keeps its runs from being sound) keeps the entries it will add under
``pending`` in its workload file; :func:`with_pending` adds them, for its
tests and for reading the fault on the card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

#: the checkout's root (BENCHMARK.json, src/, portbench/)
ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell with everything its files say."""

    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` (default: the checkout's
    BENCHMARK.json) with its configuration, traffic and workload files."""
    spec = load_benchmark(root) if spec is None else spec
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "portbench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=read_json(root / configs[w["config"]]["file"]),
        traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
        workload=read_json(bench / "workloads" / f"{name}.json"),
        end_to_end=tuple(m for m in spec["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if _applies(m, name)))


def with_pending(name: str, root: Path = ROOT) -> dict:
    """BENCHMARK.json with the entries that ``workloads/<name>.json`` keeps
    under ``pending`` added."""
    spec = load_benchmark(root)
    extra = read_json(root / "portbench" / "workloads" / f"{name}.json")
    for key, entries in extra.get("pending", {}).items():
        spec[key] = [*spec[key], *entries]
    return spec


def load_module(kind: str, name: str, root: Path = ROOT):
    """``portbench/<kind>/<name>.py`` as a module of its own (a metric's
    name has dots, so it is loaded from its path, not imported)."""
    path = root / "portbench" / kind / f"{name}.py"
    mod_name = "portbench_" + kind + "_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
