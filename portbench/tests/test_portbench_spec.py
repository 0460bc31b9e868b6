"""BENCHMARK.json and the files it names: every name resolves, names and
units keep to their characters, a new cell and metric need only new files,
and nothing the harness loads is JAX or the JAX package."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import spec  # noqa: E402

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"][:1] == ["python3"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", [*BENCH["configs"], *BENCH["workloads"],
                                   *BENCH["end_to_end"], *BENCH["per_layer"]],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


def test_metric_sources_moves_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_every_file(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    assert spec.load_module("drivers", cell.driver).run
    assert spec.load_module("reference", cell.config["reference"])
    assert set(cell.workload["limits"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_configs_are_their_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []


def test_a_pending_cell_resolves_from_its_workload_file():
    name = "pretrain_hymba_s128"
    assert name not in {w["name"] for w in BENCH["workloads"]}
    cell = spec.cell(name, spec.with_pending(name))
    assert spec.load_module("drivers", cell.driver).run
    assert spec.load_module("reference", cell.config["reference"])
    assert {"train_tokens_per_s", "setup_s"} <= {m["name"] for m in
                                                 cell.end_to_end}
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] == "train_tokens_per_s"
        assert callable(spec.load_module("metrics", m["name"]).read)
    # limits not yet set from sound runs are null: no run passes them
    unset = {k for k, v in cell.workload["limits"].items() if v is None}
    assert unset == {"loss_gap", "change_norm_gap"}


def _digest(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = _digest(tmp_path / "portbench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "fl_cnn_cohort50", "config": "paper_cnn",
        "traffic": "fl_mcmahan_c50_e1_b50", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({
        "name": "rounds.fl", "unit": "rounds", "better": "higher",
        "source": "host_clock", "layer": "FL round loop",
        "moves": "fl_samples_per_s", "workloads": ["fl_cnn_cohort50"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "fl_cnn_cohort100" in m["workloads"]:
            m["workloads"].append("fl_cnn_cohort50")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/traffic/"
                          "fl_mcmahan_c100_e5_b50.json").read_text())
    traffic.update(n_clients=50, n_local=1200, epochs=1)
    pb = tmp_path / "portbench"
    (pb / "traffic/fl_mcmahan_c50_e1_b50.json").write_text(json.dumps(traffic))
    (pb / "workloads/fl_cnn_cohort50.json").write_text(
        (ROOT / "portbench/workloads/fl_cnn_cohort100.json").read_text())
    (pb / "metrics/rounds.fl.py").write_text(
        "def read(ctx):\n    return ctx['rounds']\n")
    cell = spec.cell("fl_cnn_cohort50", root=tmp_path)
    assert cell.traffic["n_clients"] == 50
    assert "rounds.fl" in {m["name"] for m in cell.per_layer}
    assert "fl_samples_per_s" in {m["name"] for m in cell.end_to_end}
    reader = spec.load_module("metrics", "rounds.fl", root=tmp_path)
    assert reader.read({"rounds": 7}) == 7
    after = _digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


_LOADS_EVERYTHING = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import runpy
from pathlib import Path
from portbench.harness import check, profile, spec, traffic, yardstick
bench = spec.load_benchmark()
for w in bench["workloads"]:
    cell = spec.cell(w["name"])
    spec.load_module("drivers", cell.driver)
    spec.load_module("reference", cell.config["reference"])
for kind in ("drivers", "metrics"):
    for path in Path({root!r}, "portbench", kind).glob("*.py"):
        spec.load_module(kind, path.name[:-3])
import portbench.reference.coalition, portbench.reference.hymba
runpy.run_path({run!r}, run_name="portbench_run")
runpy.run_path({controls!r}, run_name="portbench_controls")
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""


def _top_level_modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_nothing_loaded_is_jax_or_the_jax_package():
    mods = _top_level_modules(_LOADS_EVERYTHING.format(
        src=str(ROOT / "src"), root=str(ROOT),
        run=str(ROOT / "portbench/run.py"),
        controls=str(ROOT / "portbench/controls.py")))
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods


def test_references_import_nothing_of_the_program():
    code = (f"import sys\nsys.path[:0] = [{str(ROOT)!r}]\n"
            "import portbench.reference.cnn, portbench.reference.hymba, "
            "portbench.reference.coalition\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    mods = _top_level_modules(code)
    assert not mods & {"repro_torch", "repro", "jax"}, mods
