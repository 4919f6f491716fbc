"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, driver, limit file and per-layer reader is found by name, in
the form the benchmark's contract fixes; a cell or metric added as files
is found without editing any file that is there."""

import json
import os
import re
import shutil

import pytest

from benchmark.tests.bench_common import ALL_CELLS, ROOT, full_cell, spec
from benchmark.harness import checks

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in ALL_CELLS["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    bench = BENCH
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads") or cells) <= cells
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = full_cell(workload)
    assert cell.driver().run_window
    assert cell.traffic["driver"] and cell.limits
    assert "ate_m" in checks.limits(cell)
    assert any(m.name == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.readers[m.name].read)


def test_added_files_are_found(tmp_path):
    """A new metric and a new cell added as files only."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Driver (models/system)",
                               "moves": "frames_per_s"})
    w = dict(BENCH["workloads"][0], name="tum-fr1-mono.copy",
             traffic="replay-copy")
    bench["workloads"].append(w)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "metrics" / "frames_seen.py").write_text(
        "def read(td):\n    return td.frames\n")
    shutil.copy(root / "benchmark" / "traffic" / "replay.json",
                root / "benchmark" / "traffic" / "replay-copy.json")
    shutil.copy(root / "benchmark" / "limits" / "tum-fr1-mono.replay.json",
                root / "benchmark" / "limits" / "tum-fr1-mono.copy.json")
    cell = spec.cell("tum-fr1-mono.copy", root=str(root))
    assert cell.readers["frames_seen"].read(type("T", (), {"frames": 7})) == 7
    assert cell.traffic == spec.cell("tum-fr1-mono.replay").traffic


def test_unknown_workload_is_refused():
    with pytest.raises(spec.SpecError):
        spec.cell("no-such.cell")
