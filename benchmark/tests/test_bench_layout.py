"""The benchmark is driven by data: every name in ``BENCHMARK.json`` leads
to a file of its own, a new cell needs only new files and entries, and
the file keeps to the contract's names and limits."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec as spec_mod

SPEC = spec_mod.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (spec_mod.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = spec_mod.cell(name)
    assert cell.traffic["kind"] in ("vo_runner", "ba_windows")
    assert cell.config["name"] == [w for w in SPEC["workloads"] if w["name"] == name][0]["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec_mod.reader(m["name"]))
        # Each listed cell reports the end-to-end metric the metric moves.
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert cell.limits, f"limits/{name}.json holds no limit"


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec_mod.BENCH, root / "benchmark")
    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark/traffic/offline_b8.json").write_text(json.dumps(
        dict(json.loads((root / "benchmark/traffic/offline_b32.json").read_text()), batch=8)))
    (root / "benchmark/limits/kitti00_vo.offline_b8.json").write_text(
        (root / "benchmark/limits/kitti00_vo.offline_b32.json").read_text())
    (root / "benchmark/metrics/step_device_ms.offline_b8.py").write_text(
        "def read(t):\n    return t.busy_per_call_ms()\n")
    spec["workloads"].append({"name": "kitti00_vo.offline_b8", "config": "kitti00_vo",
                              "traffic": "offline_b8", "chips": 1, "why": "batch 8"})
    spec["end_to_end"][0]["workloads"].append("kitti00_vo.offline_b8")
    spec["per_layer"].append({"name": "step_device_ms.offline_b8", "unit": "ms",
                              "better": "lower", "source": "device_trace", "layer": "step",
                              "moves": "pairs_per_s", "workloads": ["kitti00_vo.offline_b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = spec_mod.cell("kitti00_vo.offline_b8", root=root)
    assert cell.traffic["batch"] == 8
    assert [m["name"] for m in cell.per_layer] == ["step_device_ms.offline_b8"]
    assert spec_mod.reader("step_device_ms.offline_b8", root=root) is not None
    changed = [p for p, b in before.items() if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec_mod.cell("no.such_cell")
