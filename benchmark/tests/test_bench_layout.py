"""The benchmark is driven by data: every name in ``BENCHMARK.json`` leads
to a file of its own, a new cell, and a new kind of traffic, configuration
and motion with it, need only new files and entries, and the file keeps to
the contract's names and limits."""

import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import kinds as kinds_pkg, spec as spec_mod
from benchmark.tests._tiny import FAULT_TARGETS, kind_module, tiny_cell

SPEC = spec_mod.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
KINDS = sorted(m.name for m in pkgutil.iter_modules(kinds_pkg.__path__)
               if not m.name.startswith("_"))


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


@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_keeps_the_contract(kind):
    mod = kind_module(kind)
    assert callable(mod.Driver)
    assert isinstance(mod.REHEARSAL, dict) and isinstance(mod.CONTROL, dict)
    assert mod.FAULT_TARGET in FAULT_TARGETS


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = spec_mod.cell(name)
    assert cell.traffic["kind"] in KINDS
    assert cell.config["name"] == [w for w in SPEC["workloads"] if w["name"] == name][0]["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec_mod.reader(m["name"]))
        # Each listed cell reports the end-to-end metric the metric moves.
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert cell.limits, f"limits/{name}.json holds no limit"


def _checkout_copy(tmp_path):
    """A copy of the benchmark's files, and their bytes as copied."""
    root = tmp_path / "checkout"
    shutil.copytree(spec_mod.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def _add_cell(root, name: str, config: str, traffic: str, traffic_params: dict,
              metric: str, new_config: dict | None = None):
    """Adds the cell ``name`` to the copy at ``root`` as new files and
    entries only: its traffic, kitti00_vo.offline_b32's limits, a
    per-layer metric read from the step's busy time, its configuration
    where ``new_config`` is given, and its name under ``pairs_per_s``."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if new_config is not None:
        (bench / f"configs/{config}.json").write_text(json.dumps(new_config))
        spec["configs"].append({"name": config,
                                "source": "https://projects.asl.ethz.ch/datasets/doku.php"
                                          "?id=kmavvisualinertialdatasets",
                                "file": f"benchmark/configs/{config}.json", "reduced": [],
                                "why": "a slow camera"})
    (bench / f"traffic/{traffic}.json").write_text(json.dumps(traffic_params))
    (bench / f"limits/{name}.json").write_text(
        (bench / "limits/kitti00_vo.offline_b32.json").read_text())
    (bench / f"metrics/{metric}.py").write_text("def read(t):\n    return t.busy_per_call_ms()\n")
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": 1, "why": "a new cell"})
    spec["end_to_end"][0]["workloads"].append(name)
    spec["per_layer"].append({"name": metric, "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "step",
                              "moves": "pairs_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def _changed(before: dict) -> list:
    """The files of the copy, other than ``BENCHMARK.json``, that differ
    from their bytes as copied."""
    return [p for p, b in before.items() if p.name != "BENCHMARK.json" and p.read_bytes() != b]


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root, before = _checkout_copy(tmp_path)
    offline_b32 = json.loads((root / "benchmark/traffic/offline_b32.json").read_text())
    _add_cell(root, "kitti00_vo.offline_b8", "kitti00_vo", "offline_b8",
              dict(offline_b32, batch=8), "step_device_ms.offline_b8")
    cell = spec_mod.cell("kitti00_vo.offline_b8", root=root)
    assert cell.traffic["batch"] == 8
    assert [m["name"] for m in cell.per_layer] == ["step_device_ms.offline_b8"]
    assert spec_mod.reader("step_device_ms.offline_b8", root=root) is not None
    assert _changed(before) == []


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_takes_its_kinds_rehearsal(name):
    traffic = spec_mod.cell(name).traffic
    rehearsal = kind_module(traffic["kind"]).REHEARSAL
    tiny = tiny_cell(name)
    assert {k: tiny.traffic[k] for k in rehearsal} == rehearsal
    rest = lambda tr: {k: v for k, v in tr.items()
                       if k not in rehearsal and k != "frames_rendered"}
    assert rest(tiny.traffic) == rest(traffic)
    assert (tiny.config["camera"]["width"], tiny.config["camera"]["height"]) == (256, 96)


NEW_KIND = '''"""A new kind: the offline runner at sizes of its own."""

from benchmark.harness.kinds import vo_runner

REHEARSAL = dict(stream_frames=7, batch=3, check_calls=1, warmup_calls=1)
CONTROL = dict(stream_frames=33, warmup_calls=1, check_calls=1)
FAULT_TARGET = "vo_step_batched"


class Driver(vo_runner.Driver):
    pass
'''


def test_a_new_kind_needs_only_new_files_and_entries(tmp_path):
    """A kind, a two-view configuration with a motion of its own (EuRoC
    MH_01's camera and pace), its traffic, limits and a per-layer metric
    enter a copy of the checkout as new files and entries; the copy's own
    layout and rehearsal tests, run in a process rooted at the copy, take
    the new cell, and it rehearses correct on the CPU."""
    root, before = _checkout_copy(tmp_path)
    bench = root / "benchmark"
    read = lambda rel: json.loads((bench / rel).read_text())
    name = "mh01_like_vo.offline_b32_mav"
    (bench / "harness/kinds/vo_runner_mav.py").write_text(NEW_KIND)
    cfg = read("configs/kitti00_vo.json")
    cfg.update(name="mh01_like_vo", frame_rate_hz=20,
               camera={"fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375,
                       "width": 752, "height": 480},
               motion={"speed": 0.022, "yaw_rate": 0.01})
    cfg["frontend"]["fast_threshold"] = 20.0
    cfg["ransac"].update(method="ransac", threshold_px=0.3)
    _add_cell(root, name, "mh01_like_vo", "offline_b32_mav",
              dict(read("traffic/offline_b32.json"), kind="vo_runner_mav"),
              "step_device_ms.offline_mav", new_config=cfg)

    cell = spec_mod.cell(name, root=root)
    assert cell.traffic["kind"] == "vo_runner_mav" and cell.config["motion"]["speed"] == 0.022
    assert [m["name"] for m in cell.per_layer] == ["step_device_ms.offline_mav"]
    tests = bench / "tests"
    nodes = [f"{tests}/test_bench_layout.py::test_every_kind_keeps_the_contract[vo_runner_mav]",
             f"{tests}/test_bench_layout.py::test_every_cell_finds_its_files_by_name[{name}]",
             f"{tests}/test_bench_layout.py::test_tiny_cell_takes_its_kinds_rehearsal[{name}]",
             f"{tests}/test_bench_rehearsal.py::test_a_tiny_run_is_correct_on_the_cpu[{name}]",
             f"{tests}/test_bench_rehearsal.py::test_offline_faults_fail[{name}-altered]"]
    # The copy's benchmark first, the port from this checkout.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(spec_mod.ROOT)]))
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", *nodes], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and f"{len(nodes)} passed" in out.stdout, out.stdout[-4000:]
    assert _changed(before) == []


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec_mod.cell("no.such_cell")
