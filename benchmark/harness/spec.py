"""``BENCHMARK.json`` and the files its names lead to."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "benchmark"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with what its names lead to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the metric entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1
    limits: dict


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def config_path(name: str, spec: dict, root: Path = ROOT) -> Path:
    (entry,) = [c for c in spec["configs"] if c["name"] == name]
    return root / entry["file"]


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def limits_path(cell: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "limits" / f"{cell}.json"


def cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError for a name
    it does not hold."""
    spec = spec or load_spec(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    read = lambda p: json.loads(p.read_text())
    return Cell(
        name=name, chips=int(w["chips"]),
        config=read(config_path(w["config"], spec, root)),
        traffic=read(traffic_path(w["traffic"], root)),
        end_to_end=tuple(m for m in spec["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if _applies(m, name)),
        limits=read(limits_path(name, root)),
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    path = metric_path(metric, root)
    mod_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
