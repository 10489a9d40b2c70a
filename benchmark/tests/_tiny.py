"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
rehearsals: a 96x256 camera, and for a two-view configuration 64
keypoints, 32 hypotheses and a few frames; the traffic takes its kind's
own ``REHEARSAL`` overrides (a few frames in 4-lane batches, 16-window
calls)."""

from __future__ import annotations

import copy
import importlib

from benchmark.harness import spec as spec_mod


# The port functions whose faults ``test_bench_rehearsal.py`` plants: a
# kind's ``FAULT_TARGET`` names one of them.
FAULT_TARGETS = ("vo_step_batched", "ba_windows")


def kind_module(kind: str):
    """The module of ``benchmark.harness.kinds`` that drives ``kind``."""
    return importlib.import_module(f"benchmark.harness.kinds.{kind}")


def all_cells() -> list[str]:
    return [w["name"] for w in spec_mod.load_spec()["workloads"]]


def cells_faulted_in(target: str) -> list[str]:
    """The cells whose kind's faults wrap the port function ``target``."""
    return [n for n in all_cells()
            if kind_module(spec_mod.cell(n).traffic["kind"]).FAULT_TARGET == target]


def tiny_cell(name: str, limits: dict | None = None) -> spec_mod.Cell:
    c = spec_mod.cell(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["camera"].update(width=256, height=96, cx=128.0, cy=48.0)
    if "frontend" in cfg:
        cfg["frontend"]["max_keypoints"] = 64
        cfg["ransac"]["n_hyp"] = 32
        tr.update(frames_rendered=5)
    tr.update(kind_module(tr["kind"]).REHEARSAL)
    return spec_mod.Cell(name=c.name, chips=1, config=cfg, traffic=tr,
                         end_to_end=c.end_to_end, per_layer=c.per_layer,
                         limits=c.limits if limits is None else limits)
