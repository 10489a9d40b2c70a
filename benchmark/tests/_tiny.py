"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
rehearsals: a 96x256 camera, 64 keypoints, 32 hypotheses, a few frames,
4-lane batches and 16-window calls."""

from __future__ import annotations

import copy

from benchmark.harness import spec as spec_mod

def all_cells() -> list[str]:
    return [w["name"] for w in spec_mod.load_spec()["workloads"]]


def tiny_cell(name: str, limits: dict | None = None) -> spec_mod.Cell:
    c = spec_mod.cell(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["camera"].update(width=256, height=96, cx=128.0, cy=48.0)
    if "frontend" in cfg:
        cfg["frontend"]["max_keypoints"] = 64
        cfg["ransac"]["n_hyp"] = 32
        tr.update(frames_rendered=5)
    if tr["kind"] == "vo_runner":
        tr.update(stream_frames=9, batch=4, check_calls=1, warmup_calls=1)
    if tr["kind"] == "ba_windows":
        tr.update(windows_per_call=16, window_sets=2, warmup_calls=1)
    return spec_mod.Cell(name=c.name, chips=1, config=cfg, traffic=tr,
                         end_to_end=c.end_to_end, per_layer=c.per_layer,
                         limits=c.limits if limits is None else limits)
