"""One run of one cell: set-up, the measured window, the traced stretch,
and the comparison with the reference, in that order."""

from __future__ import annotations

import gc
import importlib
import time

import torch

from benchmark.harness import compare, spec as spec_mod


def driver(cell: spec_mod.Cell, seed: int, device: torch.device):
    kind = importlib.import_module(f"benchmark.harness.kinds.{cell.traffic['kind']}")
    return kind.Driver(cell, seed, device)


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": device.type, "kind": device.type, "count": 1, "memory_peak_bytes": 0}


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> tuple[dict, list]:
    """The result line's fields and the checks of one run. ``t_start`` is
    the process's start on the host clock, from which ``setup_s`` counts."""
    drv = driver(cell, seed, device)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    win = drv.window(seconds)
    dev = device_info(device)
    metrics = {}
    breakdown = None
    if trace:
        t = drv.traced()
        t.wall_per_call_s = win["wall_per_call_s"]
        for m in cell.per_layer:
            value = spec_mod.reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        breakdown = t.breakdown()
    else:
        found = dict(win["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(found[m["name"]]), "unit": m["unit"]}
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare.held(drv.check(), cell.limits)
    result = {"correct": bool(checks) and all(c.ok for c in checks),
              "attempted": int(win["attempted"]), "failed": int(win["failed"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks
