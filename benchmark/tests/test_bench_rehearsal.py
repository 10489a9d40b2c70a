"""Each cell rehearsed at a tiny size: on the CPU the command fails
cleanly ("no card") and prints no result, and the rest of a run (set-up,
window, comparison with the reference) runs on the CPU, comes out
correct, and comes out not correct with the timed path broken
underneath: the answers altered where they are produced (every pose a
step or solve returns turned by 0.01 rad), half of a batch left out (its
lanes repeat the others'), a solve that returns its state unchanged. The
faults run on every cell whose kind's ``FAULT_TARGET`` names the port
function they wrap."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_mod, spec as spec_mod
from benchmark.tests._tiny import all_cells, cells_faulted_in, tiny_cell

CELLS = all_cells()
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_no_card_fails_cleanly(name):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=spec_mod.ROOT, capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(spec_mod.ROOT),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def _run(name, seconds=1.0, trace=False):
    res, checks = cell_mod.run_cell(tiny_cell(name), 2**33 + 17, seconds, trace,
                                    torch.device("cpu"), time.perf_counter())
    json.dumps(res)
    return res, checks


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct_on_the_cpu(name):
    res, checks = _run(name)
    assert list(res) == KEYS  # the checks come last
    assert res["correct"] and checks and res["failed"] == 0 and res["attempted"] > 0
    cell = spec_mod.cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(cell.limits)


def _rotate(T: torch.Tensor, rad: float) -> torch.Tensor:
    c, s = np.cos(rad), np.sin(rad)
    Rz = torch.tensor([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                      dtype=T.dtype, device=T.device)
    return Rz @ T


def _faulty_vo_step(monkeypatch, fault):
    from epivo_tpu_torch.pipeline import vo

    real = vo.vo_step_batched

    def broken(img0, img1, *a, **k):
        res = real(img0, img1, *a, **k)
        if fault == "altered":
            return res._replace(T=_rotate(res.T, 0.01))
        h = res.T.shape[0] // 2  # half of the batch left out: its lanes repeat the others'
        return vo.VOStepResult(*(torch.cat([f[:res.T.shape[0] - h], f[:h]]) for f in res))

    monkeypatch.setattr(vo, "vo_step_batched", broken)


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
@pytest.mark.parametrize("name", cells_faulted_in("vo_step_batched"))
def test_offline_faults_fail(monkeypatch, name, fault):
    _faulty_vo_step(monkeypatch, fault)
    res, _ = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", cells_faulted_in("ba_windows"))
def test_ba_faults_fail(monkeypatch, name, fault):
    from epivo_tpu_torch.pipeline import ba

    real = ba.ba_windows

    def broken(T0s, *a, **k):
        out = real(T0s, *a, **k)
        T = out.T_opt.clone()
        if fault == "unchanged":
            T = T0s.clone()
        elif fault == "half_batch":
            T[T.shape[0] // 2:] = T0s[T.shape[0] // 2:]
        else:
            T = _rotate(T, 0.01)
        return out._replace(T_opt=T)

    monkeypatch.setattr(ba, "ba_windows", broken)
    res, _ = _run(name)
    assert not res["correct"], res["checks"]
