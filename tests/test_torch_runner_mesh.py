"""Port parity: the sequence runners with ``mesh=`` at 2 gloo ranks on the
CPU, on ``tests/test_runner_mesh.py``'s 180x240 rendered corridor (its
configuration; frames cut to fit the time).

- ``_extract_pairs`` with the pair batch over ``win`` = 2, and with the
  hypotheses over ``hyp`` = 2, against one rank with the same samples
  (the same generator): the median pose delta below 1e-2
  (``__graft_entry__.py:171``), the largest below 0.1, the number of
  bit-equal pairs printed;
- ``run_ba_sequence`` with ``mesh=`` at 2 ranks: ATE below 0.5 for both
  paths (``tests/test_runner_mesh.py:59``);
- ``run_vo_sequence`` with ``mesh=`` at 2 ranks, with a metrics file and
  checkpoints: ATE below 0.5 (``tests/test_runner_mesh.py:131``), and one
  metrics line per batch: only rank 0 writes;
- ``mesh_checks.card_check`` (``chip_smoke.py``'s rank program) at 2 ranks
  on a few pairs and windows: the lanes of each step its extraction ran,
  its launch counts read from that run (none on the CPU, where the
  wrappers run their plain versions), the collectives it ran (gloo, CPU
  tensors), and replicated results equal on both ranks.

The ranks run ``epivo_tpu_torch/tools/mesh_checks.py::call_on_mesh``
(one torch thread each), the mesh and the one-rank call in the same rank.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.parallel import multihost
from epivo_tpu_torch import ransac
from epivo_tpu_torch.pipeline import ba, runners
from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, GlobalBAConfig,
                                             LMConfig, RansacConfig, VOConfig)
from epivo_tpu_torch.tools import mesh_checks

torch.set_num_threads(1)

H, W = 180, 240
K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]])
CAM = Pinhole(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W, height=H)
CFG = BAConfig(camera=CAM,
               frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=256, klt_levels=3),
               ransac=RansacConfig(n_hyp=256),
               lm=LMConfig(n_points=32, revert_r_norm=1e-2))
VO_CFG = VOConfig(camera=CAM, frontend=CFG.frontend, ransac=CFG.ransac, lm=CFG.lm)
R = "epivo_tpu_torch.pipeline.runners"


def _frames(F, seed):
    frames, gt, _ = photoreal.corridor_sequence(F, H=H, W=W, K=K, speed=0.5, seed=seed)
    return [np.asarray(f, np.float32) for f in frames], gt


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_extract_pairs_mesh_matches_one_rank(shape):
    F = 8
    frames, _ = _frames(F, 3)
    pairs = ([(i, i + 1) for i in range(F - 1)] + [(i, i + 2) for i in range(F - 2)]
             + [(b, b - 1) for b in range(1, F)])
    outs = multihost.spawn(mesh_checks.call_on_mesh, 2, f"{R}:_extract_pairs", shape,
                           (frames, pairs, VO_CFG, 0), dict(n_points=32, batch=8),
                           "mesh", True, 1, True)
    single, (meshed,) = outs[0]
    assert set(meshed) == set(single) == set(pairs)
    dTs = sorted(float(np.abs(meshed[k]["T"] - single[k]["T"]).max()) for k in pairs)
    equal = sum(all(np.array_equal(meshed[k][f], single[k][f]) for f in single[k])
                for k in pairs)
    print(f"mesh {shape}: {equal} of {len(pairs)} pairs bit-equal to one rank, "
          f"median pose delta {dTs[len(dTs) // 2]:.3g}, largest {dTs[-1]:.3g}")
    assert dTs[len(dTs) // 2] < 1e-2 and dTs[-1] < 0.1, dTs
    # Both ranks hold the same pairs.
    for k in pairs:
        for f, v in outs[1][1][0][k].items():
            np.testing.assert_array_equal(v, meshed[k][f])


def test_ba_sequence_mesh_accuracy():
    F = 9  # 4 windows, 2 per rank
    frames, gt = _frames(F, 2)
    outs = multihost.spawn(mesh_checks.call_on_mesh, 2, f"{R}:run_ba_sequence", (2, 1),
                           (frames, CFG), dict(gt_poses=gt, seed=0, n_frames=F),
                           "mesh", True, 1, True)
    single, (meshed,) = outs[0]
    d = float(np.abs(meshed.trajectory - single.trajectory).max())
    print(f"ATE one rank {single.ate:.4f}, 2 ranks {meshed.ate:.4f}; largest trajectory "
          f"difference {d:.3g}")
    assert single.ate < 0.5 and meshed.ate < 0.5, (single.ate, meshed.ate)
    assert meshed.stats["n_windows"] == single.stats["n_windows"] == 4
    np.testing.assert_array_equal(outs[1][1][0].trajectory, meshed.trajectory)


def test_vo_sequence_mesh_rank0_writes(tmp_path):
    F = 9  # 8 pairs: two batches of 4, 2 per rank
    frames, gt = _frames(F, 4)
    vo_cfg = VOConfig(camera=CAM, frontend=CFG.frontend, ransac=CFG.ransac,
                      lm=LMConfig(n_points=32))
    mpath = tmp_path / "metrics.jsonl"
    outs = multihost.spawn(mesh_checks.call_on_mesh, 2, f"{R}:run_vo_sequence", (2, 1),
                           (frames, vo_cfg),
                           dict(gt_poses=gt, batch=4, collect_cloud=False,
                                metrics_path=str(mpath), checkpoint_dir=str(tmp_path / "ck"),
                                checkpoint_every=4), "mesh", True)
    res = outs[0][0]
    print(f"ATE 2 ranks {res.ate:.4f}")
    assert res.ate < 0.5 and res.trajectory.shape == (F, 4, 4)
    np.testing.assert_array_equal(outs[1][0].trajectory, res.trajectory)
    assert len(mpath.read_text().splitlines()) == 2
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "LATEST", "ckpt_00000004.npz", "ckpt_00000008.npz"]


def test_card_check_on_cpu():
    F = 6
    frames, _ = _frames(F, 3)
    pairs = [(i, i + 1) for i in range(F - 1)] + [(i, i + 2) for i in range(F - 2)]
    single = runners._extract_pairs(frames, pairs, VO_CFG, 0, n_points=32, batch=4,
                                    device="cpu")
    zetas = np.stack([single[(i, i + 1)]["T"] for i in range(F - 1)]).astype(np.float32)
    z = np.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "bench_ba_workload.npz"))
    ba_cfg = BAConfig(lm=LMConfig(n_points=32, max_iters=30, revert_r_norm=1e-2),
                      window_size=3, stride=2)
    ba_in = (*(z[k][:4] for k in ("T0s", "p", "p_t", "wreps", "pmask")),
             ba.mono_window_spec(3), ba_cfg)
    e = single[(0, 1)]
    samples = ransac._sample_indices(torch.Generator().manual_seed(0), 64,
                                     e["p_full"].shape[0], torch.from_numpy(e["mask_full"]))
    ransac_in = (e["p_full"], e["p_t_full"], e["mask_full"], samples.numpy(), 1e-5)
    gcfg = dataclasses.replace(CFG, global_ba=GlobalBAConfig(enabled=True))
    outs = multihost.spawn(mesh_checks.card_check, 2, frames, pairs, VO_CFG,
                           dict(n_points=32, batch=4), ba_in, zetas, single, gcfg, ransac_in)
    zero = {"fast": 0, "fast_cand": 0, "klt_level": 0, "extract": 0, "lk": 0,
            "orb_describe": 0}
    for r in outs:
        la = r["launches"]
        # 9 pairs in calls of 4, 4 and 1: each rank steps 2, 2 and 1 lanes.
        assert la["step_lanes"] == [2, 2, 1] and la["klt"] == la["retry"] == zero, la
        n_r = len(r["retried"])
        assert la["retry_lanes"] == [-(-min(4, n_r - c) // 2) for c in range(0, n_r, 4)]
        assert r["backend"] == "gloo" and set(r["collectives"]) >= {
            "all_gather/gloo/cpu", "all_reduce/gloo/cpu"}, r["collectives"]
        assert all(k.endswith("/cpu") for k in r["collectives"])
    r0, r1 = outs
    assert set(r0["pairs"]) == set(single) and set(r1["pairs"]) == set(single)
    for k in pairs:
        for f, v in r0["pairs"][k].items():
            np.testing.assert_array_equal(r1["pairs"][k][f], v)
    dTs = sorted(float(np.abs(r0["pairs"][k]["T"] - single[k]["T"]).max()) for k in pairs)
    assert dTs[len(dTs) // 2] < 1e-2, dTs
    for a, b in zip(r0["ba"], r1["ba"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r0["global"][0][0], r0["global"][1][0])
    np.testing.assert_array_equal(r0["ransac"].E, r1["ransac"].E)
