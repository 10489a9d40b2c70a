"""Port parity: multi-process launch (``parallel/multihost.py``) and the
world-size-1 contract of every runner that takes a mesh.

- ``host_window_range`` against the JAX package's over a grid of (W, n,
  pid): equal (it is pure, and runs here in-process);
- ``global_window_arrays`` on 3 gloo ranks whose blocks differ in size:
  every rank gets every block, in rank order;
- ``_test_worker`` on 2 processes, with the asserts of the reference's
  ``tests/test_multihost.py``: the psum exact, the trajectory finite and of
  W*2+1 poses, the replicated results bit-equal across the processes;
- at a world size of 1 (one gloo rank), every runner with ``mesh=`` is
  bit-equal to ``mesh=None``: ``run_vo_sequence``, ``run_ba_sequence``
  (global polish on), ``run_stereo_ba_sequence``, ``prepare_mono_windows``,
  ``_extract_pairs``, ``_solve_windows``, ``refine_global`` and
  ``global_ba_solve``, on a 7-frame 96x128 corridor.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from epivo_tpu.parallel import multihost as jmultihost
from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.parallel import multihost
from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, GlobalBAConfig,
                                             LMConfig, RansacConfig, VOConfig)
from epivo_tpu_torch.tools import mesh_checks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_host_window_range_matches_reference(n):
    for W in range(0, 18):
        got = [multihost.host_window_range(W, pid, n) for pid in range(n)]
        want = [jmultihost.host_window_range(W, pid, n) for pid in range(n)]
        assert got == want
        assert got[0][0] == 0 and got[-1][1] == W
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_global_window_arrays_uneven_blocks():
    outs = multihost.spawn(mesh_checks.window_arrays, 3, 7)
    assert [o[0] for o in outs] == [(0, 3), (3, 5), (5, 7)]
    w = np.arange(7)
    for _, (vals, flags, ids) in outs:
        np.testing.assert_array_equal(ids, w)
        np.testing.assert_array_equal(vals, w[:, None, None] * np.ones((1, 2, 3), np.float32))
        assert vals.dtype == np.float32
        np.testing.assert_array_equal(flags, np.repeat((w % 2 == 0)[:, None], 4, axis=1))


def test_two_process_worker(tmp_path):
    port = multihost.free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, outs = [], []
    for pid in range(2):
        outs.append(str(tmp_path / f"out_{pid}.json"))
        log = open(tmp_path / f"log_{pid}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "epivo_tpu_torch.parallel.multihost", str(pid), "2",
             str(port), outs[-1]], env=env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT), log))
    for pid, (p, log) in enumerate(procs):
        rc = p.wait(timeout=120)
        log.close()
        assert rc == 0, (tmp_path / f"log_{pid}.txt").read_text()[-3000:]
    results = [json.load(open(o)) for o in outs]
    for r in results:
        assert r["n_devices"] == 2
        assert r["psum"] == r["psum_expect"]
        assert r["traj_finite"]
        assert r["traj_shape"][0] == 8 * 2 + 1  # W_global * n_zeta + 1
    # Replicated outputs agree across processes bit for bit.
    assert results[0]["traj_sum"] == results[1]["traj_sum"]
    assert results[0]["global_r_norm"] == results[1]["global_r_norm"]


H, W, F = 96, 128, 7
K = np.array([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1.0]])
CAM = Pinhole(fx=110.0, fy=110.0, cx=W / 2, cy=H / 2, width=W, height=H)
CFG = BAConfig(camera=CAM,
               frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=96, klt_levels=3),
               ransac=RansacConfig(n_hyp=64),
               lm=LMConfig(n_points=16, revert_r_norm=1e-2),
               global_ba=GlobalBAConfig(enabled=True, max_iters=4, cg_iters=8))
VO_CFG = VOConfig(camera=CAM, frontend=CFG.frontend, ransac=CFG.ransac, lm=CFG.lm)
R = "epivo_tpu_torch.pipeline.runners"


def _calls():
    frames, gt, _ = photoreal.corridor_sequence(F, H=H, W=W, K=K, speed=0.45, seed=11)
    frames = [np.asarray(f, np.float32) for f in frames]
    L, Rr, _, _, T_rig = photoreal.corridor_stereo_sequence(4, H=H, W=W, K=K, baseline=0.5,
                                                            speed=0.4, seed=1)
    pairs = [(i, i + 1) for i in range(F - 1)] + [(i + 1, i) for i in range(F - 1)]
    # Window tensors and a constraint graph from the one-device path.
    from epivo_tpu_torch.pipeline import runners

    mw = runners.prepare_mono_windows(list(frames), CFG, n_frames=F, device="cpu")
    win = (mw.T0s, mw.spec, mw.p, mw.p_t, mw.wreps, mw.pmask, CFG)
    zetas = mw.T0s.reshape(-1, 4, 4)[: F - 1]
    gz = torch.from_numpy(np.ascontiguousarray(zetas))
    reps = np.asarray([(i, i) for i in range(F - 1)] + [(i, i + 1) for i in range(F - 2)],
                      np.int32)
    rng = np.random.default_rng(0)
    gp = torch.from_numpy((rng.normal(0, 0.2, (len(reps), 8, 3)) + [0, 0, 1]).astype(np.float32))
    gpt = gp + 0.01
    return {
        "run_vo_sequence": dict(target=f"{R}:run_vo_sequence",
                                args=(list(frames), VO_CFG),
                                kwargs=dict(gt_poses=gt, batch=4), device_arg=True),
        "run_ba_sequence": dict(target=f"{R}:run_ba_sequence", args=(list(frames), CFG),
                                kwargs=dict(n_frames=F, batch=4), device_arg=True),
        "run_stereo_ba_sequence": dict(
            target=f"{R}:run_stereo_ba_sequence",
            args=([np.asarray(f) for f in L], [np.asarray(f) for f in Rr],
                  dataclasses.replace(CFG, global_ba=GlobalBAConfig())),
            kwargs=dict(T_rig=T_rig, n_frames=4, batch=4), device_arg=True),
        "prepare_mono_windows": dict(target=f"{R}:prepare_mono_windows",
                                     args=(list(frames), CFG), kwargs=dict(n_frames=F),
                                     device_arg=True),
        "_extract_pairs": dict(target=f"{R}:_extract_pairs",
                               args=(list(frames), pairs, VO_CFG, 0),
                               kwargs=dict(n_points=16, batch=4), device_arg=True),
        "_solve_windows": dict(target=f"{R}:_solve_windows", args=win, device_arg=True),
        "refine_global": dict(target=f"{R}:refine_global", args=(zetas, mw.pair_data, CFG),
                              device_arg=True),
        "global_ba_solve": dict(target="epivo_tpu_torch.parallel.global_ba:global_ba_solve",
                                args=(gz, reps, gp, gpt), kwargs=dict(max_span=2, max_iters=4,
                                                                      cg_iters=8)),
    }


@pytest.fixture(scope="module")
def world_one():
    calls = _calls()
    res = multihost.spawn(mesh_checks.calls_on_mesh, 1, (1, 1),
                          [dict(without_mesh=True, **c) for c in calls.values()])[0]
    return dict(zip(calls, res))


def _equal(a, b, path="result"):
    """Bit-equality of two results (numpy arrays, numbers, containers)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if not (isinstance(k, str) and k.endswith("_s")):  # wall seconds
                _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("runner", ["run_vo_sequence", "run_ba_sequence",
                                    "run_stereo_ba_sequence", "prepare_mono_windows",
                                    "_extract_pairs", "_solve_windows", "refine_global",
                                    "global_ba_solve"])
def test_world_size_one_is_bit_equal(world_one, runner):
    single, (meshed,) = world_one[runner]
    _equal(meshed, single)
