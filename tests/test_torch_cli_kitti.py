"""Port parity: the KITTI CLI (``epivo_tpu_torch/tools/run_kitti.py``)
against the JAX package's (``scripts/run_kitti.py``) and against the
port's own runners, on a KITTI tree of PNGs written at small size
(``chip_smoke.kitti_tree``: the photoreal stereo corridor, 9 frames a
camera at 120x160, focal length 200 px, ``calib.txt`` from its K and rig,
``poses/00.txt`` from its ground truth).

- each mode (vo, ba, stereo, gt) through ``main([..., "--device", "cpu"])``:
  its trajectory bit-equal to the port's runner on the PNGs decoded into
  memory (``runtime.decode_png``; the CLI and the loader add nothing),
  the summary's values those of that run;
- each mode's artifact files, summary keys and config keys equal to the
  JAX CLI's on the same tree, and its ATE at most 1.5x the JAX CLI's:
  ``tests/test_torch_cli_kitti_ref.py`` (vo,
  gt) and ``tests/test_torch_cli_kitti_ref_ba.py`` (ba, stereo), split for
  time (the JAX CLI compiles each mode's step);
- ``--devices 2 --backend gloo`` (two CPU ranks) in ba mode: the ATE of
  the two-rank run and of one rank below 0.5 (``ROADMAP.md`` A14b's
  runner bound, ``tests/test_runner_mesh.py:59``);
- the errors: a missing sequence, ``--mode gt`` without poses, and a mesh
  that does not divide exit with status 2.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from epivo_tpu_torch import runtime
from epivo_tpu_torch.datasets import kitti, photoreal
from epivo_tpu_torch.pipeline import runners
from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, LMConfig,
                                             RansacConfig, VOConfig)
from epivo_tpu_torch.tools import run_kitti

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, F = 120, 160, 9
K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]])
# The CLI flags of every run: the frontend of tests/test_runner_mesh.py.
FLAGS = ["--fast-threshold", "12", "--max-keypoints", "256", "--n-hyp", "256",
         "--batch", "4"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    L, R, gt, _, T_rig = photoreal.corridor_stereo_sequence(F, H=H, W=W, K=K, speed=0.5,
                                                            seed=3)
    L, R = list(L), list(R)
    chip_smoke.kitti_tree(root, L, gt, K, right=R, T_rig=T_rig)
    return str(root)


def against_reference(tree, out_root, monkeypatch, mode) -> None:
    """The port's and the JAX package's CLI in ``mode`` on ``tree``: the
    same artifact files, summary keys and config values (but the
    platform, the torch device type here), and the port's ATE at most 1.5x
    the JAX CLI's (the repo's rule where the RANSAC draws differ: each
    package's ATE is one draw of its own stream)."""
    out = os.path.join(out_root, "port")
    _quiet(run_kitti.main, ["--root", tree, "--mode", mode, "--out", out, "--device", "cpu",
                            *FLAGS])
    spec = importlib.util.spec_from_file_location(
        "run_kitti_cli", os.path.join(REPO, "scripts", "run_kitti.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    ref_out = os.path.join(out_root, "jax")
    monkeypatch.setattr(sys, "argv", ["run_kitti.py", "--root", tree, "--mode", mode,
                                      "--out", ref_out, *FLAGS])
    _quiet(jax_cli.main)
    summary, ref = (_summary(d) for d in (out, ref_out))
    print(f"{mode}: port ATE {summary['ate_m']}, JAX CLI ATE {ref['ate_m']}")
    assert summary["ate_m"] <= 1.5 * ref["ate_m"], (summary["ate_m"], ref["ate_m"])
    assert _listing(out) == _listing(ref_out)
    assert set(summary) == set(ref) and set(summary["config"]) == set(ref["config"])
    assert summary["config"]["platform"] == "cpu"
    assert {k: v for k, v in summary["config"].items() if k != "platform"} == {
        k: v for k, v in ref["config"].items() if k != "platform"}


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _decoded(root, cam="image_0"):
    seq = kitti.KittiSequence(root, "00", cam=cam)
    return [runtime.decode_png(seq.image_path(i)) for i in range(seq.n_frames())]


def _in_memory(root, mode):
    """The mode's runner on the decoded PNGs, configured as the CLI does."""
    seq = kitti.KittiSequence(root, "00")
    cam, gt = seq.intrinsics(), seq.load_poses()
    fe = FrontendConfig(fast_threshold=12.0, max_keypoints=256)
    rc = RansacConfig(n_hyp=256, method="lmeds" if mode == "vo" else "ransac")
    frames = _decoded(root)
    kw = dict(batch=4, device="cpu")
    if mode == "vo":
        return runners.run_vo_sequence(frames, VOConfig(camera=cam, frontend=fe, ransac=rc,
                                                        lm=LMConfig(n_points=48,
                                                                    revert_r_norm=1e-4)),
                                       gt_poses=gt, **kw)
    if mode == "gt":
        return runners.run_gt_triangulation_sequence(
            frames, VOConfig(camera=cam, frontend=fe, ransac=rc, lm=LMConfig(n_points=48)),
            gt_poses=gt, device="cpu")
    cfg = BAConfig(camera=cam, frontend=fe, ransac=rc,
                   lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    if mode == "ba":
        return runners.run_ba_sequence(frames, cfg, gt_poses=gt, n_frames=F, **kw)
    return runners.run_stereo_ba_sequence(frames, _decoded(root, "image_1"), cfg,
                                          T_rig=seq.stereo_baseline_T(), gt_poses=gt,
                                          n_frames=F, **kw)


def _listing(out):
    return sorted(os.listdir(out))


def _summary(out):
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["vo", "ba", "stereo", "gt"])
def test_cli_matches_runner(tree, tmp_path, mode):
    out = str(tmp_path / "port")
    res = _quiet(run_kitti.main, ["--root", tree, "--mode", mode, "--out", out,
                                  "--device", "cpu", *FLAGS])
    mem = _in_memory(tree, mode)
    np.testing.assert_array_equal(res.trajectory, mem.trajectory)
    summary = _summary(out)
    assert summary["ate_m"] == mem.ate and summary["rpe_t"] == mem.rpe_t
    assert summary["frames"] == F and summary["config"]["platform"] == "cpu"
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(out, "est_kitti_format.txt")).astype(np.float32),
        mem.trajectory[:, :3, :].reshape(F, 12).astype(np.float32))


def test_cli_two_ranks(tree, tmp_path):
    one = _quiet(run_kitti.main, ["--root", tree, "--mode", "ba", "--device", "cpu",
                                  "--out", str(tmp_path / "one"), *FLAGS])
    two = _quiet(run_kitti.main, ["--root", tree, "--mode", "ba", "--device", "cpu",
                                  "--devices", "2", "--backend", "gloo",
                                  "--out", str(tmp_path / "two"), *FLAGS])
    print(f"ATE one rank {one.ate:.4f}, 2 ranks {two.ate:.4f}")
    assert one.ate < 0.5 and two.ate < 0.5, (one.ate, two.ate)
    assert _listing(tmp_path / "one") == _listing(tmp_path / "two")
    assert _summary(tmp_path / "two")["config"]["devices"] == 2


@pytest.mark.parametrize("case", ["no-sequence", "gt-without-poses", "mesh"])
def test_cli_errors(tree, tmp_path, case):
    argv = ["--root", tree, "--device", "cpu", "--out", str(tmp_path / "o")]
    if case == "no-sequence":
        argv += ["--seq", "07"]
    elif case == "gt-without-poses":
        os.makedirs(tmp_path / "bare" / "sequences" / "00")
        os.symlink(os.path.join(tree, "sequences", "00", "image_0"),
                   tmp_path / "bare" / "sequences" / "00" / "image_0")
        argv = ["--root", str(tmp_path / "bare"), "--mode", "gt", "--device", "cpu",
                "--out", str(tmp_path / "o")]
    else:
        argv += ["--devices", "3", "--hyp-devices", "2"]
    with pytest.raises(SystemExit) as e:
        _quiet(run_kitti.main, argv)
    assert e.value.code == 2
