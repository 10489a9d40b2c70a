"""Port parity: the EuRoC CLI (``epivo_tpu_torch/tools/run_euroc.py``) on
the fabricated ``mav0/`` tree of ``tests/test_euroc_cli.py`` (a misaligned
rig rendered from a blob scene, 4 stereo frames at 120x160, zero
distortion and the test camera monkeypatched into the port's
``datasets/euroc.py``), with that file's assertions, on the CPU:

- ``--mode stereo``: the summary's mode, frames, baseline (0.5 m within
  1e-6 relative) and metric ATE below 0.3 m, ``euroc.T`` and ``traj.png``
  written, the per-window LM health and extraction lines in
  ``metrics.jsonl``;
- ``--mode stereo --loop-close``: the loop stage runs and applies no loop
  on the tiny fixture;
- ``--mode vo --loop-close`` (not in the reference's test): the keyframe
  store and the loop stage on the VO trajectory; the summary's keys;
- ``--mode vo`` with a nonzero lens in the fixture's calibration: the
  raw frames undistorted inside the step give the ``euroc.T`` of the
  host-undistorted frames through a pinhole step, byte for byte;
- ``--mode stereo --devices 2 --backend gloo``: two CPU ranks (the rank
  program sets the fixture's calibration, which a spawned process does
  not inherit), the same ATE bound.

Its slow twin, ``tests/test_torch_cli_euroc_slow.py``, also runs the JAX
package's CLI on the same tree and holds the files and summary keys equal.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from epivo_tpu_torch.datasets import euroc as teuroc
from epivo_tpu_torch.tools import run_euroc
from tests.test_euroc_cli import fake_euroc_stereo
from tests.test_runners_datasets import CAM

torch.set_num_threads(1)


def rig():
    """cam1's T_BS of the fixture: 1 degree about y, 0.5 m along x."""
    th = np.deg2rad(1.0)
    T_BS1 = np.eye(4)
    T_BS1[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                              [-np.sin(th), 0, np.cos(th)]])
    T_BS1[:3, 3] = [0.5, 0.0, 0.0]
    return T_BS1


def calibration() -> list:
    """(name, value) of the dataset module's constants for the fixture: its
    camera, no distortion, cam0 at the body frame, cam1 at :func:`rig`."""
    K = np.asarray(CAM.K(), np.float64)
    return [("EUROC_CAM0_K", K), ("EUROC_CAM1_K", K), ("EUROC_CAM0_DIST", np.zeros(4)),
            ("EUROC_CAM1_DIST", np.zeros(4)), ("EUROC_T_BS", np.eye(4)),
            ("EUROC_T_BS_CAM1", rig())]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fake_euroc_stereo(tmp_path_factory.mktemp("euroc"), rig())


def run_port(root, out, monkeypatch, *flags):
    for name, value in calibration():
        monkeypatch.setattr(teuroc, name, value)
    with contextlib.redirect_stdout(io.StringIO()):
        summary = run_euroc.main(["--root", root, "--out", out, "--device", "cpu", *flags])
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary
    return summary


def test_run_euroc_stereo_cli(tree, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    summary = run_port(tree, out, monkeypatch, "--mode", "stereo")
    assert summary["mode"] == "stereo"
    assert summary["frames"] == 4
    assert summary["baseline_m"] == pytest.approx(0.5, rel=1e-6)
    assert summary["config"]["platform"] == "cpu"
    # Metric accuracy (scale from the calibrated baseline, PNG-quantized
    # pixels): SE(3)-aligned ATE, no scale alignment.
    assert summary["ate_m"] is not None and summary["ate_m"] < 0.3, summary
    assert os.path.exists(os.path.join(out, "euroc.T"))
    assert os.path.exists(os.path.join(out, "traj.png"))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    win_events = [e for e in events if e.get("stage") == "ba_window"]
    assert win_events, events[:3]
    assert all("r_norm" in e and "n_accepted" in e for e in win_events)
    assert [e for e in events if e.get("stage") == "extract"]


def test_run_euroc_stereo_cli_loop_close(tree, tmp_path, monkeypatch):
    summary = run_port(tree, str(tmp_path / "out_loop"), monkeypatch, "--mode", "stereo",
                       "--loop-close")
    assert summary["mode"] == "stereo"
    assert summary["loops_applied"] == 0  # fixture too small for loops


def test_run_euroc_vo_cli_loop_close(tree, tmp_path, monkeypatch):
    out = str(tmp_path / "out_vo")
    summary = run_port(tree, out, monkeypatch, "--loop-close")
    assert set(summary) == {"frames", "ate_m", "rpe_t", "loops_applied"}
    assert summary["frames"] == 4 and summary["loops_applied"] == 0
    assert summary["ate_m"] is not None and np.isfinite(summary["ate_m"])
    assert {"euroc.T", "euroc.GT", "traj.png", "summary.json"} <= set(os.listdir(out))


def _rank_with_calibration(dev, args):
    """``run_euroc.stereo_rank`` with the fixture's calibration, which a
    spawned rank does not inherit from the parent's monkeypatch."""
    for name, value in calibration():
        setattr(teuroc, name, value)
    return _STEREO_RANK(dev, args)


_STEREO_RANK = run_euroc.stereo_rank


def test_run_euroc_stereo_cli_two_ranks(tree, tmp_path, monkeypatch):
    """``--devices 2 --backend gloo``: the window solve over two CPU ranks,
    the ATE within the stereo bound above, the summary's keys."""
    monkeypatch.setattr(run_euroc, "stereo_rank", _rank_with_calibration)
    summary = run_port(tree, str(tmp_path / "out2"), monkeypatch, "--mode", "stereo",
                       "--devices", "2", "--backend", "gloo")
    assert summary["config"]["devices"] == 2 and summary["frames"] == 4
    assert summary["ate_m"] is not None and summary["ate_m"] < 0.3, summary


def test_run_euroc_vo_cli_raw_frames_with_distortion(tree, tmp_path, monkeypatch):
    """The CLI feeds raw frames and the step undistorts them: its
    ``euroc.T`` equals that of the host-undistorted frames
    (``EurocSequence.undistorted_frames``) through the same step with no
    distortion, with the fixture's lens made nonzero."""
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.viz import export

    lens = np.array([-0.05, 0.01, 1e-3, -5e-4])
    for name, value in calibration() + [("EUROC_CAM0_DIST", lens)]:
        monkeypatch.setattr(teuroc, name, value)
    out = tmp_path / "out_raw"
    with contextlib.redirect_stdout(io.StringIO()):
        summary = run_euroc.main(["--root", tree, "--out", str(out), "--device", "cpu"])
    assert summary["frames"] == 4 and np.isfinite(summary["ate_m"])

    seq = teuroc.EurocSequence(root=tree)
    stamped = list(seq.undistorted_frames())
    frames = [f for _, f in stamped]
    gt_ts, gt_poses = seq.load_gt_cam0()
    idx = teuroc.associate(np.array([t for t, _ in stamped], np.int64), gt_ts)
    assert np.all(idx >= 0)
    cfg = run_euroc.vo_config(frames[0].shape)
    assert cfg.distortion is not None and cfg.distortion.k1 == -0.05
    res = runners.run_vo_sequence(frames, dataclasses.replace(cfg, distortion=None),
                                  gt_poses=gt_poses[idx], batch=8, device="cpu")
    export.write_poses(str(tmp_path / "host.T"), res.trajectory)
    assert (out / "euroc.T").read_bytes() == (tmp_path / "host.T").read_bytes()
