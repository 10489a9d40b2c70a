"""Run VO / stereo BA on a EuRoC MAV sequence (the port's counterpart of
``scripts/run_euroc.py``, with its flags, artifacts and summary keys).

- ``--mode vo`` (default): the undistorted cam0 stream -> two-view VO
  with the timestamp-associated ground truth's step lengths -> trajectory,
  ATE and artifacts; ``--loop-close`` keeps keyframes off the stream and
  runs the loop stage (keyframe retrieval, ORB verification, Sim(3)
  spreading) on the finished trajectory.
- ``--mode stereo``: fully rectified cam0/cam1 pairs (Bouguet
  split-rotation rectification) -> windowed stereo BA, the calibrated
  baseline giving the metric scale (ground truth for evaluation only),
  streamed with bounded memory; ``--devices N`` splits it over N ranks
  (``--backend``, as in ``tools/run_kitti.py``).

Artifacts in ``--out``: ``euroc.T``, ``euroc.GT``, ``pts.cld`` / ``lims``
(vo, when there is a cloud), ``traj.png`` (skipped, with a note on
stderr, where matplotlib is not installed), ``metrics.jsonl`` (stereo)
and ``summary.json``, whose JSON is also printed. ``--device`` is
``cuda`` (the default) or ``cpu``.

    python -m epivo_tpu_torch.tools.run_euroc --root /path/to/V2_01_easy --frames 500 \\
        --out out/euroc_v201 [--mode vo|stereo]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--mode", choices=["vo", "stereo"], default="vo")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="out/euroc")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to split the stereo window solve over (0 = one process)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="with --devices: default nccl on cuda, gloo on cpu")
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--loop-close", action="store_true",
                    help="enable loop closure (keyframe retrieval + ORB/RANSAC "
                         "verification + Sim(3) spreading)")
    return ap


def main(argv=None):
    """Run the CLI; returns the summary. Exits with status 2 on a missing
    sequence or too few stereo pairs."""
    from epivo_tpu_torch._device import runner_device
    from epivo_tpu_torch.datasets import euroc
    from epivo_tpu_torch.geometry.camera import EUROC_CAM0
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import (FrontendConfig, LMConfig, RansacConfig,
                                                 VOConfig)
    from epivo_tpu_torch.viz import export

    args = parser().parse_args(argv)
    seq = euroc.EurocSequence(root=args.root)
    if not seq.exists():
        print(f"ERROR: sequence not found at {seq.cam_dir}", file=sys.stderr)
        sys.exit(2)
    if args.mode == "stereo":
        return run_stereo(args, seq)
    dev = runner_device(args.device)

    stop = args.start + args.frames if args.frames else None
    stamped = list(seq.undistorted_frames(args.start, stop))
    ts = np.array([t for t, _ in stamped], np.int64)
    frames = [f for _, f in stamped]

    gt = None
    try:
        gt_ts, gt_poses = seq.load_gt_cam0()
        idx = euroc.associate(ts, gt_ts)
        if np.all(idx >= 0):
            gt = gt_poses[idx]
        else:
            keep = idx >= 0
            frames = [f for f, k in zip(frames, keep) if k]
            gt = gt_poses[idx[keep]]
            print(f"dropped {int((~keep).sum())} frames without GT within tolerance")
    except OSError:
        print("no GT found; monocular scale will be unit-norm")

    cfg = VOConfig(
        camera=EUROC_CAM0,
        frontend=FrontendConfig(fast_threshold=20.0, max_keypoints=1024),
        ransac=RansacConfig(n_hyp=512, threshold_px=0.3),
        lm=LMConfig(n_points=48, revert_r_norm=1e-4),
    )
    kf_store = None
    if args.loop_close:
        from epivo_tpu_torch.pipeline import loopclose
        from epivo_tpu_torch.pipeline.config import LoopConfig

        loop_cfg = LoopConfig(enabled=True)
        kf_store = loopclose.KeyframeStore(loop_cfg.keyframe_stride, loop_cfg.keyframe_budget)
        for i, f in enumerate(frames):
            kf_store.offer(i, f)
    res = runners.run_vo_sequence(frames, cfg, gt_poses=gt, batch=args.batch, device=dev)
    n_loops = 0
    if kf_store:
        from epivo_tpu_torch.eval import metrics as ev
        from epivo_tpu_torch.pipeline.config import BAConfig

        ba_like = BAConfig(camera=cfg.camera, frontend=cfg.frontend, ransac=cfg.ransac,
                           lm=cfg.lm, loop=loop_cfg)
        traj2, loops = runners._loop_stage(res.trajectory, kf_store, ba_like, seed=0,
                                           mlog=None, device=dev)
        n_loops = len(loops)
        ate2 = rpe2 = None
        if res.gt_trajectory is not None:
            n = min(len(res.gt_trajectory), traj2.shape[0])
            ate2 = float(ev.ate_rmse(traj2[:n], res.gt_trajectory[:n], align=True,
                                     with_scale=False))
            rpe2 = float(ev.rpe(traj2[:n], res.gt_trajectory[:n])[0])
        res = res._replace(trajectory=traj2, loops=tuple(loops),
                           ate=ate2 if ate2 is not None else res.ate,
                           rpe_t=rpe2 if rpe2 is not None else res.rpe_t)

    os.makedirs(args.out, exist_ok=True)
    export.write_poses(os.path.join(args.out, "euroc.T"), res.trajectory)
    if res.gt_trajectory is not None:
        export.write_poses(os.path.join(args.out, "euroc.GT"), res.gt_trajectory)
    if res.cloud.shape[0]:
        export.write_cloud(os.path.join(args.out, "pts.cld"), res.cloud,
                           lims_path=os.path.join(args.out, "lims"), limits=res.cloud_limits)
    export.plot_or_skip(
        os.path.join(args.out, "traj.png"),
        {k: v for k, v in [("est", res.trajectory), ("gt", res.gt_trajectory)]
         if v is not None})
    summary = {"frames": len(frames), "ate_m": res.ate, "rpe_t": res.rpe_t,
               "loops_applied": n_loops}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def _stereo_inputs(args, seq):
    """(timestamps, camera, T_rig, the rectifying rotation of cam0) of the
    matched stereo pairs."""
    from epivo_tpu_torch.geometry.camera import Pinhole

    stop = args.start + args.frames if args.frames else None
    ts = seq.stereo_timestamps(args.start, stop)
    # Rectification geometry (one probe image for the shape).
    probe = seq.load_image(seq.image_list()[0][1])
    _, _, K_new, T_rig, Rrect0 = seq.stereo_rectification(probe.shape)
    H, W = probe.shape
    cam = Pinhole(fx=float(K_new[0, 0]), fy=float(K_new[1, 1]), cx=float(K_new[0, 2]),
                  cy=float(K_new[1, 2]), width=W, height=H)
    return ts, cam, T_rig, Rrect0


def stereo_sequence(args, seq, device, mesh=None):
    """``run_stereo_ba_sequence`` on the rectified pairs, on ``device`` (and
    ``mesh``). Returns its ``SequenceResult``."""
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, LMConfig,
                                                 LoopConfig, RansacConfig)

    ts, cam, T_rig, _ = _stereo_inputs(args, seq)
    stop = args.start + args.frames if args.frames else None
    # One decode pass, bounded memory: tee the triple stream; the stereo
    # runner consumes L/R alternately so the tee buffer stays at one item.
    t1, t2 = itertools.tee(seq.rectified_stereo_frames(args.start, stop))
    L = (l for _, l, _ in t1)
    R = (r for _, _, r in t2)
    loop_kw = {"loop": LoopConfig(enabled=True)} if args.loop_close else {}
    cfg = BAConfig(camera=cam,
                   frontend=FrontendConfig(fast_threshold=20.0, max_keypoints=1024),
                   ransac=RansacConfig(n_hyp=512, threshold_px=0.3),
                   lm=LMConfig(n_points=32, revert_r_norm=1e-2), **loop_kw)
    return runners.run_stereo_ba_sequence(
        L, R, cfg, T_rig=T_rig, n_frames=len(ts), batch=args.batch,
        pipeline_depth=args.pipeline_depth, mesh=mesh,
        metrics_path=os.path.join(args.out, "metrics.jsonl"), device=device)


def stereo_rank(dev, args):
    """One rank of ``--devices``: :func:`stereo_sequence` on a (win,) mesh
    over every rank."""
    from epivo_tpu_torch.datasets import euroc
    from epivo_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(n_win=args.devices, n_hyp=1, device_type=dev.type)
    return stereo_sequence(args, euroc.EurocSequence(root=args.root), dev, mesh)


def run_stereo(args, seq):
    """Rectified stereo pairs -> windowed stereo BA (metric scale from the
    calibrated baseline; ground truth used for evaluation only)."""
    from epivo_tpu_torch._device import runner_device
    from epivo_tpu_torch.datasets import euroc
    from epivo_tpu_torch.eval import metrics as ev
    from epivo_tpu_torch.parallel import multihost
    from epivo_tpu_torch.viz import export

    ts, _, T_rig, Rrect0 = _stereo_inputs(args, seq)
    if len(ts) < 3:
        print("ERROR: not enough matched stereo pairs", file=sys.stderr)
        sys.exit(2)
    os.makedirs(args.out, exist_ok=True)
    if args.devices:
        backend = args.backend or {"cuda": "nccl", "cpu": "gloo"}[args.device]
        res = multihost.spawn(stereo_rank, args.devices, args, backend=backend,
                              device=args.device, timeout_s=float("inf"))[0]
        device_type = args.device
    else:
        dev = runner_device(args.device)
        res = stereo_sequence(args, seq, dev)
        device_type = dev.type

    summary = {"mode": "stereo", "frames": len(ts),
               "baseline_m": float(-T_rig[0, 3]),
               "loops_applied": len(res.loops),
               "windows_reverted": int(res.per_frame["window_reverted"].sum()),
               "config": {"batch": args.batch, "pipeline_depth": args.pipeline_depth,
                          "devices": args.devices or 1, "platform": device_type}}
    # Ground truth (evaluation only): cam0 poses mapped into the rectified frame.
    try:
        gt_ts, gt_cam0 = seq.load_gt_cam0()
        idx = euroc.associate(np.asarray(ts, np.int64), gt_ts)
        if np.all(idx >= 0):
            R_r = np.eye(4)
            R_r[:3, :3] = Rrect0.T  # world-from-rect = world-from-cam0 @ R^T
            gt = gt_cam0[idx] @ R_r[None]
            gt = np.linalg.inv(gt[0])[None] @ gt
            n = min(len(gt), res.trajectory.shape[0])
            # Metric (no scale alignment): the baseline must supply the scale.
            summary["ate_m"] = float(ev.ate_rmse(res.trajectory[:n], gt[:n], align=True,
                                                 with_scale=False))
            summary["rpe_t"] = float(ev.rpe(res.trajectory[:n], gt[:n])[0])
            export.write_poses(os.path.join(args.out, "euroc.GT"), gt[:n])
    except OSError:
        summary["ate_m"] = None

    export.write_poses(os.path.join(args.out, "euroc.T"), res.trajectory)
    export.plot_or_skip(os.path.join(args.out, "traj.png"), {"est": res.trajectory})
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
