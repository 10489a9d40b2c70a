"""Drive the sequence runners end to end on a rendered multi-frame scene
(the port's counterpart of ``examples/sequence_demo.py``).

Exercises the dataset-to-runner surface as a KITTI user would: a frame
stream and ground-truth poses in, trajectory, ATE, cloud and artifacts
out, for the two-view VO runner and the windowed-BA runner. Writes
``kitti.T``, ``kitti.GT``, ``pts.cld``, ``lims`` and ``traj.png`` (skipped,
with a note on stderr, where matplotlib is not installed) to ``--out`` and
prints ``RESULT ok=True`` (exit 0) when the VO ATE is below 0.1 m and the
BA ATE below 0.15 m. The scene's points are the JAX demo's own draw
(``demo_scenes.npz``).

    python -m epivo_tpu_torch.tools.sequence_demo [--device cpu] [--out DIR] [--frames 8]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from epivo_tpu_torch.tools.synthetic_vo_demo import demo_scene, render


def main(argv=None) -> int:
    from epivo_tpu_torch._device import runner_device
    from epivo_tpu_torch.geometry import camera, se3
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, LMConfig,
                                                 RansacConfig, VOConfig)
    from epivo_tpu_torch.viz import export

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default="out/sequence_demo")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    dev = runner_device(args.device)

    H, W = 120, 160
    cam = camera.Pinhole(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg = VOConfig(
        camera=cam,
        frontend=FrontendConfig(fast_threshold=15.0, max_keypoints=128, klt_levels=3),
        ransac=RansacConfig(n_hyp=256),
        lm=LMConfig(n_points=32, revert_r_norm=1e-4),
    )
    X = torch.from_numpy(demo_scene("sequence_demo"))
    K = cam.K()
    step = se3.se3_exp(torch.tensor([0.02, -0.01, 0.35, 0.006, -0.01, 0.004])).numpy()
    frames, gt = [], []
    T_wc = np.eye(4)
    for _ in range(args.frames):
        T_cw = torch.from_numpy(np.linalg.inv(T_wc).astype(np.float32))
        frames.append(render(X, K, T_cw, H, W).numpy())
        gt.append(T_wc)
        T_wc = T_wc @ np.linalg.inv(step)
    gt = np.stack(gt)

    os.makedirs(args.out, exist_ok=True)
    res = runners.run_vo_sequence(frames, cfg, gt_poses=gt, batch=4, device=dev)
    print(f"VO runner: ATE={res.ate:.4f} m  RPE_t={res.rpe_t:.4f}  "
          f"cloud={res.cloud.shape[0]} pts  inliers(min)={res.per_frame['n_inliers'].min()}")
    ba_cfg = BAConfig(camera=cam, frontend=cfg.frontend, ransac=cfg.ransac,
                      lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    res_ba = runners.run_ba_sequence(frames, ba_cfg, gt_poses=gt, device=dev)
    print(f"BA runner: ATE={res_ba.ate:.4f} m  RPE_t={res_ba.rpe_t:.4f}  "
          f"windows reverted={res_ba.per_frame['window_reverted'].sum()}")

    export.write_poses(os.path.join(args.out, "kitti.T"), res.trajectory)
    export.write_poses(os.path.join(args.out, "kitti.GT"), res.gt_trajectory)
    export.write_cloud(os.path.join(args.out, "pts.cld"), res.cloud,
                       lims_path=os.path.join(args.out, "lims"), limits=res.cloud_limits)
    export.plot_or_skip(os.path.join(args.out, "traj.png"),
                        {"VO": res.trajectory, "BA": res_ba.trajectory,
                         "GT": res.gt_trajectory}, cloud=res.cloud)
    print(f"artifacts -> {args.out}: " + ", ".join(sorted(os.listdir(args.out))))
    ok = res.ate < 0.1 and res_ba.ate < 0.15
    print(f"RESULT ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
