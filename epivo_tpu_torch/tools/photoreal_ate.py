"""Accuracy of the port's monocular sequence path on the photoreal corridor.

The 300-frame KITTI-sized (376x1241) corridor of ``datasets/photoreal.py``
(speed 0.8, exposure drift 0.15, sensor noise 2.0, fixture seed 7) at the
configuration of the JAX package's ``scripts/run_photoreal_ate.py``: FAST
threshold 30, 512 keypoints, 512 hypotheses, 48 LM points for the
two-view step and 32 for the BA windows (revert above 1e-2), batches of
32 pairs, global BA and loop closure off. For each RANSAC seed:

- windowed BA with no ground truth (``run_ba_sequence``): Sim(3)-aligned
  ATE, SE(3)-aligned ATE, and the length ratio with the gauge fixed on
  step 0 (the relative scale drift, which is observable); and the
  accuracy of the extracted two-view pairs against the ground truth
  (:func:`pair_accuracy`), which, unlike the trajectory, does not
  compound one pair's error into the scales after it;
- with ``--vo``, also two-view VO with the ground truth's step lengths
  injected (``run_vo_sequence``): SE(3)-aligned ATE.

Frames are rendered once (in ``--workers`` processes, bit-equal to the
sequential generator) and kept in float32 on the host. Prints one JSON
object. With ``--save-pairs DIR`` it also writes each seed's extracted
pairs to ``DIR/pairs_seed<s>.npz`` (the runners' checkpoint packing),
which ``python -m tests.reference_accuracy back-half`` feeds to both
packages' windowed BA; otherwise it writes nothing.

    python -m epivo_tpu_torch.tools.photoreal_ate --seeds 0,1,2 [--vo] [--save-pairs DIR]
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import time

import numpy as np

H, W = 376, 1241
FIXTURE = dict(speed=0.8, exposure_drift=0.15, noise_sigma=2.0, seed=7)


class _Drawn:
    """Stands in for the sequence's noise generator inside a worker: hands
    back the field the generator drew for this frame."""

    def __init__(self, field: np.ndarray):
        self.field = field

    def normal(self, loc, scale, size):
        return self.field


@functools.lru_cache(maxsize=1)
def _textures():
    from epivo_tpu_torch.datasets import photoreal

    return photoreal.CorridorScene().textures()


def _render(job):
    from epivo_tpu_torch.datasets import photoreal

    K, T_wc, h, w, exposure, bias, noise = job
    return photoreal.render_frame(photoreal.CorridorScene(), _textures(), K, T_wc, h, w,
                                  exposure=exposure, bias=bias,
                                  noise_sigma=FIXTURE["noise_sigma"], rng=_Drawn(noise))


def render_corridor(n_frames: int = 300, h: int = H, w: int = W, workers: int = 8):
    """The corridor's frames as ``photoreal.corridor_sequence`` yields them
    (at the fixture's settings and the KITTI_00 intrinsics), rendered in
    ``workers`` processes: the noise fields are drawn here in frame order
    from the sequence's own generator, so every frame is bit-equal.
    Returns (frames [F] float32 [h, w], gt [F, 4, 4], K, trajectory length)."""
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.geometry.camera import KITTI_00 as cam

    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    _, gt, _ = photoreal.corridor_sequence(n_frames, H=h, W=w, K=K, **FIXTURE)
    # The per-frame photometric terms and noise draws of corridor_sequence.
    frng = np.random.default_rng(FIXTURE["seed"] + 200)
    jobs = [(K, gt[f], h, w, 1.0 + FIXTURE["exposure_drift"] * np.sin(0.05 * f),
             4.0 * np.sin(0.03 * f + 1.0), frng.normal(0.0, FIXTURE["noise_sigma"], (h, w)))
            for f in range(n_frames)]
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            frames = pool.map(_render, jobs, chunksize=max(1, n_frames // (4 * workers)))
    else:
        frames = [_render(j) for j in jobs]
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    return frames, gt, K, length


def configs():
    """(VOConfig, BAConfig) of the corridor runs."""
    from epivo_tpu_torch.geometry.camera import KITTI_00 as cam
    from epivo_tpu_torch.pipeline.config import (
        BAConfig, FrontendConfig, LMConfig, RansacConfig, VOConfig,
    )

    fc = FrontendConfig(fast_threshold=30.0, max_keypoints=512, klt_levels=4)
    rc = RansacConfig(n_hyp=512)
    vo_cfg = VOConfig(camera=cam, frontend=fc, ransac=rc, lm=LMConfig(n_points=48))
    ba_cfg = BAConfig(camera=cam, frontend=fc, ransac=rc,
                      lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    return vo_cfg, ba_cfg


PAIR_KINDS = {1: "forward", -1: "backward", 2: "forward_skip", -2: "backward_skip"}


def pair_accuracy(pair_data: dict, gt: np.ndarray) -> dict:
    """Two-view pose accuracy of extracted pairs {(i, j): {"T": ...}}
    against the ground-truth camera-to-world poses ``gt``, per pair kind
    (j - i = 1, -1, 2, -2) and over all pairs: the median translation-
    direction error |t/|t| - t_gt/|t_gt||, the count of flipped directions
    (error above 1, i.e. more than 60 degrees off) and the median
    |R - R_gt|_F."""
    rows: dict = {}
    for (i, j), d in pair_data.items():
        T = np.asarray(d["T"], np.float64)
        T_gt = np.linalg.inv(gt[j]) @ gt[i]
        t, t_gt = T[:3, 3], T_gt[:3, 3]
        e_dir = np.linalg.norm(t / np.linalg.norm(t) - t_gt / np.linalg.norm(t_gt))
        e_rot = np.linalg.norm(T[:3, :3] - T_gt[:3, :3])
        for kind in (PAIR_KINDS.get(j - i, "other"), "all"):
            rows.setdefault(kind, []).append((e_dir, e_rot))
    return {kind: {"n": len(v), "dir_median": float(np.median([e for e, _ in v])),
                   "flipped": int(sum(e > 1.0 for e, _ in v)),
                   "rot_median": float(np.median([r for _, r in v]))}
            for kind, v in rows.items()}


def score_no_gt(traj: np.ndarray, gt: np.ndarray, length: float) -> dict:
    """A no-GT trajectory scored as ``scripts/run_photoreal_ate.py``
    scores it: Sim(3)- and SE(3)-aligned ATE, and the length ratio with the
    gauge fixed on step 0."""
    from epivo_tpu_torch.eval import metrics

    gt_aln = np.linalg.inv(gt[0])[None] @ gt[: traj.shape[0]]
    ate_sim3 = metrics.ate_rmse(traj, gt_aln, align=True, with_scale=True)
    est_step = np.linalg.norm(np.diff(traj[:, :3, 3], axis=0), axis=-1)
    gt_step = np.linalg.norm(np.diff(gt_aln[:, :3, 3], axis=0), axis=-1)
    g0 = gt_step[0] / max(est_step[0], 1e-12)
    return {"ate_sim3_rmse_m": float(ate_sim3),
            "ate_sim3_pct_of_length": 100.0 * float(ate_sim3) / length,
            "ate_se3_rmse_m": float(metrics.ate_rmse(traj, gt_aln, align=True,
                                                     with_scale=False)),
            "length_ratio_gauge0": float(est_step.sum() * g0 / gt_step.sum())}


def vo_gt_scale(frames, gt, length, batch=32, pipeline_depth=2, device=None) -> dict:
    """``run_vo_sequence`` with the ground truth's step lengths."""
    from epivo_tpu_torch.pipeline import runners

    t0 = time.perf_counter()
    res = runners.run_vo_sequence(frames, configs()[0], gt_poses=gt, batch=batch,
                                  collect_cloud=False, pipeline_depth=pipeline_depth,
                                  device=device)
    return {"ate_rmse_m": float(res.ate), "ate_pct_of_length": 100.0 * float(res.ate) / length,
            "rpe_t_m": float(res.rpe_t),
            "inliers_mean": float(res.per_frame["n_inliers"].mean()),
            "reverted_frames": int(res.per_frame["reverted"].sum()),
            "wall_s": time.perf_counter() - t0}


def ba_no_gt(frames, gt, length, seed=0, batch=32, pipeline_depth=2, device=None):
    """``run_ba_sequence`` with no ground truth. Returns (its report: the
    scores of :func:`score_no_gt`, the pairs' :func:`pair_accuracy`, the
    runner's counts and host wall seconds per stage; the runner's
    result)."""
    from epivo_tpu_torch.pipeline import runners

    res = runners.run_ba_sequence(frames, configs()[1], gt_poses=None, seed=seed,
                                  batch=batch, pipeline_depth=pipeline_depth, device=device)
    return {"seed": seed, **score_no_gt(res.trajectory, gt, length),
            "windows_reverted": int(res.per_frame["window_reverted"].sum()),
            "windows_total": int(res.per_frame["window_reverted"].size),
            "pairs": pair_accuracy(res.pair_data, gt),
            "stats": res.stats}, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0", help="comma list of RANSAC seeds")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8, help="render processes")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--vo", action="store_true", help="also VO with the GT scale")
    ap.add_argument("--save-pairs", default=None, metavar="DIR",
                    help="write each seed's extracted pairs to DIR/pairs_seed<s>.npz")
    args = ap.parse_args(argv)

    import os

    import torch

    from epivo_tpu_torch.pipeline import runners

    t0 = time.perf_counter()
    frames, gt, _, length = render_corridor(args.frames, workers=args.workers)
    out = {"frames": args.frames, "image": [H, W], "trajectory_length_m": length,
           "render_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0) if args.device in (None, "cuda")
           and torch.cuda.is_available() else str(args.device)}
    if args.vo:
        out["vo_gt_scale"] = vo_gt_scale(frames, gt, length, args.batch, device=args.device)
    runs = []
    for s in args.seeds.split(","):
        run, res = ba_no_gt(frames, gt, length, int(s), args.batch, device=args.device)
        runs.append(run)
        if args.save_pairs:
            os.makedirs(args.save_pairs, exist_ok=True)
            np.savez(os.path.join(args.save_pairs, f"pairs_seed{int(s)}.npz"),
                     **runners._pack_pairs(res.pair_data))
    out["ba_no_gt"] = runs
    vals = [r["ate_sim3_pct_of_length"] for r in runs]
    out["ba_no_gt_seed_spread_pct"] = [min(vals), max(vals)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
