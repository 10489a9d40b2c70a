"""Loop closure on the photoreal loop courses, through the port.

The KITTI-sized (376x1241, fx 718.856, principal point at the centre)
loop courses of ``datasets/photoreal.py`` (``loop_sequence``: exposure
drift 0.15, sensor noise 2.0, noise seed 200) at the configuration of the
JAX package's ``scripts/run_photoreal_loop.py``: FAST threshold 30, 512
keypoints, 4 KLT levels, 512 hypotheses, 32 LM points (revert above
1e-2), batches of 32 pairs, pipeline depth 2, the default ``LoopConfig``
(keyframe stride 8, pose graph on). Courses:

- ``out-and-back``: 236 frames, 93.24 m; the revisit has zero baseline;
- ``offset``: the closing lane 1.8 m off the outbound one
  (``close_offset=1.8``);
- ``two-lap``: 460 frames (``laps=2``), several revisits whose spans
  overlap: the joint Sim(3) pose graph and its self-consistency gate.

For each course and RANSAC seed, ``run_ba_sequence`` runs once with no
ground truth fed and loop closure off, while a ``KeyframeStore`` takes
the keyframes off the frame stream as the runner's own tee does; the loop
stage (``runners._loop_stage``) then runs on that trajectory with those
keyframes, so loop off and loop on share their extraction (a CPU test
holds this equal to ``run_ba_sequence`` with ``loop.enabled``). Each run
reports the Sim(3) and SE(3) ATE, the endpoint gap and the length ratio
with the gauge on step 0 (as ``scripts/run_photoreal_loop.py`` computes
them), the loops applied and the stage's counts and wall seconds; the
two-lap course also runs the greedy mode (``pose_graph=False``).

``--drift`` adds the drift-injected fixture: the out-and-back course's
ground-truth chain with the per-step drift exp([0, 0.0015, 0, 0, 0,
0.008]) applied, corrected by ``close_loops`` at the configuration of the
JAX package's ``test_close_loops_on_photoreal_fixture`` (FAST threshold
25, minimum gap 60, 30 matches, 25 inliers) with the loop stage's half
camera and pyramid ORB.

Frames are rendered once per course in ``--workers`` processes (the noise
fields drawn here in frame order, so every frame is bit-equal to
``loop_sequence``'s). Prints one JSON object per run and one summary.

    python -m epivo_tpu_torch.tools.photoreal_loop --seeds 0,1,2 [--courses out-and-back,offset,two-lap] [--drift]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import time

import numpy as np

from epivo_tpu_torch.tools.photoreal_ate import _render

H, W, FX = 376, 1241, 718.856
COURSES = {"out-and-back": {}, "offset": {"close_offset": 1.8}, "two-lap": {"laps": 2}}
NOISE_SIGMA, NOISE_SEED = 2.0, 200  # loop_sequence's defaults (seed 0)
DRIFT_XI = (0.0, 0.0015, 0.0, 0.0, 0.0, 0.008)

# Field values of the configurations, shared with the JAX package's side
# (``tests/reference_accuracy.py loop``), which builds them with its own
# classes.
RUNNER = dict(frontend=dict(fast_threshold=30.0, max_keypoints=512, klt_levels=4),
              ransac=dict(n_hyp=512), lm=dict(n_points=32, revert_r_norm=1e-2))
DRIFT = dict(frontend=dict(fast_threshold=25.0, max_keypoints=512),
             ransac=dict(n_hyp=512), lm=dict(n_points=32),
             loop=dict(min_gap=60, min_matches=30, min_inliers=25))


def render_loop(course: str = "out-and-back", workers: int = 8):
    """The course's frames as ``photoreal.loop_sequence`` yields them,
    rendered in ``workers`` processes. Returns (frames [F] float32 [H, W],
    gt [F, 4, 4], K, trajectory length in m)."""
    from epivo_tpu_torch.datasets import photoreal

    K = np.array([[FX, 0, W / 2.0], [0, FX, H / 2.0], [0, 0, 1.0]])
    gt = photoreal.loop_trajectory(**COURSES[course])
    frng = np.random.default_rng(NOISE_SEED)
    jobs = [(K, gt[f], H, W, 1.0 + 0.15 * np.sin(0.05 * f), 4.0 * np.sin(0.03 * f + 1.0),
             frng.normal(0.0, NOISE_SIGMA, (H, W))) for f in range(len(gt))]
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            frames = pool.map(_render, jobs, chunksize=max(1, len(jobs) // (4 * workers)))
    else:
        frames = [_render(j) for j in jobs]
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    return frames, gt, K, length


def ba_config(config_mod, camera_mod, spec: dict = RUNNER, **loop):
    """The BAConfig of ``spec`` (:data:`RUNNER` or :data:`DRIFT`) on the
    courses' camera, built from ``config_mod`` / ``camera_mod`` (either
    package's ``pipeline.config`` and ``geometry.camera``); ``loop``
    overrides the LoopConfig's fields."""
    c = config_mod
    return c.BAConfig(
        camera=camera_mod.Pinhole(FX, FX, W / 2.0, H / 2.0, W, H),
        frontend=c.FrontendConfig(**spec["frontend"]), ransac=c.RansacConfig(**spec["ransac"]),
        lm=c.LMConfig(**spec["lm"]), loop=c.LoopConfig(**{**spec.get("loop", {}), **loop}))


def keyframes(loopclose_mod, frames, config):
    """The keyframe store that the runner's tee fills from ``frames``."""
    store = loopclose_mod.KeyframeStore(config.loop.keyframe_stride,
                                        config.loop.keyframe_budget)
    for idx, f in enumerate(frames):
        store.offer(idx, f)
    return store


def drift_chain(gt: np.ndarray) -> np.ndarray:
    """The ground-truth chain with :data:`DRIFT_XI` composed onto every
    step (float64)."""
    from epivo_tpu_torch.pipeline.loopclose import se3_exp_np

    drift = se3_exp_np(np.asarray(DRIFT_XI))
    est = np.asarray(gt, np.float64).copy()
    for k in range(1, len(est)):
        est[k] = est[k - 1] @ (np.linalg.inv(gt[k - 1]) @ gt[k]) @ drift
    return est


def position_rmse(traj: np.ndarray, gt: np.ndarray) -> float:
    """Unaligned position RMSE (the drift fixture's ATE)."""
    return float(np.sqrt(((np.asarray(traj)[:, :3, 3] - gt[:, :3, 3]) ** 2).sum(-1).mean()))


def score_loop(traj: np.ndarray, gt: np.ndarray, length: float) -> dict:
    """A no-GT trajectory scored as ``scripts/run_photoreal_loop.py``
    scores it: Sim(3) ATE (m and % of ``length``), SE(3) ATE, and the
    endpoint gap and length ratio with the gauge on step 0."""
    from epivo_tpu_torch.tools.photoreal_ate import score_no_gt

    out = score_no_gt(traj, gt, length)
    gt_aln = np.linalg.inv(gt[0])[None] @ gt[: traj.shape[0]]
    est_step = np.linalg.norm(np.diff(traj[:, :3, 3], axis=0), axis=-1)
    gt_step = np.linalg.norm(np.diff(gt_aln[:, :3, 3], axis=0), axis=-1)
    g0 = gt_step[0] / max(est_step[0], 1e-12)
    out["endpoint_gap_gauge0_m"] = float(np.linalg.norm(traj[-1, :3, 3] * g0
                                                        - gt_aln[-1, :3, 3]))
    return out


def loops_report(loops) -> list:
    return [{"i": int(lp.i), "j": int(lp.j), "inliers": int(lp.n_inliers),
             "retrieval_score": int(lp.score), "sigma": float(lp.sigma)} for lp in loops]


def run_course(course: str, frames: list, seeds, batch: int = 32, device=None) -> list:
    """Loop off and on for each seed on ``course`` (see the module
    docstring), on its rendered ``frames``. Returns one report per seed."""
    import dataclasses

    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.geometry import camera
    from epivo_tpu_torch.pipeline import config as pc, loopclose, runners

    gt = photoreal.loop_trajectory(**COURSES[course])
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    cfg_off, cfg_on = (ba_config(pc, camera, enabled=on) for on in (False, True))
    store = keyframes(loopclose, frames, cfg_on)
    modes = [("loop_on", cfg_on)]
    if course == "two-lap":
        modes.append(("loop_greedy", dataclasses.replace(
            cfg_on, loop=dataclasses.replace(cfg_on.loop, pose_graph=False))))
    runs = []
    for seed in seeds:
        t1 = time.perf_counter()
        res = runners.run_ba_sequence(frames, cfg_off, gt_poses=None, seed=seed,
                                      batch=batch, pipeline_depth=2, device=device)
        run = {"course": course, "seed": seed, "frames": len(gt), "trajectory_length_m": length,
               "keyframes": len(store), "keyframe_stride": store.stride,
               "loop_off": {**score_loop(res.trajectory, gt, length),
                            "windows_reverted": int(res.per_frame["window_reverted"].sum()),
                            "wall_s": time.perf_counter() - t1}}
        for name, cfg in modes:
            stats: dict = {}
            t2 = time.perf_counter()
            traj, loops = runners._loop_stage(res.trajectory, store, cfg, seed, None,
                                              device=device, stats=stats)
            run[name] = {**score_loop(traj, gt, length), "loops": loops_report(loops),
                         "stats": stats, "wall_s": time.perf_counter() - t2}
        runs.append(run)
    return runs


def run_drift(frames: list, device=None) -> dict:
    """The drift-injected fixture (module docstring) on the out-and-back
    course's rendered ``frames``, seed 0. Returns its report: the position
    RMSE before and after, the loops and the stage's stats."""
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.geometry import camera
    from epivo_tpu_torch.pipeline import config as pc, loopclose, runners

    gt = photoreal.loop_trajectory()
    cfg = ba_config(pc, camera, DRIFT, enabled=True)
    est = drift_chain(gt)
    store = keyframes(loopclose, frames, cfg)
    stats: dict = {}
    t0 = time.perf_counter()
    traj, loops = runners._loop_stage(est, store, cfg, 0, None, device=device, stats=stats)
    return {"fixture": "drift", "seed": 0, "ate_before_m": position_rmse(est, gt),
            "ate_after_m": position_rmse(traj, gt), "loops": loops_report(loops),
            "stats": stats, "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0", help="comma list of RANSAC seeds")
    ap.add_argument("--courses", default=",".join(COURSES))
    ap.add_argument("--drift", action="store_true", help="also the drift-injected fixture")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8, help="render processes")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import subprocess

    import torch

    on_card = args.device in (None, "cuda") and torch.cuda.is_available()
    card = None
    if on_card:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {"card": card, "device": str(args.device or "cuda"), "runs": []}
    for course in args.courses.split(","):
        t0 = time.perf_counter()
        frames = render_loop(course, args.workers)[0]
        render_s = time.perf_counter() - t0
        for run in run_course(course, frames, seeds, args.batch, args.device):
            run.update(card=card, render_s=render_s)
            print(json.dumps(run), flush=True)
            summary["runs"].append({k: run[k] for k in ("course", "seed")}
                                   | {m: {k: run[m][k] for k in (
                                       "ate_sim3_pct_of_length", "endpoint_gap_gauge0_m",
                                       "length_ratio_gauge0")} for m in run
                                      if m.startswith("loop_")})
        if args.drift and course == "out-and-back":
            drift = run_drift(frames, args.device)
            drift["card"] = card
            print(json.dumps(drift), flush=True)
            summary["drift"] = {k: drift[k] for k in ("ate_before_m", "ate_after_m")}
        del frames
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
