"""Metric accuracy and memory of the port's stereo sequence path on the
photoreal stereo corridor.

The KITTI-sized (376x1241) stereo corridor of ``datasets/photoreal.py``
(``corridor_stereo_sequence(F, seed=3)``: 0.54 m baseline, fx 718.856) at
the configuration of the JAX package's ``scripts/run_photoreal_stereo.py``:
FAST threshold 30, 512 keypoints, 4 KLT levels, 512 hypotheses, 32 LM
points (revert above 1e-2), batches of 8 pairs, pipeline depth 2. For each
RANSAC seed, ``run_stereo_ba_sequence`` with no ground truth fed:

- the metric ATE (SE(3) alignment, no scale), in m and in % of the
  trajectory's length, and the recovered over the true length;
- the relative step-length error |step / ground-truth step - 1|, median
  and worst;
- the windows reverted, the pairs extracted, retried by ORB (and how many
  of those are rig pairs) and replaced, the Hampel replacements;
- the runner's stages' host wall seconds, the frame stream's
  ``peak_buffered``, the process's peak RSS (and, once, its RSS before
  the first run) and, on the card, ``torch.cuda.max_memory_allocated``.

Frames are rendered in ``--workers`` processes, one chunk of ``--chunk``
frames ahead of the runner, and handed to the runner through one generator
per camera, so neither the renderer nor the runner holds the sequence.
Each camera's noise fields are drawn here in frame order from its own
generator (seed + 200 left, seed + 300 right), as the sequence draws them,
so every frame is bit-equal to ``corridor_stereo_sequence``'s. Each seed
renders the sequence again. Prints one JSON object.

    python -m epivo_tpu_torch.tools.photoreal_stereo --frames 240 --seeds 0,1,2
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import resource
import time

import numpy as np

from epivo_tpu_torch.tools.photoreal_ate import _render

H, W = 376, 1241
FIXTURE_SEED = 3
BASELINE = 0.54  # corridor_stereo_sequence's default, in float64 (T_rig holds float32)
NOISE_SIGMA = 2.0  # render_frame's default, which the stereo sequence keeps


def stereo_fixture(n_frames: int, h: int = H, w: int = W):
    """(gt [F, 4, 4], K, T_rig, trajectory length in m) of the corridor."""
    from epivo_tpu_torch.datasets import photoreal

    _, _, gt, K, T_rig = photoreal.corridor_stereo_sequence(n_frames, H=h, W=w,
                                                            seed=FIXTURE_SEED)
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    return gt, K, T_rig, length


def _jobs(gt, K, h: int, w: int, offset_x: float, rng_seed: int):
    """The render jobs of one camera, in frame order, with the noise field
    of each frame drawn from the camera's generator as it is consumed."""
    frng = np.random.default_rng(rng_seed)
    for f in range(len(gt)):
        T_wc = gt[f].copy()
        T_wc[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array([offset_x, 0.0, 0.0])
        yield (K, T_wc, h, w, 1.0 + 0.15 * np.sin(0.05 * f), 4.0 * np.sin(0.03 * f + 1.0),
               frng.normal(0.0, NOISE_SIGMA, (h, w)))


def camera_frames(gt, K, h: int, w: int, right: bool, pool=None, chunk: int = 16):
    """One camera's frames as ``corridor_stereo_sequence`` yields them,
    rendered ``chunk`` at a time in ``pool`` (None: in this process), one
    chunk ahead of the consumer."""
    jobs = _jobs(gt, K, h, w, BASELINE if right else 0.0,
                 FIXTURE_SEED + (300 if right else 200))
    if pool is None:
        for job in jobs:
            yield _render(job)
        return

    def submit():
        part = [job for _, job in zip(range(chunk), jobs)]
        return pool.map_async(_render, part, chunksize=1) if part else None

    ahead = submit()
    while ahead is not None:
        frames = ahead.get()
        ahead = submit()
        yield from frames


def configs(cam):
    """The BAConfig of ``scripts/run_photoreal_stereo.py`` on camera ``cam``."""
    from epivo_tpu_torch.pipeline.config import (
        BAConfig, FrontendConfig, LMConfig, RansacConfig,
    )

    return BAConfig(camera=cam,
                    frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512,
                                            klt_levels=4),
                    ransac=RansacConfig(n_hyp=512),
                    lm=LMConfig(n_points=32, revert_r_norm=1e-2))


def score_metric(traj: np.ndarray, gt: np.ndarray, length: float) -> dict:
    """A stereo trajectory scored as ``scripts/run_photoreal_stereo.py``
    scores it (metric ATE, no scale alignment, in % of ``length``), with
    the recovered over the true length of the span the trajectory covers
    (the windows may stop a frame short of the sequence) and the relative
    step-length errors beside it."""
    from epivo_tpu_torch.eval import metrics

    gt_aln = np.linalg.inv(gt[0])[None] @ gt[: traj.shape[0]]
    ate = float(metrics.ate_rmse(traj, gt_aln, align=True, with_scale=False))
    est_step = np.linalg.norm(np.diff(traj[:, :3, 3], axis=0), axis=-1)
    gt_step = np.linalg.norm(np.diff(gt_aln[:, :3, 3], axis=0), axis=-1)
    err = np.abs(est_step / gt_step - 1.0)
    return {"ate_metric_rmse_m": ate, "ate_pct_of_length": 100.0 * ate / length,
            "length_ratio": float(est_step.sum() / gt_step.sum()),
            "step_err_median": float(np.median(err)), "step_err_max": float(err.max())}


def report(res, gt, length: float) -> dict:
    """The numbers of one run (see the module docstring), the runner's
    ``stats`` among them."""
    st = dict(res.stats)
    retried = st.pop("retried", [])
    return {**score_metric(res.trajectory, gt, length),
            "windows_reverted": int(res.per_frame["window_reverted"].sum()),
            "windows_total": int(res.per_frame["window_reverted"].size),
            "n_retried_rig": sum(1 for i, j in retried if i % 2 == 0 and j == i + 1),
            "stats": st}


def run_seed(n_frames: int, seed: int, batch: int = 8, workers: int = 8, chunk: int = 16,
             device=None, frames=None) -> tuple[dict, object]:
    """One ``run_stereo_ba_sequence`` on the corridor. ``frames``: (left,
    right) lists to use; None renders them chunk by chunk. Returns (its
    report with the render's and the whole call's wall seconds; the
    runner's result)."""
    from epivo_tpu_torch.geometry.camera import Pinhole
    from epivo_tpu_torch.pipeline import runners

    gt, K, T_rig, length = stereo_fixture(n_frames)
    cfg = configs(Pinhole.from_K(K, W, H))
    t0 = time.perf_counter()
    pool = None
    if frames is None and workers > 1:
        pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        if frames is None:
            frames = tuple(camera_frames(gt, K, H, W, right, pool, chunk)
                           for right in (False, True))
        res = runners.run_stereo_ba_sequence(*frames, cfg, T_rig=T_rig, n_frames=n_frames,
                                             seed=seed, batch=batch, pipeline_depth=2,
                                             device=device)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    return {"seed": seed, **report(res, gt, length),
            "wall_s": time.perf_counter() - t0}, res


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # kB on Linux


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--seeds", default="0", help="comma list of RANSAC seeds")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=8, help="render processes")
    ap.add_argument("--chunk", type=int, default=16, help="frames rendered per chunk")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    on_card = args.device in (None, "cuda") and torch.cuda.is_available()
    length = stereo_fixture(args.frames)[3]
    out = {"frames": args.frames, "image": [H, W], "baseline_m": BASELINE,
           "trajectory_length_m": length,
           "decoded_sequence_gb": 2 * args.frames * H * W * 4 / 1e9,
           "device": torch.cuda.get_device_name(0) if on_card else str(args.device)}
    if on_card:
        torch.zeros(1, device="cuda").sum().item()  # the CUDA context, before any run
    out["rss_before_gb"] = peak_rss_gb()
    runs = []
    for s in args.seeds.split(","):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        run, _ = run_seed(args.frames, int(s), args.batch, args.workers, args.chunk,
                          device=args.device)
        run["peak_rss_gb"] = peak_rss_gb()
        if on_card:
            run["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs.append(run)
        print(json.dumps({"progress": run}), flush=True)
    out["runs"] = runs
    for key in ("ate_pct_of_length", "length_ratio", "step_err_median"):
        vals = [r[key] for r in runs]
        out[f"{key}_median"] = float(np.median(vals))
        out[f"{key}_spread"] = [min(vals), max(vals)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
