"""Run the VO / BA pipelines on a KITTI odometry sequence (the port's
counterpart of ``scripts/run_kitti.py``, with the same flags, defaults,
modes, artifacts and summary keys).

Frames stream from ``sequences/<seq>/image_0/*.png`` through the port's
native loader (:class:`epivo_tpu_torch.runtime.NativeLoader`; the
decoder it uses is printed on stderr). Modes:

- ``vo``: two-view VO (LMedS) with the ground truth's step lengths;
- ``ba``: windowed mono BA (``--global-ba``, ``--loop-close``);
- ``stereo``: windowed stereo BA on ``image_0`` / ``image_1`` with the
  rig from ``calib.txt``'s P0 / P1 (metric scale, no ground truth fed);
- ``gt``: triangulation against the ground-truth motion.

Artifacts in ``--out``: ``kitti.T``, ``est_kitti_format.txt``,
``kitti.GT``, ``pts.cld`` and ``lims`` (when there is a cloud),
``traj.png`` (skipped, with a note on stderr, where matplotlib is not
installed) and ``summary.json``, whose JSON is also printed.

``--device`` is ``cuda`` (the default; it raises without a card) or
``cpu``. ``--devices N`` starts N ranks (``parallel.multihost.spawn``,
``--backend`` nccl or gloo, by default nccl on cuda and gloo on cpu) and
splits the pair extraction and the window solve over the mesh
``(win=N/h, hyp=h)`` with h = ``--hyp-devices``; every rank runs the same
program and rank 0's result is written. NCCL needs one card per rank.

    python -m epivo_tpu_torch.tools.run_kitti --root /path/to/kitti_odometry --seq 00 \\
        --mode vo --frames 900 --out out/kitti00
    python -m epivo_tpu_torch.tools.run_kitti --root ... --seq 01 --mode ba
    python -m epivo_tpu_torch.tools.run_kitti --root ... --mode ba --devices 2 \\
        --device cpu --backend gloo
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--mode", choices=["vo", "ba", "stereo", "gt"], default="vo")
    ap.add_argument("--frames", type=int, default=None, help="limit frames")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None, help="artifact directory")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--fast-threshold", type=float, default=40.0)
    ap.add_argument("--max-keypoints", type=int, default=1024)
    ap.add_argument("--n-hyp", type=int, default=512)
    ap.add_argument("--checkpoint-every", type=int, default=256)
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to split the pair extraction and the BA window solve "
                         "over (0 = one process, no mesh); all modes")
    ap.add_argument("--hyp-devices", type=int, default=1,
                    help="factor the mesh as (win=devices/N, hyp=N): RANSAC hypotheses "
                         "inside each VO step split over the 'hyp' axis")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="with --devices: default nccl on cuda, gloo on cpu")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="dispatch batches in flight before fetching")
    ap.add_argument("--global-ba", action="store_true",
                    help="polish the windowed result with one joint full-trajectory BA "
                         "(ba mode)")
    ap.add_argument("--loop-close", action="store_true",
                    help="loop-closure post-stage: keyframe retrieval + verification + "
                         "drift spreading (ba mode)")
    return ap


def _inputs(args):
    """(sequence, stop frame, camera, ground truth or None) of the run."""
    from epivo_tpu_torch.datasets import kitti

    seq = kitti.KittiSequence(root=args.root, seq=args.seq)
    n = seq.n_frames()
    stop = min(n, args.start + args.frames) if args.frames else n
    try:
        gt = seq.load_poses()[args.start:stop]
    except OSError:
        gt = None
    return seq, stop, seq.intrinsics(), gt


def run(args, device, mesh=None):
    """The runner of ``args.mode`` on the sequence, on ``device`` (and
    ``mesh``). Returns its ``SequenceResult``."""
    from epivo_tpu_torch import runtime
    from epivo_tpu_torch.datasets import kitti
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, GlobalBAConfig,
                                                 LMConfig, LoopConfig, RansacConfig,
                                                 VOConfig)

    seq, stop, cam, gt = _inputs(args)
    out_dir = out_dir_of(args)
    fe = FrontendConfig(fast_threshold=args.fast_threshold, max_keypoints=args.max_keypoints)
    rc = RansacConfig(n_hyp=args.n_hyp, method="lmeds" if args.mode == "vo" else "ransac")
    paths = [seq.image_path(i) for i in range(args.start, stop)]
    frames = runtime.NativeLoader(paths, n_workers=3, capacity=args.batch + 2)
    metrics_path = os.path.join(out_dir, "metrics.jsonl") if args.metrics else None
    common = dict(batch=args.batch, pipeline_depth=args.pipeline_depth, mesh=mesh,
                  metrics_path=metrics_path, device=device)

    if args.mode == "vo":
        cfg = VOConfig(camera=cam, frontend=fe, ransac=rc,
                       lm=LMConfig(n_points=48, revert_r_norm=1e-4))
        return runners.run_vo_sequence(
            frames, cfg, gt_poses=gt, checkpoint_dir=os.path.join(out_dir, "ckpt"),
            checkpoint_every=args.checkpoint_every, **common)
    if args.mode == "gt":
        # GT-motion triangulation: validates the frontend and triangulation
        # without trusting estimation.
        cfg = VOConfig(camera=cam, frontend=fe, ransac=rc, lm=LMConfig(n_points=48))
        return runners.run_gt_triangulation_sequence(frames, cfg, gt_poses=gt, device=device)
    if args.mode == "ba":
        cfg = BAConfig(camera=cam, frontend=fe, ransac=rc,
                       lm=LMConfig(n_points=32, revert_r_norm=1e-2),
                       global_ba=GlobalBAConfig(enabled=args.global_ba),
                       loop=LoopConfig(enabled=args.loop_close))
        # Streamed: the loader feeds the runner's bounded frame stream.
        return runners.run_ba_sequence(frames, cfg, gt_poses=gt, n_frames=len(paths),
                                       **common)
    cfg = BAConfig(camera=cam, frontend=fe, ransac=rc,
                   lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    seq_r = kitti.KittiSequence(root=args.root, seq=args.seq, cam="image_1")
    paths_r = [seq_r.image_path(i) for i in range(args.start, stop)]
    return runners.run_stereo_ba_sequence(
        frames, runtime.NativeLoader(paths_r), cfg, T_rig=seq.stereo_baseline_T(),
        gt_poses=gt, n_frames=min(len(paths), len(paths_r)), **common)


def rank_program(dev, args):
    """One rank of ``--devices``: :func:`run` on the (win, hyp) mesh."""
    from epivo_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(n_win=args.devices // args.hyp_devices,
                              n_hyp=args.hyp_devices, device_type=dev.type)
    return run(args, dev, mesh)


def out_dir_of(args) -> str:
    return args.out or f"out/kitti{args.seq}_{args.mode}"


def write_artifacts(args, res, n_frames: int, device_type: str) -> dict:
    """The reference CLI's files in the artifact directory; returns the
    summary."""
    from epivo_tpu_torch.viz import export

    out_dir = out_dir_of(args)
    export.write_poses(os.path.join(out_dir, "kitti.T"), res.trajectory)
    export.write_kitti_format(os.path.join(out_dir, "est_kitti_format.txt"), res.trajectory)
    if res.gt_trajectory is not None:
        export.write_poses(os.path.join(out_dir, "kitti.GT"), res.gt_trajectory)
    if res.cloud.shape[0]:
        export.write_cloud(os.path.join(out_dir, "pts.cld"), res.cloud,
                           lims_path=os.path.join(out_dir, "lims"), limits=res.cloud_limits)
    export.plot_or_skip(
        os.path.join(out_dir, "traj.png"),
        {k: v for k, v in [("est", res.trajectory), ("gt", res.gt_trajectory)]
         if v is not None},
        cloud=res.cloud if res.cloud.shape[0] else None)
    summary = {
        "mode": args.mode, "seq": args.seq, "frames": int(n_frames),
        "ate_m": res.ate, "rpe_t": res.rpe_t,
        "config": {
            "batch": args.batch, "pipeline_depth": args.pipeline_depth,
            "devices": args.devices or 1, "global_ba": args.global_ba,
            "loop_close": args.loop_close, "n_hyp": args.n_hyp,
            "max_keypoints": args.max_keypoints, "platform": device_type,
        },
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    """Run the CLI; returns the runner's ``SequenceResult`` (rank 0's with
    ``--devices``). Exits with status 2 on a missing sequence, a missing
    ground truth in ``gt`` mode or a mesh that does not fit."""
    import torch

    from epivo_tpu_torch import runtime
    from epivo_tpu_torch._device import runner_device
    from epivo_tpu_torch.parallel import multihost

    args = parser().parse_args(argv)
    backend = args.backend or {"cuda": "nccl", "cpu": "gloo"}[args.device]
    if args.devices:
        if args.devices % args.hyp_devices:
            print(f"ERROR: --devices {args.devices} not divisible by --hyp-devices "
                  f"{args.hyp_devices}", file=sys.stderr)
            sys.exit(2)
        if (args.device == "cuda" and backend == "nccl"
                and args.devices > torch.cuda.device_count()):
            print(f"ERROR: --devices {args.devices} > {torch.cuda.device_count()} cards "
                  "(NCCL needs one card per rank; --backend gloo shares a card, "
                  "--device cpu runs CPU ranks)", file=sys.stderr)
            sys.exit(2)
    seq, stop, _, gt = _inputs(args)
    if not seq.exists():
        print(f"ERROR: sequence not found at {seq.image_dir}", file=sys.stderr)
        sys.exit(2)
    if gt is None:
        if args.mode == "gt":
            print("ERROR: --mode gt needs GT poses", file=sys.stderr)
            sys.exit(2)
        print("no GT poses found; monocular scale will be unit-norm")
    os.makedirs(out_dir_of(args), exist_ok=True)
    decoder = "native" if runtime.available() else f"pil ({runtime.build_error()})"
    print(f"decoder: {decoder}", file=sys.stderr)

    if args.devices:
        res = multihost.spawn(rank_program, args.devices, args, backend=backend,
                              device=args.device, timeout_s=float("inf"))[0]
        device_type = args.device
    else:
        dev = runner_device(args.device)
        res = run(args, dev)
        device_type = dev.type
    summary = write_artifacts(args, res, stop - args.start, device_type)
    print(json.dumps(summary))
    return res


if __name__ == "__main__":
    main()
