"""End-to-end throughput of ``runners.run_vo_sequence`` (the port's
counterpart of ``scripts/bench_runner.py``).

Measures what the sequence runner sustains end to end (host batching,
upload, dispatch ``pipeline_depth`` batches ahead, the packed
device-to-host fetch, no checkpoints, no cloud) over frames rendered
ahead of time and held in memory: the photoreal corridor
(``corridor_sequence(--frames, H=376, W=1241, seed=0)``) at the bench
configuration (``bench.py``'s: FAST 40, 512 keypoints, 4 KLT levels,
512 hypotheses, 48 LM points). The render is fixture generation, not
pipeline work, and is left out. For each batch size and depth: one warm
run on ``batch + 1`` frames, then ``--repeats`` timed runs (host clock,
the result fetched to the host), reported as pairs/s of the fastest and
every wall time.

Writes one JSON object to ``--out`` (default
``chiprun_out/runner_bench.json``) and prints it, with the card's name
and power limit (``nvidia-smi``). ``--device`` is ``cuda`` (the default;
it raises without a card) or ``cpu`` (for a rehearsal; its times are CPU
times).

    python -m epivo_tpu_torch.tools.bench_runner [--frames 129] [--batches 8,32,64]
        [--depths 1,2,4] [--repeats 2] [--out chiprun_out/runner_bench.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

H, W = 376, 1241


def bench_config():
    """The bench configuration (``bench.py``'s ``_config``)."""
    from epivo_tpu_torch.geometry.camera import Pinhole
    from epivo_tpu_torch.pipeline.config import (FrontendConfig, LMConfig, RansacConfig,
                                                 VOConfig)

    return VOConfig(
        camera=Pinhole(fx=718.856, fy=718.856, cx=W / 2.0, cy=H / 2.0, width=W, height=H),
        frontend=FrontendConfig(fast_threshold=40.0, max_keypoints=512, klt_window=21,
                                klt_levels=4, klt_iters=12),
        ransac=RansacConfig(n_hyp=512, refine_e=True),
        lm=LMConfig(n_points=48),
    )


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reads them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]


def main(argv=None) -> dict:
    from epivo_tpu_torch._device import runner_device
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.pipeline import runners

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=129)
    ap.add_argument("--batches", default="8,32,64")
    ap.add_argument("--depths", default="1,2,4")
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed runs per batch and depth; the fastest is reported")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "runner_bench.json"))
    args = ap.parse_args(argv)
    dev = runner_device(args.device)

    cfg = bench_config()
    gen, gt, _ = photoreal.corridor_sequence(args.frames, H=H, W=W, seed=0)
    t0 = time.perf_counter()
    frames = [np.asarray(f, np.float32) for f in gen]
    render_s = time.perf_counter() - t0

    runs, ate = [], None
    for batch in (int(b) for b in args.batches.split(",")):
        runners.run_vo_sequence(frames[:batch + 1], cfg, batch=batch, collect_cloud=False,
                                device=dev)
        n_dispatch = -(-(len(frames) - 1) // batch)
        for depth in (int(d) for d in args.depths.split(",")):
            walls = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                res = runners.run_vo_sequence(frames, cfg, gt_poses=gt, batch=batch,
                                              collect_cloud=False, pipeline_depth=depth,
                                              device=dev)
                walls.append(time.perf_counter() - t0)
            wall = min(walls)
            ate = float(res.ate)
            runs.append({"batch": batch, "pipeline_depth": depth,
                         "pairs_per_s": (len(frames) - 1) / wall,
                         "wall_s_all_repeats": walls, "n_dispatches": n_dispatch,
                         "s_per_dispatch": wall / n_dispatch})
            print(json.dumps(runs[-1]), flush=True)

    out = {
        "runner": "run_vo_sequence", "frames": len(frames), "image": [H, W],
        "device": device_name(dev), "torch": torch.__version__,
        "runs": runs, "best": max(runs, key=lambda r: r["pairs_per_s"]),
        "ate_m": ate, "render_s": render_s,
        "config": {"repeats": args.repeats, "collect_cloud": False, "n_hyp": 512,
                   "max_keypoints": 512, "n_points": 48},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
