"""The JAX package's accuracy, on the CPU, where ``chip_smoke.py`` holds
the port to it. Three commands, each printing JSON lines and writing
nothing:

- ``orb-pose``: ``vo_step_orb`` on the corridor pair of ``chip_smoke.py``
  (``corridor_sequence(2, H=376, W=1241, seed=0)``, the bench
  configuration), single scale and on the 8-level pyramid, at each RANSAC
  seed: |R - R_gt|_F and the translation-direction error;
- ``turn``: ``_extract_pairs`` on the turn pair of
  ``tests/test_runners_datasets.py``'s slow fallback test
  (``loop_trajectory`` frames 80 -> 81, 188x1241) with the ORB retry off
  and on, at each seed: the rotation angle and the inliers;
- ``sequence``: ``run_ba_sequence`` with no ground truth on the 300-frame
  corridor, in the form of the port's ``tools/photoreal_ate.py``: the
  same frames (drawn by the port's renderer, which
  ``tests/test_torch_sequences.py`` holds bit-equal to the JAX package's
  ``corridor_sequence``), configuration and batch of 32 pairs (those of
  ``scripts/run_photoreal_ate.py``) and the port's scoring
  (``score_no_gt``, ``pair_accuracy``). About a quarter of an hour of CPU
  time per seed. ``--save-pairs DIR`` writes each seed's extracted pairs
  to ``DIR/pairs_seed<s>.npz``;
- ``back-half``: the windowed-BA half of that run (scale graph, window
  solve, scale injection) through both packages on the same saved pairs
  (``--pairs``: files of ``sequence --save-pairs`` or of
  ``python -m epivo_tpu_torch.tools.photoreal_ate --save-pairs``), with no
  extraction: Sim(3) ATE and length ratio per file and package, so a
  trajectory gap between the packages can be put on the pairs or on what
  follows them. Seconds per file;
- ``stereo``: ``run_stereo_ba_sequence`` on the photoreal stereo corridor
  (``corridor_stereo_sequence(--frames, seed=3)``) at the configuration
  of ``scripts/run_photoreal_stereo.py`` and a batch of 8 pairs, in the
  form of the port's ``tools/photoreal_stereo.py``: the same frames
  (rendered once by the port's renderer, bit-equal to the JAX package's
  generators), metric ATE, length ratio, step-length errors, windows
  reverted, pairs retried and replaced by ORB, Hampel replacements, the
  stages' wall seconds, the frame stream's ``peak_buffered`` and the
  process's peak RSS. ``--save-pairs DIR`` writes each seed's extracted
  pairs to ``DIR/stereo_pairs_seed<s>.npz``.

    python -m tests.reference_accuracy orb-pose --seeds 0-43
    python -m tests.reference_accuracy turn --seeds 0-9
    python -m tests.reference_accuracy sequence --seeds 0,1,2 [--save-pairs DIR]
    python -m tests.reference_accuracy back-half --pairs DIR/pairs_seed0.npz ...
    python -m tests.reference_accuracy stereo --frames 60 --seeds 0-3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def _seeds(text: str) -> list:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def orb_pose(seeds) -> None:
    import jax
    import jax.numpy as jnp

    from epivo_tpu.datasets import photoreal
    from epivo_tpu.geometry.camera import Pinhole
    from epivo_tpu.pipeline import config as jc, vo

    H, W = 376, 1241
    frames, gt, _ = photoreal.corridor_sequence(2, H=H, W=W, seed=0)
    f0, f1 = (jnp.asarray(np.asarray(f, np.float32)) for f in frames)
    cfg = jc.VOConfig(
        camera=Pinhole(fx=718.856, fy=718.856, cx=W / 2.0, cy=H / 2.0, width=W, height=H),
        frontend=jc.FrontendConfig(fast_threshold=40.0, max_keypoints=512, klt_window=21,
                                   klt_levels=4, klt_iters=12),
        ransac=jc.RansacConfig(n_hyp=512, refine_e=True), lm=jc.LMConfig(n_points=48))
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    d_gt = T_gt[:3, 3] / np.linalg.norm(T_gt[:3, 3])
    for pyramid in (False, True):
        c = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                  orb_pyramid=pyramid))
        for seed in seeds:
            r = vo.vo_step_orb(f0, f1, jax.random.PRNGKey(seed), c)
            T = np.asarray(r.T, np.float64)
            print(json.dumps({"pyramid": pyramid, "seed": seed,
                              "rot": float(np.linalg.norm(T[:3, :3] - T_gt[:3, :3])),
                              "dir": float(np.linalg.norm(T[:3, 3] / np.linalg.norm(T[:3, 3])
                                                          - d_gt)),
                              "matches": int(r.n_tracked)}), flush=True)


def turn(seeds) -> None:
    from epivo_tpu.datasets import photoreal
    from epivo_tpu.geometry import camera
    from epivo_tpu.pipeline import runners, stream
    from epivo_tpu.pipeline.config import FrontendConfig, LMConfig, RansacConfig, VOConfig

    H, W, f, k0 = 188, 1241, 718.856, 80
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    gt = photoreal.loop_trajectory()
    scene = photoreal.CorridorScene()
    tex = scene.textures()
    rng = np.random.default_rng(7)
    frames = [photoreal.render_frame(scene, tex, K, gt[k], H, W, noise_sigma=2.0, rng=rng)
              for k in (k0, k0 + 1)]
    on = VOConfig(camera=camera.Pinhole(f, f, W / 2.0, H / 2.0, W, H),
                  frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=256, klt_levels=4),
                  ransac=RansacConfig(n_hyp=256), lm=LMConfig(n_points=32))
    off = dataclasses.replace(on, frontend=dataclasses.replace(on.frontend,
                                                               orb_fallback_frac=0.0))
    angle = lambda R: float(np.degrees(np.arccos(np.clip((np.trace(np.asarray(R)[:3, :3]) - 1)
                                                         / 2, -1, 1))))
    print(json.dumps({"true_deg": angle(np.linalg.inv(gt[k0 + 1]) @ gt[k0])}))
    for seed in seeds:
        row = {"seed": seed}
        for name, c in (("off", off), ("on", on)):
            pd = runners._extract_pairs(stream.FrameStream(list(frames)), [(0, 1)], c, seed,
                                        n_points=32, batch=2)
            row[name] = {"deg": angle(pd[(0, 1)]["T"]), "n_inl": pd[(0, 1)]["n_inl"]}
        print(json.dumps(row), flush=True)


def corridor_ba_config():
    """The reference's BAConfig of the corridor runs
    (``scripts/run_photoreal_ate.py``'s BA block)."""
    from epivo_tpu.geometry import camera
    from epivo_tpu.pipeline.config import (
        BAConfig, FrontendConfig, GlobalBAConfig, LMConfig, RansacConfig,
    )

    return BAConfig(camera=camera.KITTI_00,
                    frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512,
                                            klt_levels=4),
                    ransac=RansacConfig(n_hyp=512),
                    lm=LMConfig(n_points=32, revert_r_norm=1e-2),
                    global_ba=GlobalBAConfig(enabled=False))


def back_half(runners, n_frames: int, config, pair_data: dict, gt_poses=None, **kw):
    """``runners.run_ba_sequence`` (either package's module) with its pair
    extraction replaced by ``pair_data``: the scale graph, the window
    solve and the scale injection run on the given pairs. ``kw`` goes to
    the runner (the port's ``device``)."""
    frames = [np.zeros((4, 4), np.float32)] * n_frames  # only counted
    extract = runners._extract_pairs
    runners._extract_pairs = lambda *a, **k: {p: dict(d) for p, d in pair_data.items()}
    try:
        return runners.run_ba_sequence(frames, config, gt_poses=gt_poses, **kw)
    finally:
        runners._extract_pairs = extract


def back_half_cmd(paths, n_frames: int) -> None:
    from epivo_tpu.pipeline import runners as jrunners
    from epivo_tpu_torch import convert
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.pipeline import runners as trunners
    from epivo_tpu_torch.tools import photoreal_ate

    _, gt, _ = photoreal.corridor_sequence(n_frames, **photoreal_ate.FIXTURE)  # frames lazy
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    cfg = corridor_ba_config()
    for path in paths:
        pairs = trunners._unpack_pairs(dict(np.load(path)))
        for name, mod, c, kw in (("reference", jrunners, cfg, {}),
                                 ("port", trunners, convert.config_from_reference(cfg),
                                  {"device": "cpu"})):
            res = back_half(mod, n_frames, c, pairs, **kw)
            print(json.dumps({"pairs": path, "back_half": name,
                              **photoreal_ate.score_no_gt(np.asarray(res.trajectory),
                                                          gt, length)}), flush=True)


def sequence(seeds, n_frames: int, batch: int, workers: int, save_pairs=None) -> None:
    import jax

    from epivo_tpu.pipeline import runners
    from epivo_tpu_torch.pipeline import runners as trunners
    from epivo_tpu_torch.tools import photoreal_ate

    frames, gt, _, length = photoreal_ate.render_corridor(n_frames, workers=workers)
    cfg = corridor_ba_config()
    seen = {}
    prepare = runners.prepare_mono_windows

    def keep_pairs(*a, **kw):
        win = prepare(*a, **kw)
        seen["pair_data"] = win.pair_data
        return win

    runners.prepare_mono_windows = keep_pairs
    for seed in seeds:
        t0 = time.perf_counter()
        res = runners.run_ba_sequence(frames, cfg, gt_poses=None, seed=seed, batch=batch)
        print(json.dumps({"seed": seed, "platform": jax.devices()[0].platform,
                          "frames": n_frames, "trajectory_length_m": length,
                          **photoreal_ate.score_no_gt(res.trajectory, gt, length),
                          "windows_reverted": int(res.per_frame["window_reverted"].sum()),
                          "pairs": photoreal_ate.pair_accuracy(seen["pair_data"], gt),
                          "wall_s": time.perf_counter() - t0}), flush=True)
        if save_pairs:
            os.makedirs(save_pairs, exist_ok=True)
            np.savez(os.path.join(save_pairs, f"pairs_seed{seed}.npz"),
                     **trunners._pack_pairs(seen["pair_data"]))


def stereo(seeds, n_frames: int, batch: int, workers: int, save_pairs=None) -> None:
    import multiprocessing
    import tempfile

    import jax

    from epivo_tpu.geometry.camera import Pinhole
    from epivo_tpu.pipeline import runners, stream
    from epivo_tpu.pipeline.config import BAConfig, FrontendConfig, LMConfig, RansacConfig
    from epivo_tpu_torch.pipeline import runners as trunners
    from epivo_tpu_torch.tools import photoreal_stereo as ps

    gt, K, T_rig, length = ps.stereo_fixture(n_frames)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        frames = tuple(list(ps.camera_frames(gt, K, ps.H, ps.W, right, pool))
                       for right in (False, True))
    render_s = time.perf_counter() - t0
    cfg = BAConfig(camera=Pinhole(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                  cy=float(K[1, 2]), width=ps.W, height=ps.H),
                   frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512,
                                           klt_levels=4),
                   ransac=RansacConfig(n_hyp=512),
                   lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    seen = {}
    extract, solve, frame_stream = (runners._extract_pairs, runners._solve_windows,
                                    stream.FrameStream)

    class Recorded(frame_stream):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["stream"] = self

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            seen[name + "_s"] = time.perf_counter() - t
            seen[name] = out
            return out
        return run

    runners._extract_pairs, runners._solve_windows = (timed("extract", extract),
                                                      timed("solve", solve))
    runners.stream.FrameStream = Recorded
    try:
        for seed in seeds:
            with tempfile.TemporaryDirectory() as tmp:
                log = os.path.join(tmp, "metrics.jsonl")
                t0 = time.perf_counter()
                res = runners.run_stereo_ba_sequence(*frames, cfg, T_rig=T_rig,
                                                     n_frames=n_frames, seed=seed,
                                                     batch=batch, pipeline_depth=2,
                                                     metrics_path=log)
                wall = time.perf_counter() - t0
                with open(log) as f:
                    recs = [json.loads(line) for line in f]
            orb = ([r for r in recs if r.get("stage") == "extract_orb_fallback"] or [{}])[0]
            scl = [r for r in recs if r.get("stage") == "stereo_scale"]
            print(json.dumps({
                "seed": seed, "platform": jax.devices()[0].platform, "frames": n_frames,
                "trajectory_length_m": length, "render_s": render_s,
                **ps.score_metric(np.asarray(res.trajectory), gt, length),
                "windows_reverted": int(res.per_frame["window_reverted"].sum()),
                "windows_total": int(res.per_frame["window_reverted"].size),
                "n_pairs": len(seen["extract"]), "n_retried": orb.get("n_retried", 0),
                "n_replaced": orb.get("n_replaced", 0),
                "n_hampel": sum(r["hampel_replaced"] for r in scl),
                "n_refined": sum(r["refined"] for r in scl),
                "extract_s": seen["extract_s"], "solve_s": seen["solve_s"], "wall_s": wall,
                "peak_buffered": seen["stream"].peak_buffered,
                "peak_rss_gb": ps.peak_rss_gb()}), flush=True)
            if save_pairs:
                os.makedirs(save_pairs, exist_ok=True)
                np.savez(os.path.join(save_pairs, f"stereo_pairs_seed{seed}.npz"),
                         **trunners._pack_pairs(seen["extract"]))
    finally:
        runners._extract_pairs, runners._solve_windows = extract, solve
        runners.stream.FrameStream = frame_stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=("orb-pose", "turn", "sequence", "back-half",
                                        "stereo"))
    ap.add_argument("--seeds", default="0", help="comma list, or a range lo-hi")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per call (default: 32, stereo 8)")
    ap.add_argument("--workers", type=int, default=4, help="render processes")
    ap.add_argument("--save-pairs", default=None, metavar="DIR",
                    help="sequence, stereo: write each seed's pairs under DIR")
    ap.add_argument("--pairs", nargs="*", default=(), help="back-half: saved pair files")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    seeds = _seeds(args.seeds)
    if args.command == "orb-pose":
        orb_pose(seeds)
    elif args.command == "turn":
        turn(seeds)
    elif args.command == "sequence":
        sequence(seeds, args.frames, args.batch or 32, args.workers, args.save_pairs)
    elif args.command == "stereo":
        stereo(seeds, args.frames, args.batch or 8, args.workers, args.save_pairs)
    else:
        back_half_cmd(args.pairs, args.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
