"""The JAX package's accuracy, on the CPU, where ``chip_smoke.py`` holds
the port to it. Its commands print JSON lines and write nothing but the
pair files ``--save-pairs`` asks for:

- ``orb-pose``: ``vo_step_orb`` on the corridor pair of ``chip_smoke.py``
  (``corridor_sequence(2, H=376, W=1241, seed=0)``, the bench
  configuration), single scale and on the 8-level pyramid, at each RANSAC
  seed: |R - R_gt|_F and the translation-direction error;
- ``five-point``: ``vo_step`` with the 5-point solver
  (``RansacConfig(solver="5pt")``) on the same pair and configuration, at
  each RANSAC seed, the same errors; jitted, or with ``--eager`` under
  ``jax.disable_jit()`` (each line says which);
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
- ``global``: the same back half with the global-BA polish
  (``GlobalBAConfig(enabled=True)``) off and then on, on each file's
  pairs, in both packages: the paired Sim(3) ATE delta (on - off) and
  length ratios;
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
    python -m tests.reference_accuracy five-point --seeds 0-43 [--eager]
    python -m tests.reference_accuracy global --pairs DIR/pairs_seed0.npz ...
- ``loop``: loop closure on the photoreal loop courses, in the form of
  the port's ``tools/photoreal_loop.py`` (the same frames, rendered by
  the port's renderer, configuration and scoring): for each ``--course``
  (``out-and-back``, ``offset``, ``two-lap``) and seed,
  ``run_ba_sequence`` with no ground truth and loop closure off, then the
  loop stage (``runners._loop_stage``) on that trajectory with the
  keyframes the runner's tee keeps (the two-lap course also in greedy
  mode); ``--course drift``: the drift-injected fixture, ``close_loops``
  on the out-and-back ground truth with the tool's per-step drift.

- ``kitti-cli``: the JAX package's KITTI CLI (``scripts/run_kitti.py
  --platform cpu --mode vo``, LMedS with the ground truth's step lengths)
  on the tree ``chip_smoke.py``'s phase 14 writes: the corridor's first
  ``--frames`` frames (64 there) rounded to uint8 as
  ``sequences/00/image_0/*.png`` (``chip_smoke.kitti_tree``, in a
  temporary directory), at phase 9's frontend settings (FAST 30, 512
  keypoints, batches of 32 pairs): its summary, and its ATE as a
  percentage of the trajectory's length. The CLI takes no seed.

- ``demo-scenes``: the two-view KLT demo on scenes drawn with numpy
  (``synthetic_vo_demo.numpy_scene(seed)``) through both packages: the
  JAX package's ``examples/synthetic_vo_demo.py`` (its ``main``, with its
  two ``jax.random.uniform`` draws answered by the numpy scene's, so the
  scene is bit-equal) and the port's ``tools/synthetic_vo_demo.py
  --scene-seed``, each on the CPU: E-pose and LM-pose errors and the
  demo's verdict (LM rotation < 0.02, direction < 0.05), per seed.

    python -m tests.reference_accuracy stereo --frames 60 --seeds 0-3
    python -m tests.reference_accuracy loop --course out-and-back --seeds 0-3
    python -m tests.reference_accuracy kitti-cli --frames 64
    python -m tests.reference_accuracy demo-scenes --seeds 0-3
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


def corridor_pair():
    """The corridor pair of ``chip_smoke.py`` at the bench configuration:
    (f0, f1 as jnp arrays, the reference's VOConfig, the ground-truth
    relative pose source -> target)."""
    import jax.numpy as jnp

    from epivo_tpu.datasets import photoreal
    from epivo_tpu.geometry.camera import Pinhole
    from epivo_tpu.pipeline import config as jc

    H, W = 376, 1241
    frames, gt, _ = photoreal.corridor_sequence(2, H=H, W=W, seed=0)
    f0, f1 = (jnp.asarray(np.asarray(f, np.float32)) for f in frames)
    cfg = jc.VOConfig(
        camera=Pinhole(fx=718.856, fy=718.856, cx=W / 2.0, cy=H / 2.0, width=W, height=H),
        frontend=jc.FrontendConfig(fast_threshold=40.0, max_keypoints=512, klt_window=21,
                                   klt_levels=4, klt_iters=12),
        ransac=jc.RansacConfig(n_hyp=512, refine_e=True), lm=jc.LMConfig(n_points=48))
    return f0, f1, cfg, np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])


def _pose_row(T, T_gt) -> dict:
    T = np.asarray(T, np.float64)
    d_gt = T_gt[:3, 3] / np.linalg.norm(T_gt[:3, 3])
    return {"rot": float(np.linalg.norm(T[:3, :3] - T_gt[:3, :3])),
            "dir": float(np.linalg.norm(T[:3, 3] / np.linalg.norm(T[:3, 3]) - d_gt))}


def orb_pose(seeds) -> None:
    import jax

    from epivo_tpu.pipeline import vo

    f0, f1, cfg, T_gt = corridor_pair()
    for pyramid in (False, True):
        c = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                  orb_pyramid=pyramid))
        for seed in seeds:
            r = vo.vo_step_orb(f0, f1, jax.random.PRNGKey(seed), c)
            print(json.dumps({"pyramid": pyramid, "seed": seed, **_pose_row(r.T, T_gt),
                              "matches": int(r.n_tracked)}), flush=True)


def five_point_pose(seeds, eager: bool) -> None:
    """``vo_step`` with ``RansacConfig(solver="5pt")`` on the corridor pair
    at each RANSAC seed: jitted, or with ``eager`` under
    ``jax.disable_jit()`` (the 5-point solver's compile can take longer
    than a run of eager steps). Each line says which it ran."""
    import contextlib

    import jax

    from epivo_tpu.pipeline import vo

    f0, f1, cfg, T_gt = corridor_pair()
    cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac, solver="5pt"))
    with jax.disable_jit() if eager else contextlib.nullcontext():
        for seed in seeds:
            t0 = time.perf_counter()
            r = vo.vo_step(f0, f1, jax.random.PRNGKey(seed), cfg)
            row = _pose_row(r.T, T_gt)
            print(json.dumps({"seed": seed, "mode": "eager" if eager else "jit", **row,
                              "n_inliers": int(r.n_inliers), "reverted": bool(r.reverted),
                              "wall_s": time.perf_counter() - t0}), flush=True)


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


def global_cmd(paths, n_frames: int) -> None:
    """The global-BA polish's paired effect on saved pairs: for each file,
    each package's back half (:func:`back_half`) with the polish off and
    then on, on the same pairs. Prints the Sim(3) ATE, length ratio and
    wall seconds of both runs and the paired delta (on - off, percentage
    points of the length)."""
    from epivo_tpu.pipeline import runners as jrunners
    from epivo_tpu.pipeline.config import GlobalBAConfig
    from epivo_tpu_torch import convert
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.pipeline import runners as trunners
    from epivo_tpu_torch.tools import photoreal_ate

    _, gt, _ = photoreal.corridor_sequence(n_frames, **photoreal_ate.FIXTURE)  # frames lazy
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    cfg_off = corridor_ba_config()
    cfg_on = dataclasses.replace(cfg_off, global_ba=GlobalBAConfig(enabled=True))
    for path in paths:
        pairs = trunners._unpack_pairs(dict(np.load(path)))
        for name, mod, conv, kw in (("reference", jrunners, lambda c: c, {}),
                                    ("port", trunners, convert.config_from_reference,
                                     {"device": "cpu"})):
            row = {"pairs": path, "back_half": name}
            for tag, cfg in (("off", cfg_off), ("on", cfg_on)):
                t0 = time.perf_counter()
                res = back_half(mod, n_frames, conv(cfg), pairs, **kw)
                row[tag] = {**photoreal_ate.score_no_gt(np.asarray(res.trajectory), gt,
                                                        length),
                            "wall_s": time.perf_counter() - t0}
            row["delta_pp"] = (row["on"]["ate_sim3_pct_of_length"]
                               - row["off"]["ate_sim3_pct_of_length"])
            print(json.dumps(row), flush=True)


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


def loop(course: str, seeds, batch: int, workers: int) -> None:
    import dataclasses

    import jax

    from epivo_tpu.geometry import camera
    from epivo_tpu.pipeline import config as jc, loopclose, runners
    from epivo_tpu_torch.tools import photoreal_loop as pl

    t0 = time.perf_counter()
    frames, gt, _, length = pl.render_loop("out-and-back" if course == "drift" else course,
                                           workers)
    render_s = time.perf_counter() - t0
    platform = jax.devices()[0].platform
    if course == "drift":
        cfg = pl.ba_config(jc, camera, pl.DRIFT, enabled=True)
        est = pl.drift_chain(gt)
        store = pl.keyframes(loopclose, frames, cfg)
        for seed in seeds:
            t1 = time.perf_counter()
            traj, loops = runners._loop_stage(est, store, cfg, seed, None)
            print(json.dumps({"fixture": "drift", "seed": seed, "platform": platform,
                              "ate_before_m": pl.position_rmse(est, gt),
                              "ate_after_m": pl.position_rmse(traj, gt),
                              "loops": pl.loops_report(loops),
                              "wall_s": time.perf_counter() - t1}), flush=True)
        return
    cfg_off, cfg_on = (pl.ba_config(jc, camera, enabled=on) for on in (False, True))
    store = pl.keyframes(loopclose, frames, cfg_on)
    modes = [("loop_on", cfg_on)]
    if course == "two-lap":
        modes.append(("loop_greedy", dataclasses.replace(
            cfg_on, loop=dataclasses.replace(cfg_on.loop, pose_graph=False))))
    for seed in seeds:
        t1 = time.perf_counter()
        res = runners.run_ba_sequence(frames, cfg_off, gt_poses=None, seed=seed, batch=batch)
        run = {"course": course, "seed": seed, "platform": platform, "frames": len(gt),
               "trajectory_length_m": length, "render_s": render_s,
               "keyframes": len(store), "keyframe_stride": store.stride,
               "loop_off": {**pl.score_loop(np.asarray(res.trajectory), gt, length),
                            "windows_reverted": int(res.per_frame["window_reverted"].sum()),
                            "wall_s": time.perf_counter() - t1}}
        for name, cfg in modes:
            t2 = time.perf_counter()
            traj, loops = runners._loop_stage(np.asarray(res.trajectory), store, cfg, seed,
                                              None)
            run[name] = {**pl.score_loop(np.asarray(traj), gt, length),
                         "loops": pl.loops_report(loops), "wall_s": time.perf_counter() - t2}
        print(json.dumps(run), flush=True)


def kitti_cli(n_frames: int, batch: int, workers: int) -> None:
    import contextlib
    import importlib.util
    import io
    import sys
    import tempfile

    import jax

    import chip_smoke
    from epivo_tpu_torch.tools import photoreal_ate

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames, gt, K, length = photoreal_ate.render_corridor(n_frames, workers=workers)
    spec = importlib.util.spec_from_file_location(
        "run_kitti_cli", os.path.join(repo, "scripts", "run_kitti.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.kitti_tree(tmp, frames, gt, K)
        argv = ["run_kitti.py", "--root", tmp, "--mode", "vo", "--platform", "cpu",
                "--batch", str(batch), "--fast-threshold", "30", "--max-keypoints", "512",
                "--out", os.path.join(tmp, "out")]
        t0 = time.perf_counter()
        old, sys.argv = sys.argv, argv
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main()
        finally:
            sys.argv = old
        with open(os.path.join(tmp, "out", "summary.json")) as f:
            summary = json.load(f)
    print(json.dumps({"command": "kitti-cli", "platform": jax.devices()[0].platform,
                      "frames": n_frames, "trajectory_length_m": length,
                      "ate_pct_of_length": 100.0 * summary["ate_m"] / length,
                      "summary": summary, "wall_s": time.perf_counter() - t0}), flush=True)


DEMO_ERRORS = r"(E-pose|LM-pose|ORB-pose)\s*: \|R-R_gt\|=([0-9.]+)  \|t_dir err\|=([0-9.]+)"


def demo_errors(text: str) -> dict:
    """The errors a synthetic demo printed: {"E-pose": [rot, dir],
    "LM-pose": [rot, dir]} (also "ORB-pose"), and its "RESULT ok=" word."""
    import re

    out = {m[0]: [float(m[1]), float(m[2])]
           for m in re.findall(DEMO_ERRORS, text)}
    ok = re.search(r"RESULT ok=(\S+)", text)
    out["result"] = ok.group(1) if ok else None
    return out


def run_jax_example(name: str, argv: list, draws=None) -> tuple[int, str]:
    """``examples/<name>.py``'s ``main`` in this process with ``argv``
    (its module parses them when it is loaded), on the platform this
    process's JAX uses (the CPU here and in the tests): its exit status
    and standard output. ``draws``, where given, answers the example's
    ``jax.random.uniform`` calls in order (numpy arrays), the keys staying
    the example's own."""
    import contextlib
    import importlib.util
    import io
    import sys
    import types

    import jax
    import jax.numpy as jnp

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(repo, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    old, sys.argv = sys.argv, [f"{name}.py", *argv]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = old
    if draws is not None:
        it = iter(draws)
        mod.jax = types.SimpleNamespace(random=types.SimpleNamespace(
            PRNGKey=jax.random.PRNGKey, split=jax.random.split,
            uniform=lambda key, shape, minval, maxval: jnp.asarray(next(it))))
    buf, code = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            mod.main()
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def demo_scenes(seeds) -> None:
    import contextlib
    import io

    import torch

    from epivo_tpu_torch.tools import synthetic_vo_demo

    for seed in seeds:
        t0 = time.perf_counter()
        _, jax_text = run_jax_example("synthetic_vo_demo", [],
                                      draws=synthetic_vo_demo.numpy_draws(seed))
        jax_s = time.perf_counter() - t0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            synthetic_vo_demo.main(["--device", "cpu", "--scene-seed", str(seed)])
        print(json.dumps({"command": "demo-scenes", "seed": seed,
                          "jax": demo_errors(jax_text), "port": demo_errors(buf.getvalue()),
                          "jax_wall_s": jax_s, "port_wall_s": time.perf_counter() - t0,
                          "torch_threads": torch.get_num_threads()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=("orb-pose", "five-point", "turn", "sequence",
                                        "back-half", "global", "stereo", "loop",
                                        "kitti-cli", "demo-scenes"))
    ap.add_argument("--seeds", default="0", help="comma list, or a range lo-hi")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per call (default: 32, stereo 8)")
    ap.add_argument("--workers", type=int, default=4, help="render processes")
    ap.add_argument("--save-pairs", default=None, metavar="DIR",
                    help="sequence, stereo: write each seed's pairs under DIR")
    ap.add_argument("--pairs", nargs="*", default=(),
                    help="back-half, global: saved pair files")
    ap.add_argument("--eager", action="store_true",
                    help="five-point: run the step under jax.disable_jit()")
    ap.add_argument("--course", default="out-and-back",
                    choices=("out-and-back", "offset", "two-lap", "drift"), help="loop")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    seeds = _seeds(args.seeds)
    if args.command == "orb-pose":
        orb_pose(seeds)
    elif args.command == "five-point":
        five_point_pose(seeds, args.eager)
    elif args.command == "global":
        global_cmd(args.pairs, args.frames)
    elif args.command == "turn":
        turn(seeds)
    elif args.command == "sequence":
        sequence(seeds, args.frames, args.batch or 32, args.workers, args.save_pairs)
    elif args.command == "stereo":
        stereo(seeds, args.frames, args.batch or 8, args.workers, args.save_pairs)
    elif args.command == "loop":
        loop(args.course, seeds, args.batch or 32, args.workers)
    elif args.command == "kitti-cli":
        kitti_cli(args.frames, args.batch or 32, args.workers)
    elif args.command == "demo-scenes":
        demo_scenes(seeds)
    else:
        back_half_cmd(args.pairs, args.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
