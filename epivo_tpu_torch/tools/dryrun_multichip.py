"""One distributed step of every multi-device path on N ranks, at tiny
shapes: the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip(n)``, with the same phases and shapes.

    # 4 gloo ranks on the CPU, mesh (win=2, hyp=2):
    python -m epivo_tpu_torch.tools.dryrun_multichip --ranks 4 --device cpu --backend gloo
    # one card per rank on NCCL; or 2 gloo ranks sharing one card:
    python -m epivo_tpu_torch.tools.dryrun_multichip --ranks 2 --device cuda --backend nccl
    python -m epivo_tpu_torch.tools.dryrun_multichip --ranks 2 --device cuda --backend gloo

The ranks are spawned here (``multihost.spawn``). The mesh gives the
``hyp`` axis 2 ranks when N is even and ``win`` the rest. Phases, each
checked on every rank:

1. RANSAC with its hypotheses split over ``hyp`` (32 per rank, threshold
   1e-4) on 32 synthetic matches: a finite E;
2. the window solve on a photoreal-derived workload (a 96x128 corridor of
   2N + 1 frames through the frontend: N windows), one rank's
   ``ba_windows`` against ``distributed_ba_step`` with every rank on
   ``win``: ``T_opt`` within 5e-3, the trajectory finite, windows/s;
2b. the sharded frontend: ``_extract_pairs`` of the corridor's 2N
   consecutive pairs with and without the ``win`` mesh: the median pose
   delta below 1e-2;
3. the constraint-sharded global BA on a synthetic 6-zeta chain, its
   constraints padded to a multiple of N with zero weight: finite poses.

The last line is ``dryrun_multichip ok: mesh=(win=.., hyp=..), ...``.
Times printed on the CPU are CPU times.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from epivo_tpu_torch.parallel import mesh as mesh_mod, multihost


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(dev: torch.device) -> dict:
    """The dry run's rank program; returns this rank's report."""
    from epivo_tpu_torch.datasets import photoreal, synthetic
    from epivo_tpu_torch.geometry.camera import Pinhole
    from epivo_tpu_torch.parallel import dist, global_ba
    from epivo_tpu_torch.pipeline import ba, runners, stream
    from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, LMConfig,
                                                 RansacConfig, VOConfig)

    n = torch.distributed.get_world_size()
    n_hyp = 2 if n % 2 == 0 else 1
    n_win = n // n_hyp
    mesh = mesh_mod.make_mesh(n_win, n_hyp, device_type=dev.type)
    bmesh = mesh_mod.make_mesh(n, 1, device_type=dev.type)
    report = {"n_win": n_win, "n_hyp": n_hyp}

    # --- Phase 1: RANSAC over the 'hyp' axis -------------------------------
    gen = torch.Generator().manual_seed(0)
    T = synthetic.random_pose(gen)
    _, p, p_t = synthetic.gen_points(gen, 32, T)
    if n_hyp > 1:
        rfn = dist.distributed_ransac_essential(mesh, n_hyp_per_device=32, threshold=1e-4)
        E, _ = rfn(torch.Generator(device=dev).manual_seed(1), p.to(dev), p_t.to(dev),
                   torch.ones(32, dtype=torch.bool, device=dev))
        if not torch.all(torch.isfinite(E)):
            raise AssertionError("phase 1: hyp-sharded RANSAC gave a non-finite E")

    # --- Phase 2: the window solve over 'win', photoreal-derived -----------
    Hs, Ws = 96, 128
    Kc = np.array([[110.0, 0, Ws / 2], [0, 110.0, Hs / 2], [0, 0, 1.0]])
    cam = Pinhole(fx=110.0, fy=110.0, cx=Ws / 2, cy=Hs / 2, width=Ws, height=Hs)
    Fn = 2 * n + 1  # ws 3, stride 2: one window per rank
    frames, gt, _ = photoreal.corridor_sequence(Fn, H=Hs, W=Ws, K=Kc, speed=0.45, seed=11)
    frames = [np.asarray(f, np.float32) for f in frames]
    cfg = BAConfig(camera=cam,
                   frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                           klt_levels=3),
                   ransac=RansacConfig(n_hyp=128),
                   lm=LMConfig(n_points=16, revert_r_norm=1e-2))
    win = runners.prepare_mono_windows(list(frames), cfg, gt_poses=gt, device=dev)
    W = win.T0s.shape[0]
    if W != n:
        raise AssertionError(f"phase 2: {W} windows for {n} ranks")
    args = [torch.from_numpy(a).to(dev) for a in (win.T0s, win.p, win.p_t, win.wreps,
                                                  win.pmask)]
    out1 = ba.ba_windows(args[0], win.spec, args[1], args[2], wreps=args[3],
                         pmask=args[4], config=cfg)
    step = dist.distributed_ba_step(bmesh, win.spec, cfg)
    out = step(*args)  # first call
    _sync(dev)
    t0 = time.perf_counter()
    out = step(*args)
    _sync(dev)
    dt = time.perf_counter() - t0
    d_T = float((out.T_opt - out1.T_opt).abs().max())
    if d_T > 5e-3 or out.trajectory.shape != (W * win.spec.n_zeta + 1, 4, 4) \
            or not torch.all(torch.isfinite(out.trajectory)):
        raise AssertionError(f"phase 2: 1-vs-{n} window solve {d_T:.3g} > 5e-3, or the "
                             f"trajectory {tuple(out.trajectory.shape)} is not finite")
    report.update(W=W, window_d_T=d_T, windows_per_s=W / dt,
                  windowed_r_norm=float(out.global_r_norm))

    # --- Phase 2b: the frontend with its pairs over 'win' ------------------
    vo_cfg = VOConfig(camera=cfg.camera, frontend=cfg.frontend, ransac=cfg.ransac,
                      lm=cfg.lm)
    cons = [(i, i + 1) for i in range(Fn - 1)]
    pd1 = runners._extract_pairs(stream.FrameStream(list(frames)), cons, vo_cfg, 0,
                                 n_points=16, batch=n, device=dev)
    t0 = time.perf_counter()
    pd_m = runners._extract_pairs(stream.FrameStream(list(frames)), cons, vo_cfg, 0,
                                  n_points=16, batch=n, mesh=bmesh, device=dev)
    dt_ex = time.perf_counter() - t0
    dTs = sorted(float(np.abs(pd_m[k]["T"] - pd1[k]["T"]).max()) for k in pd1)
    med = dTs[len(dTs) // 2]
    if set(pd_m) != set(pd1) or med >= 1e-2:
        raise AssertionError(f"phase 2b: median 1-vs-{n} pose delta {med:.3g} >= 1e-2")
    report.update(n_pairs=len(cons), extract_s=dt_ex, median_pose_delta=med,
                  bit_equal_pairs=sum(d == 0.0 for d in dTs))

    # --- Phase 3: global BA with its constraints over 'win' ----------------
    n_z = 6
    g_reps = [(i, i) for i in range(n_z)] + [(i, i + 1) for i in range(n_z - 1)]
    scene = synthetic.gen_scene_sequence(torch.Generator().manual_seed(7), N=8, n_zeta=n_z,
                                         reps=g_reps)
    R0 = scene.reps.shape[0]
    pad = (-R0) % n
    g_reps_pad = np.concatenate([scene.reps, np.zeros((pad, 2), np.int32)])
    ones = torch.ones((pad,) + tuple(scene.p.shape[1:]))
    g_res = global_ba.global_ba_solve(
        scene.T0s.to(dev), g_reps_pad, torch.cat([scene.p, ones]).to(dev),
        torch.cat([scene.p_t, ones]).to(dev),
        wreps=torch.cat([torch.ones(R0), torch.zeros(pad)]).to(dev), max_span=2,
        max_iters=3, cg_iters=8, huber_delta=1.0, mesh=bmesh)
    if not torch.all(torch.isfinite(g_res.T0s)):
        raise AssertionError("phase 3: the constraint-sharded global BA is not finite")
    report.update(global_ba_r_norm=float(g_res.r_norm), n_constraints=R0 + pad)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)
    backend = args.backend or {"cuda": "nccl", "cpu": "gloo"}[args.device]
    r = multihost.spawn(run, args.ranks, backend=backend, device=args.device)[0]
    n = args.ranks
    print(f"phase1: RANSAC over hyp={r['n_hyp']}"
          f"{'' if r['n_hyp'] > 1 else ' (skipped: an odd rank count)'}")
    print(f"phase2: 1-vs-{n} window-solve equality OK (atol=5e-3, photoreal-derived, "
          f"W={r['W']}, largest |dT| {r['window_d_T']:.3g}); sharded solve "
          f"{r['windows_per_s']:.1f} windows/s ({args.device}, {backend})")
    print(f"phase2b: sharded frontend OK ({r['n_pairs']} pairs over {n} ranks in "
          f"{r['extract_s']:.2f} s; median 1-vs-N pose delta {r['median_pose_delta']:.1e}, "
          f"{r['bit_equal_pairs']} of {r['n_pairs']} pairs bit-equal)")
    print(f"phase3: constraint-sharded global BA OK ({r['n_constraints']} constraints)")
    print(f"dryrun_multichip ok: mesh=(win={r['n_win']}, hyp={r['n_hyp']}), "
          f"windowed_r_norm={r['windowed_r_norm']:.3e}, "
          f"global_ba_r_norm={r['global_ba_r_norm']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
