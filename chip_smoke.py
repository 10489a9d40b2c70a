#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (epivo_tpu_torch) once on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the CUDA card, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels, compiled from epivo_tpu_torch/csrc/
   into build/epivo_tpu_torch/ (first use only);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the two-view VO step gives it, with both median times;
4. slice: vo_step on the KITTI-sized (376x1241) photoreal corridor pair at
   the bench configuration, counting kernel launches and checking the pose
   against the ground truth and against the plain path;
5. degenerate: textureless frames must still give a finite pose.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failed check raises and
exits non-zero without that line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 376, 1241
SEED = 7
# Kernel B3 (LK) sums in another order than its plain version: the
# tolerance on the tracked corner and on the mean residual.
LK_Q_ATOL = 1e-3  # px
LK_ERR_ATOL, LK_ERR_RTOL = 1e-3, 1e-4
# Kernel path vs plain path of the whole step, same RANSAC samples.
STEP_R_TOL, STEP_DIR_TOL = 2e-3, 2e-3
# Pose against the corridor's ground truth.
GT_R_TOL, GT_DIR_TOL = 0.01, 0.1


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> tuple[str, str]:
    _check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    return name, smi


def phase_build() -> None:
    from epivo_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {path.relative_to(_kernels.BUILD_DIR.parent.parent)}")
    for line in _kernels.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def corridor_pair(dev):
    from epivo_tpu_torch.datasets import photoreal

    frames, gt, _ = photoreal.corridor_sequence(2, H=H, W=W, seed=0)
    f0, f1 = (torch.from_numpy(np.asarray(f, np.float32)).to(dev) for f in frames)
    return f0, f1, gt


def phase_kernels(f0, f1) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    from epivo_tpu_torch.frontend import fast, image, klt

    dev = f0.device
    report = {}

    # B1: FAST score + NMS on both full frames; bit-equal.
    err = 0.0
    for img in (f0, f1):
        k = fast.fast_score_map_kernel(img, 40.0, nms=True)
        p = fast.nms3(fast.fast_score_map(img, 40.0))
        torch.cuda.synchronize()
        _check(torch.equal(k, p), "FAST kernel differs from plain")
        err = max(err, float((k - p).abs().max()))
    ms = cuda_ms(lambda: fast.fast_score_map_kernel(f0, 40.0, nms=True))
    plain_ms = cuda_ms(lambda: fast.nms3(fast.fast_score_map(f0, 40.0)))
    print(f"kernel fast: {H}x{W} bit-equal, max_abs_err={err}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report["fast"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # B2: window extraction at the main path's levels; bit-equal.
    pyr = image.build_pyramid(f0, 4)
    g = torch.Generator().manual_seed(SEED)
    err, times = 0.0, {}
    for S, lvl in ((46, 3), (34, 0)):
        img = pyr[lvl]
        for B in (1, 8):
            imgs = img[None].expand(B, -1, -1).contiguous()
            Hl, Wl = img.shape
            oy = torch.randint(0, Hl - S + 1, (B, 512), generator=g).to(dev)
            ox = torch.randint(0, Wl - S + 1, (B, 512), generator=g).to(dev)
            k = klt.extract_windows_kernel(imgs, oy, ox, S)
            p = klt.extract_windows_plain(imgs, oy, ox, S)
            torch.cuda.synchronize()
            _check(torch.equal(k, p), f"extract kernel differs (S={S}, B={B})")
            err = max(err, float((k - p).abs().max()))
            t_k = cuda_ms(lambda: klt.extract_windows_kernel(imgs, oy, ox, S))
            t_p = cuda_ms(lambda: klt.extract_windows_plain(imgs, oy, ox, S))
            times[(S, B)] = (t_k, t_p)
            print(f"kernel extract: S={S} B={B} K=512 on {Hl}x{Wl} bit-equal, "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    report["extract"] = dict(max_abs_err=err, ms=times[(34, 1)][0],
                             plain_ms=times[(34, 1)][1])

    # B3: LK on the path's own inputs (template at the detected corners,
    # zero-motion guess), at the top level (S=46) and the finest (S=34).
    kp = fast.detect(f0, 40.0, 512)
    pyr1 = image.build_pyramid(f1, 4)
    err_q = err_e = 0.0
    times = {}
    for S, lvl in ((46, 3), (34, 0)):
        pts = kp.xy / 2.0 ** lvl
        T, Ix, Iy, c_eff = klt._template(pyr[lvl], pts, 21, S)
        tgt_wins, _, q0 = klt._target(pyr1[lvl], c_eff, 21, S)
        args = (tgt_wins, T, Ix, Iy, q0, 21, 12, 0.01)
        q_k, e_k = klt.lk_iterate_kernel(*args)
        q_p, e_p = klt.lk_iterate_plain(*args)
        torch.cuda.synchronize()
        dq = float((q_k - q_p).abs().max())
        de = float((e_k - e_p).abs().max())
        _check(dq <= LK_Q_ATOL, f"LK kernel q differs by {dq} (S={S})")
        _check(bool(((e_k - e_p).abs() <= LK_ERR_ATOL + LK_ERR_RTOL * e_p.abs()).all()),
               f"LK kernel err differs by {de} (S={S})")
        err_q, err_e = max(err_q, dq), max(err_e, de)
        t_k = cuda_ms(lambda: klt.lk_iterate_kernel(*args))
        t_p = cuda_ms(lambda: klt.lk_iterate_plain(*args), reps=5)
        times[S] = (t_k, t_p)
        print(f"kernel lk: S={S} K=512 iters=12 max|dq|={dq:.3g} px "
              f"max|derr|={de:.3g}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    report["lk"] = dict(max_abs_err=max(err_q, err_e), ms=times[34][0],
                        plain_ms=times[34][1])
    return report


def bench_config():
    from epivo_tpu_torch.geometry.camera import Pinhole
    from epivo_tpu_torch.pipeline.config import (
        FrontendConfig, LMConfig, RansacConfig, VOConfig,
    )

    return VOConfig(
        camera=Pinhole(fx=718.856, fy=718.856, cx=W / 2.0, cy=H / 2.0,
                       width=W, height=H),
        frontend=FrontendConfig(fast_threshold=40.0, max_keypoints=512,
                                klt_window=21, klt_levels=4, klt_iters=12),
        ransac=RansacConfig(n_hyp=512, refine_e=True),
        lm=LMConfig(n_points=48),
    )


def _pose_err(T, T_ref):
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    d = T[:3, 3] / np.linalg.norm(T[:3, 3])
    d_ref = T_ref[:3, 3] / np.linalg.norm(T_ref[:3, 3])
    return float(np.linalg.norm(T[:3, :3] - T_ref[:3, :3])), float(np.linalg.norm(d - d_ref))


def phase_slice(f0, f1, gt) -> dict:
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import vo

    dev = f0.device
    cfg = bench_config()
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

    def step(**kw):
        out = vo.vo_step(f0, f1, gen(), cfg, **kw)
        torch.cuda.synchronize()
        return out

    first = step()  # warm-up: allocator, cuBLAS handles

    n_steps = 5
    fast.KERNEL_LAUNCHES = klt.EXTRACT_LAUNCHES = klt.LK_LAUNCHES = 0
    times, results = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        results.append(step())
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"fast": fast.KERNEL_LAUNCHES, "extract": klt.EXTRACT_LAUNCHES,
                "lk": klt.LK_LAUNCHES}
    per_step = {"fast": 1, "extract": 2 * cfg.frontend.klt_levels,
                "lk": cfg.frontend.klt_levels}
    _check(launches == {k: v * n_steps for k, v in per_step.items()},
           f"launch counts {launches} != {per_step} per step x {n_steps}")
    for r in results:  # repeat probe: same seed, same answer
        _check(torch.equal(r.T, first.T) and int(r.n_inliers) == int(first.n_inliers),
               "repeated vo_step changed its result")

    T = first.T.cpu().numpy()
    _check(T.shape == (4, 4) and bool(np.isfinite(T).all()), "pose not finite")
    _check(first.points.shape == (512, 3) and bool(torch.isfinite(first.points).all()),
           "points not finite")
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    r_err, d_err = _pose_err(T, T_gt)
    _check(r_err < GT_R_TOL and d_err < GT_DIR_TOL,
           f"pose vs ground truth: |dR|_F={r_err:.4g}, dir={d_err:.4g}")
    print(f"slice: vo_step {H}x{W} n_tracked={int(first.n_tracked)} "
          f"n_inliers={int(first.n_inliers)} reverted={bool(first.reverted)} "
          f"|R-R_gt|_F={r_err:.4g} dir_err={d_err:.4g} "
          f"median {np.median(times):.2f} ms/step over {n_steps} "
          f"(launches per step: {per_step})")

    # Kernel path vs plain path on the card, with the same injected samples.
    kp = fast.detect(f0, cfg.frontend.fast_threshold, cfg.frontend.max_keypoints)
    flow = klt.track(f0, f1, kp.xy, valid=kp.valid, win=cfg.frontend.klt_window,
                     levels=cfg.frontend.klt_levels, iters=cfg.frontend.klt_iters,
                     min_eig=cfg.frontend.klt_min_eig)
    samples = ransac._sample_indices(gen(), cfg.ransac.hypotheses(),
                                     cfg.frontend.max_keypoints, flow.status,
                                     device=dev)
    r_k = step(ransac_samples=samples)
    t0 = time.perf_counter()
    r_p = step(ransac_samples=samples, use_kernel=False)
    plain_step_ms = (time.perf_counter() - t0) * 1e3
    r_err, d_err = _pose_err(r_k.T.cpu().numpy(), r_p.T.cpu().numpy())
    _check(r_err < STEP_R_TOL and d_err < STEP_DIR_TOL,
           f"kernel vs plain step: |dR|_F={r_err:.4g}, dir={d_err:.4g}")
    print(f"slice: kernel vs plain path, same samples: |dR|_F={r_err:.3g} "
          f"dir={d_err:.3g} n_tracked {int(r_k.n_tracked)}/{int(r_p.n_tracked)} "
          f"n_inliers {int(r_k.n_inliers)}/{int(r_p.n_inliers)}; "
          f"plain step {plain_step_ms:.2f} ms")
    return launches


def phase_degenerate(dev) -> None:
    from epivo_tpu_torch.pipeline import vo

    flat = torch.full((H, W), 90.0, device=dev)
    r = vo.vo_step(flat, flat, torch.Generator(device=dev).manual_seed(SEED),
                   bench_config())
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(r.T).all()), "flat frames gave a non-finite pose")
    print(f"degenerate: flat frames n_tracked={int(r.n_tracked)} "
          f"reverted={bool(r.reverted)} finite pose")


KERNELS = {
    "fast": ("epivo_tpu_torch/csrc/fast.cu",
             "epivo_tpu/frontend/pallas_fast.py:33"),
    "extract": ("epivo_tpu_torch/csrc/klt_extract.cu",
                "epivo_tpu/frontend/pallas_klt.py:211"),
    "lk": ("epivo_tpu_torch/csrc/klt_lk.cu",
           "epivo_tpu/frontend/pallas_klt.py:75"),
}


def main() -> int:
    name, _ = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    f0, f1, gt = corridor_pair(dev)
    report = phase_kernels(f0, f1)
    launches = phase_slice(f0, f1, gt)
    phase_degenerate(dev)
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **report[k]}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
