"""One-core baseline of the two-view VO step (the port's counterpart of
``baselines/cv2_kitti_e.py``): the kitti_E workload in the reference's own
execution model, OpenCV C++ kernels and the native LM on ONE CPU core.

The reference (``kitti_E.cpp:54-255``) publishes no numbers, so this
script produces them: per frame pair it runs the reference's stage chain
with the same libraries and settings:

    FAST(threshold=40)                  `kitti_E.cpp:71-74`
    calcOpticalFlowPyrLK (21x21, lvl 3) `kitti_E.cpp:82-87`
    findEssentialMat LMEDS prob=0.99    `kitti_E.cpp:98-104`
    recoverPose + cheirality mask       `kitti_E.cpp:120,174-186`
    48-pt single-pose LM refine (30 it) `kitti_E.cpp:170-196`
    closed-form triangulation           `kitti_E.cpp:235-254`

The LM step runs in native C++ (``epivo_tpu_torch/runtime/lm_ref.cpp``, a
byte-equal copy of the reference's), so the baseline pays native cost for
the optimizer, not Python cost. Two simplifications make the baseline
FASTER, so ``vs_baseline`` comparisons are conservative: only the
strongest 512 FAST corners are tracked (the reference tracks every
corner), and triangulation is vectorized numpy. The frames are the
bench's corridor pair (``bench.render_bench_frames``).

The pinning is the caller's: run it under ``taskset -c 0``, or pass
``--pin CPU``. It refuses to time unless the process may run on exactly
one CPU:

    taskset -c 0 python3 -m epivo_tpu_torch.tools.cv2_kitti_e [--image 376x1241]

Prints one JSON line: ``{"cv2_fps": ..., "n_frames": ..., "note": ...,
"cpus": [...], "cv2_version": ...}``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_WARMUP = 2
N_ITERS = 30


def run_pair(cv2, img0_u8, img1_u8, K, K_inv, lm_refine):
    """One kitti_E-equivalent frame-pair step. Returns (T, n_cloud)."""
    det = cv2.FastFeatureDetector_create(40, nonmaxSuppression=True)
    kps = det.detect(img0_u8, None)
    if len(kps) < 16:
        return np.eye(4), 0
    kps = sorted(kps, key=lambda k: -k.response)[:512]
    pts0 = np.array([k.pt for k in kps], np.float32).reshape(-1, 1, 2)

    pts1, st, _ = cv2.calcOpticalFlowPyrLK(
        img0_u8, img1_u8, pts0, None, winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01),
    )
    good = st.reshape(-1) == 1
    q0 = pts0.reshape(-1, 2)[good]
    q1 = pts1.reshape(-1, 2)[good]
    if q0.shape[0] < 8:
        return np.eye(4), 0

    E, mask = cv2.findEssentialMat(q0, q1, K, method=cv2.LMEDS, prob=0.99)
    if E is None or E.shape[0] < 3:
        return np.eye(4), 0
    E = E[:3]
    _, R, t, mask2 = cv2.recoverPose(E, q0, q1, K, mask=mask.copy())

    # Degenerate fallback (ref `kitti_E.cpp:128-135`).
    if np.trace(R) < 2.7:
        R = np.eye(3)
        t = np.array([[0.1], [0.1], [-0.9]])

    # <= 48 cheirality-masked normalized pairs (ref :170-192).
    sel = mask2.reshape(-1) == 255
    h0 = np.concatenate([q0, np.ones((q0.shape[0], 1), np.float32)], 1)
    h1 = np.concatenate([q1, np.ones((q1.shape[0], 1), np.float32)], 1)
    n0 = (h0 @ K_inv.T)[sel][:48]
    n1 = (h1 @ K_inv.T)[sel][:48]

    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t.reshape(-1)
    if n0.shape[0] >= 8:
        T, _ = lm_refine(T, n0.astype(np.float64), n1.astype(np.float64),
                         lambda0=1e-2, max_iters=30, huber_delta=1e-5)

    # Closed-form triangulation of the inlier set (ref :235-254).
    nh0 = (h0 @ K_inv.T)[sel]
    nh1 = (h1 @ K_inv.T)[sel]
    Rf, tf = T[:3, :3], T[:3, 3]
    A = np.stack([tf[0] - nh1[:, 0] * tf[2], tf[1] - nh1[:, 1] * tf[2]], -1)
    Rp = nh0 @ Rf.T
    B = np.stack([Rp[:, 0] - nh1[:, 0] * Rp[:, 2],
                  Rp[:, 1] - nh1[:, 1] * Rp[:, 2]], -1)
    nB = np.linalg.norm(B, axis=-1)
    ok = nB > 1e-2
    d = np.where(ok, np.linalg.norm(A, axis=-1) / np.where(ok, nB, 1.0), 0.0)
    return T, int(((d > 0) & ok).sum())


def pair_inputs(img0, img1, K):
    """run_pair's inputs from a rendered pair: uint8 frames, K and K^-1 in
    float64."""
    img0_u8 = np.clip(np.asarray(img0), 0, 255).astype(np.uint8)
    img1_u8 = np.clip(np.asarray(img1), 0, 255).astype(np.uint8)
    K = np.asarray(K, np.float64)
    return img0_u8, img1_u8, K, np.linalg.inv(K)


def main(argv=None) -> dict:
    from epivo_tpu_torch.tools import bench
    from epivo_tpu_torch.tools.native_ba import one_cpu

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", type=bench.image_size, default=tuple(bench.WORKLOAD["image"]),
                    help="HxW of the rendered pair (the bench's 376x1241 by default)")
    ap.add_argument("--pin", type=int, default=None,
                    help="pin this process to this CPU (where taskset is missing)")
    args = ap.parse_args(argv)
    cpus = one_cpu(args.pin)

    import cv2
    import torch

    from epivo_tpu_torch import runtime

    cv2.setNumThreads(1)  # one-core execution model, like the reference
    torch.set_num_threads(1)
    img0, img1, K = bench.render_bench_frames(args.image)
    inputs = pair_inputs(img0, img1, K)

    for _ in range(N_WARMUP):
        run_pair(cv2, *inputs, runtime.lm_refine_pose)

    t0 = time.perf_counter()
    for _ in range(N_ITERS):
        run_pair(cv2, *inputs, runtime.lm_refine_pose)
    dt = time.perf_counter() - t0

    out = {
        "cv2_fps": N_ITERS / dt,
        "n_frames": N_ITERS,
        "note": "OpenCV C++ frontend + native C++ LM, 1 core, 512-corner "
                "budget (generous vs the reference's unbounded corners)",
        "cpus": cpus,
        "cv2_version": cv2.__version__,
        "image": list(args.image),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
