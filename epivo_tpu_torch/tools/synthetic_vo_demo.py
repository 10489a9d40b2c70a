"""End-to-end two-view VO on a rendered synthetic scene (the port's
counterpart of ``examples/synthetic_vo_demo.py``).

Drives the public pipeline the way a user would, images in and relative
pose out:

  render two views of a 3D point scene (the JAX demo's own draw, kept in
  ``demo_scenes.npz``: the port cannot reproduce ``jax.random``)
  -> FAST detection (frontend.fast)
  -> pyramidal KLT tracking (frontend.klt)
  -> batched RANSAC essential estimation (ransac)
  -> cheirality-checked pose recovery (geometry.essential)
  -> LM pose refinement (optim.lm)
  -> rotation / translation-direction error against the ground truth.

It prints ``RESULT ok=True`` and exits 0 when the LM pose is within 0.02
(rotation, Frobenius) and 0.05 (translation direction) of the truth;
``--orb`` runs the ORB step instead (0.05 / 0.3: descriptor matches are
pixel-quantized). ``--flat`` feeds textureless frames: it prints
``DEGENERATE: too few tracks`` and the fallback pose. ``--device`` is
``cuda`` (the default; the kernels run there) or ``cpu``.
``--scene-seed S`` draws the scene with numpy instead
(:func:`numpy_scene`), to probe the pipeline on other scenes.

    python -m epivo_tpu_torch.tools.synthetic_vo_demo [--flat] [--orb] [--device cpu]
        [--scene-seed S]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def render(points_3d: torch.Tensor, K: torch.Tensor, T: torch.Tensor, H: int, W: int,
           sigma: float = 1.5) -> torch.Tensor:
    """Render 3D points as Gaussian blobs seen from pose T (world = cam0)."""
    Xc = points_3d @ T[:3, :3].T + T[:3, 3]
    uv = (Xc / Xc[:, 2:3]) @ K.T
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=K.device),
                            torch.arange(W, dtype=torch.float32, device=K.device),
                            indexing="ij")
    img = torch.zeros((H, W), dtype=torch.float32, device=K.device)
    for i in range(uv.shape[0]):
        img += 255.0 * torch.exp(-((xx - uv[i, 0]) ** 2 + (yy - uv[i, 1]) ** 2)
                                 / (2 * sigma ** 2))
    return torch.clamp(img, 0, 255)


SCENES = Path(__file__).resolve().parent / "demo_scenes.npz"


def demo_scene(name: str) -> np.ndarray:
    """The 3D points [N, 3] float32 of a JAX demo's scene, as its
    ``jax.random.PRNGKey(0)`` draws them: "vo_demo" (160 points 8-20 m
    deep, ``examples/synthetic_vo_demo.py``) or "sequence_demo" (140
    points 6-18 m deep, ``examples/sequence_demo.py``).
    ``tests/test_torch_demos.py`` holds the file equal to those draws."""
    with np.load(SCENES) as z:
        return z[name]


def numpy_draws(seed: int, n: int = 160) -> tuple[np.ndarray, np.ndarray]:
    """The two draws of a "vo_demo" scene made with numpy in float32, in
    the order and form of the JAX demo's: depths z ~ U(8, 20) m [n], then
    u ~ U(-0.45, 0.45) [n, 2]."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(8.0, 20.0, n).astype(np.float32)
    return z, rng.uniform(-0.45, 0.45, (n, 2)).astype(np.float32)


def numpy_scene(seed: int, n: int = 160) -> np.ndarray:
    """The scene [n, 3] of :func:`numpy_draws`: (u * z, z), as the JAX demo
    composes its draws (``--scene-seed``)."""
    z, u = numpy_draws(seed, n)
    return np.concatenate([u * z[:, None], z[:, None]], axis=-1)


def main(argv=None) -> int:
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch._device import runner_device
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.geometry import camera, essential, se3
    from epivo_tpu_torch.optim import lm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flat", action="store_true",
                    help="feed textureless images (degenerate-path probe)")
    ap.add_argument("--orb", action="store_true",
                    help="use ORB descriptor matching instead of KLT")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--scene-seed", type=int, default=None,
                    help="draw the scene with numpy from this seed (numpy_scene) "
                         "instead of the JAX demo's draw")
    args = ap.parse_args(argv)
    dev = runner_device(args.device)

    H, W = 240, 320
    cam = camera.Pinhole(fx=300.0, fy=300.0, cx=W / 2, cy=H / 2, width=W, height=H)
    X = torch.from_numpy(demo_scene("vo_demo") if args.scene_seed is None
                         else numpy_scene(args.scene_seed)).to(dev)
    # Ground-truth motion: modest rotation, forward-dominant translation.
    T_gt = se3.se3_exp(torch.tensor([0.08, -0.05, 0.6, 0.015, -0.02, 0.01])).to(dev)
    R_gt, t_gt = T_gt[:3, :3], T_gt[:3, 3]
    gen = torch.Generator(device=dev).manual_seed(0)

    if args.flat:
        img0 = torch.full((H, W), 90.0, device=dev)
        img1 = torch.full((H, W), 90.0, device=dev)
    else:
        K = cam.K(device=dev)
        img0 = render(X, K, torch.eye(4, device=dev), H, W)
        img1 = render(X, K, T_gt, H, W)

    def report(name, R, t):
        rot_err = float(torch.linalg.norm(R - R_gt))
        t_dir = t / (torch.linalg.norm(t) + 1e-12)
        dir_err = float(torch.linalg.norm(t_dir - t_gt / torch.linalg.norm(t_gt)))
        print(f"{name}: |R-R_gt|={rot_err:.5f}  |t_dir err|={dir_err:.5f}")
        return rot_err, dir_err

    if args.orb:
        from epivo_tpu_torch.pipeline import vo
        from epivo_tpu_torch.pipeline.config import (FrontendConfig, LMConfig,
                                                     RansacConfig, VOConfig)

        cfg = VOConfig(camera=cam,
                       frontend=FrontendConfig(fast_threshold=15.0, max_keypoints=256),
                       ransac=RansacConfig(n_hyp=512),
                       lm=LMConfig(n_points=48, revert_r_norm=1e-4))
        res = vo.vo_step_orb(img0, img1, gen, cfg)
        print(f"ORB path: {int(res.n_tracked)} matches, {int(res.n_inliers)} inliers")
        rot_err, dir_err = report("ORB-pose", res.T[:3, :3], res.T[:3, 3])
        # Descriptor matches are pixel-quantized (no subpixel refinement),
        # so the translation direction is coarser than on the KLT path.
        ok = rot_err < 0.05 and dir_err < 0.3
        print(f"RESULT ok={ok}")
        return 0 if ok else 1

    t0 = time.time()
    kp = fast.detect(img0, threshold=15.0, max_keypoints=256)
    print(f"FAST: {int(kp.valid.sum())} keypoints (budget {kp.xy.shape[0]})")
    flow = klt.track(img0, img1, kp.xy, valid=kp.valid, levels=3)
    n_trk = int(flow.status.sum())
    print(f"KLT: {n_trk} tracked")

    if n_trk < 16:
        print("DEGENERATE: too few tracks — emitting fallback pose")
        _, t_fb = essential.pose_fallback(torch.eye(3, device=dev),
                                          torch.zeros(3, device=dev))
        print("fallback R=I, t=", t_fb.cpu().numpy())
        print("RESULT ok=degenerate-handled")
        return 0

    K_inv = cam.K_inv(device=dev)
    p0 = camera.normalize(kp.xy, K_inv)
    p1 = camera.normalize(flow.xy, K_inv)
    res = ransac.ransac_essential(gen, p0, p1, n_hyp=512, threshold=(1.0 / cam.fx) ** 2,
                                  mask=flow.status, method="ransac")
    print(f"RANSAC: {int(res.n_inliers)} inliers")
    R_hat, t_hat, front = essential.recover_pose(res.E, p0, p1, mask=res.inliers)
    R_hat, t_hat = essential.pose_fallback(R_hat, t_hat)

    # LM refinement on the top 48 cheirality-passing inliers.
    sel = res.inliers & front
    take = torch.argsort((~sel).to(torch.int8), stable=True)[:48]  # valid first
    T0 = se3.rt_to_matrix(R_hat, t_hat)[None]
    out = lm.solve(T0, torch.zeros((1, 2), dtype=torch.long, device=dev), p0[take][None],
                   p1[take][None], pmask=sel[take][None], huber_delta=1e-5)
    T_ref = out.T0s[0]
    dt = time.time() - t0

    report("E-pose ", R_hat, t_hat)
    re2, de2 = report("LM-pose", T_ref[:3, :3], T_ref[:3, 3])
    print(f"wall: {dt:.2f}s  residual norm: {float(out.r_norm):.3e}")
    ok = re2 < 0.02 and de2 < 0.05
    print(f"RESULT ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
