"""Artifact export compatible with the reference's text formats (port of
``epivo_tpu/viz/export.py``, numpy, copied).

The reference writes whitespace-separated Eigen matrices (`pts.cld`,
`lims`, `kitti.T`, `kitti.GT`, `est.pose`, `gt.pose` — formats at
`kitti_E.cpp:257-287`, `test_jac_Rt_gen.cpp:470-512`) that its Pangolin
scripts parse with ``np.fromfile(..., sep=' ')`` and reshape to (-1, 3) /
(-1, 4, 4) (`cloud_pango.py:25-39`). We keep that exact contract so the
reference's visualizers work unchanged on our outputs, and add a headless
matplotlib renderer (Pangolin/OpenGL is display-bound; SURVEY.md §7 step 9).
"""

from __future__ import annotations

import os

import numpy as np


def write_poses(path: str, poses: np.ndarray) -> None:
    """[F, 4, 4] -> text blocks, one matrix per blank-line-separated block
    (np.fromfile(sep=' ').reshape(-1, 4, 4) compatible)."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for T in poses:
            for row in T:
                f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
            f.write("\n")


def read_poses(path: str) -> np.ndarray:
    return np.fromfile(path, sep=" ").reshape(-1, 4, 4)


def write_cloud(path: str, points: np.ndarray, lims_path: str | None = None,
                limits: np.ndarray | None = None) -> None:
    """[N, 3] cloud -> pts.cld; optional per-frame cumulative counts -> lims
    (ref `kitti_E.cpp:257-272`)."""
    points = np.asarray(points).reshape(-1, 3)
    with open(path, "w") as f:
        for p in points:
            f.write(" ".join(f"{v:.9g}" for v in p) + "\n\n")
    if lims_path is not None and limits is not None:
        with open(lims_path, "w") as f:
            f.write(" ".join(str(int(v)) for v in np.asarray(limits)) + " ")


def read_cloud(path: str) -> np.ndarray:
    return np.fromfile(path, sep=" ").reshape(-1, 3)


def write_kitti_format(path: str, poses: np.ndarray) -> None:
    """KITTI odometry pose format: 12 values per line (3x4 row-major)."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9g}" for v in T[:3, :].reshape(-1)) + "\n")


def plot_trajectories(out_png: str, trajs: dict, cloud: np.ndarray | None = None,
                      axes=(0, 2)) -> None:
    """Headless top-down plot of one or more trajectories (+ optional cloud).

    trajs: name -> [F, 4, 4] or [F, 3]. axes picks the ground plane
    (default x-z, KITTI convention).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if cloud is not None and len(cloud):
        c = np.asarray(cloud)
        ax.scatter(c[:, axes[0]], c[:, axes[1]], s=0.2, c="#b9bec7", alpha=0.4,
                   label="cloud", rasterized=True)
    for name, tr in trajs.items():
        tr = np.asarray(tr)
        p = tr[:, :3, 3] if tr.ndim == 3 else tr
        ax.plot(p[:, axes[0]], p[:, axes[1]], label=name, linewidth=1.5)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_xlabel("xyz"[axes[0]])
    ax.set_ylabel("xyz"[axes[1]])
    fig.savefig(out_png, dpi=130, bbox_inches="tight")
    plt.close(fig)
