"""Distributed pipeline steps: window-sharded BA and hypothesis-sharded
RANSAC (port of ``epivo_tpu/parallel/dist.py``).

Every rank of the mesh calls the step with the same whole arrays; each
solves its own block and one collective reassembles what the reference
returns replicated:

1. :func:`distributed_ba_step`: the window axis is split over ``win``;
   each rank solves its windows with :func:`ba.ba_windows`, the per-window
   results are gathered, the global health metrics are sums over the
   ranks, and the trajectory is chained from the gathered windows
   (:func:`ba.trajectory_from_zetas`).
2. :func:`distributed_ransac_essential`: the hypotheses are split over
   ``hyp`` by :func:`ransac.ransac_essential` (``hyp_mesh``); each rank
   scores its own samples against all matches, and one ``all_gather`` of
   the scores and candidates picks the winner.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from epivo_tpu_torch import ransac as ransac_mod
from epivo_tpu_torch.parallel import mesh as mesh_mod
from epivo_tpu_torch.pipeline import ba
from epivo_tpu_torch.pipeline.config import BAConfig


class DistBAResult(NamedTuple):
    T_opt: torch.Tensor  # [W, Z, 4, 4] optimized poses (gathered)
    trajectory: torch.Tensor  # [W*Z + 1, 4, 4] stitched global trajectory
    global_r_norm: torch.Tensor  # [] residual norm over every window
    reverted_frac: torch.Tensor  # [] fraction of reverted windows
    r_norm: torch.Tensor  # [W] per-window residual norms (gathered)
    reverted: torch.Tensor  # [W] per-window revert flags (gathered)
    n_accepted: torch.Tensor  # [W] per-window LM accepted counts (gathered)


def distributed_ba_step(mesh, spec: ba.WindowSpec, config: BAConfig,
                        graph: bool | None = None):
    """The windowed-BA step of every rank of ``mesh``.

    Returns fn(T0s [W, Z, 4, 4], p [W, R, N, 3], p_t, wreps [W, R], pmask
    [W, R, N]) -> :class:`DistBAResult`, the same on every rank. W must
    divide the mesh's ``win`` axis (``runners._solve_windows`` pads by
    repeating the last window). This is the solve of the single-device
    path (:func:`ba.ba_windows`), which the sequence runners route through
    when given a mesh. ``graph`` is the local solve's (``ba.ba_windows``):
    by default a CUDA graph per window shape, on every backend, since the
    gather and the sums follow outside it.
    """

    def step(T0s, p, p_t, wreps, pmask):
        W = T0s.shape[0]
        T0l, pl, ptl, wl, ml = (mesh_mod.shard_rows(x, mesh, "win")
                                for x in (T0s, p, p_t, wreps, pmask))
        out = ba.ba_windows(T0l, spec, pl, ptl, wreps=wl, pmask=ml, config=config,
                            graph=graph)
        Wl = out.r_norm.shape[0]
        rows = torch.cat([out.T_opt.reshape(Wl, -1), out.r_norm[:, None],
                          out.reverted.to(out.r_norm.dtype)[:, None],
                          out.n_accepted.to(out.r_norm.dtype)[:, None]], dim=-1)
        full = mesh_mod.gather_rows(rows, mesh, "win")
        sums = mesh_mod.psum(torch.stack([torch.sum(out.r_norm ** 2),
                                          torch.sum(out.reverted.to(out.r_norm.dtype))]),
                             mesh, "win")
        T_opt = full[:, :-3].reshape(T0s.shape)
        return DistBAResult(
            T_opt=T_opt,
            trajectory=ba.trajectory_from_zetas(ba.stitch_windows(T_opt)),
            global_r_norm=torch.sqrt(sums[0]),
            reverted_frac=sums[1] / W,
            r_norm=full[:, -3],
            reverted=full[:, -2] > 0.5,
            n_accepted=full[:, -1].to(torch.int32),
        )

    return step


def distributed_ransac_essential(mesh, n_hyp_per_device: int = 256,
                                 threshold: float = 1e-5):
    """RANSAC with its hypotheses split over the mesh's ``hyp`` axis (D
    ranks).

    Returns fn(generator_or_samples, p [N, 3], p_t [N, 3], mask [N]) ->
    (E [3, 3], inliers [N]), the same on every rank. Given a generator,
    every rank draws the samples of all D ranks ([D * n_hyp_per_device,
    8], one draw); given samples [D, n_hyp_per_device, 8] (the reference's
    per-device draws, for parity runs), row d is rank d's. The split, the
    scoring with ``refit=False``, the gather and the first maximum are
    :func:`ransac.ransac_essential`'s with ``hyp_mesh=mesh``; the inliers
    are the winner's on every rank.
    """
    D = mesh_mod.axis_size(mesh, "hyp")
    n = n_hyp_per_device
    m = ransac_mod.MIN_SAMPLE

    def fn(generator_or_samples, p, p_t, mask):
        if isinstance(generator_or_samples, torch.Tensor):
            samples = generator_or_samples.to(device=p.device, dtype=torch.int64)
            if samples.shape != (D, n, m):
                raise ValueError(f"samples must be [{D}, {n}, {m}], "
                                 f"got {tuple(samples.shape)}")
        else:
            samples = ransac_mod._sample_indices(generator_or_samples, D * n, p.shape[0],
                                                 mask, device=p.device)
        res = ransac_mod.ransac_essential(
            None, p, p_t, n_hyp=D * n, threshold=threshold, mask=mask, refit=False,
            samples=samples.reshape(D * n, m), hyp_mesh=mesh)
        return res.E, res.inliers

    return fn
