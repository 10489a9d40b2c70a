"""Windowed bundle adjustment (port of ``epivo_tpu/pipeline/ba.py``).

The window axis is a batch axis: every window's LM solve runs at once
through ``lm.solve_batched``, one set of launches per iteration whatever
the number of windows.

Window structure (mono, ws=3, stride ws-1): frames {i, i+1, i+2}; zetas
z0: i->i+1, z1: i+1->i+2 (owned by this window; stride ws-1 tiles the
zeta axis exactly); constraints: (i,i+1) span (0,0); (i+1,i+2) span (1,1);
(i,i+2) span (0,1).

Stereo: frame index space doubled (2i = L_i, 2i+1 = R_i); zetas alternate
rig (L_i->R_i) and cross (R_i->L_{i+1}). Rig zetas are frozen at the
calibrated transform through ``zeta_mask`` (or zero-weighted, with
``freeze_rig=False``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from epivo_tpu_torch import _graphs
from epivo_tpu_torch._device import constant
from epivo_tpu_torch.geometry import epipolar, se3
from epivo_tpu_torch.optim import lm
from epivo_tpu_torch.pipeline.config import BAConfig
from epivo_tpu_torch.utils import profiling


class WindowSpec(NamedTuple):
    """Static structure shared by every window."""

    n_zeta: int
    reps: np.ndarray  # [R, 2] zeta spans (window-local)
    frame_pairs: np.ndarray  # [R, 2] window-local *frame* offsets (for matching)
    zeta_mask: np.ndarray | None  # [Z] False = frozen (stereo rig zetas)


def mono_window_spec(ws: int = 3) -> WindowSpec:
    """Consecutive-pair constraints + the anchor skip constraint."""
    n_zeta = ws - 1
    reps = [(j, j) for j in range(n_zeta)]
    pairs = [(j, j + 1) for j in range(n_zeta)]
    if ws >= 3:
        reps.append((0, n_zeta - 1))
        pairs.append((0, ws - 1))
    return WindowSpec(
        n_zeta=n_zeta,
        reps=np.asarray(reps, np.int32),
        frame_pairs=np.asarray(pairs, np.int32),
        zeta_mask=None,
    )


def stereo_window_spec(ws: int = 3, freeze_rig: bool = True):
    """Doubled-index stereo window; returns (spec, per-constraint weights).

    Window-local doubled frames: 0=L_0, 1=R_0, 2=L_1, ... (2k = L_k).
    Zetas: even = rig L_k->R_k, odd = cross R_k->L_{k+1}.
    Constraints per temporal step k:
      L_k->L_{k+1}: zeta span (2k, 2k+1), w=1
      R_k->L_{k+1}: span (2k+1, 2k+1),  w=1
      L_k->R_k   : span (2k, 2k),      w=0 (baseline; frozen instead when
                                            ``freeze_rig``)
    """
    n_step = ws - 1
    n_zeta = 2 * n_step
    reps, pairs, w = [], [], []
    for k in range(n_step):
        reps.append((2 * k, 2 * k + 1)); pairs.append((2 * k, 2 * k + 2)); w.append(1.0)
        reps.append((2 * k + 1, 2 * k + 1)); pairs.append((2 * k + 1, 2 * k + 2)); w.append(1.0)
        reps.append((2 * k, 2 * k)); pairs.append((2 * k, 2 * k + 1)); w.append(0.0)
    zmask = None
    if freeze_rig:
        zmask = np.ones(n_zeta, bool)
        zmask[0::2] = False  # rig zetas frozen at calibration
    spec = WindowSpec(
        n_zeta=n_zeta,
        reps=np.asarray(reps, np.int32),
        frame_pairs=np.asarray(pairs, np.int32),
        zeta_mask=zmask,
    )
    return spec, np.asarray(w, np.float32)


class BAWindowsResult(NamedTuple):
    T_opt: torch.Tensor  # [W, Z, 4, 4] optimized (or reverted) zeta poses
    r_norm: torch.Tensor  # [W]
    reverted: torch.Tensor  # [W] bool: window exceeded revert threshold
    n_accepted: torch.Tensor  # [W] int32 LM accepted-step counts


def _solve(static, T0s, p, p_t, wreps, pmask) -> BAWindowsResult:
    """The windowed solve of :func:`ba_windows`; ``static`` = (reps as a
    tuple of spans, zeta_mask as a tuple or None, LMConfig). The window
    structure is a device constant per (value, device), built once."""
    reps, zeta_mask, lc = static
    dev = T0s.device
    res = lm.solve_batched(
        T0s, constant(np.asarray(reps, np.int64).reshape(-1, 2), torch.int64, dev), p, p_t,
        wreps=wreps, pmask=pmask,
        zeta_mask=None if zeta_mask is None else constant(
            np.asarray(zeta_mask, bool), torch.bool, dev),
        lambda0=lc.lambda0, epsilon=lc.epsilon, max_iters=lc.max_iters,
        huber_delta=lc.huber_delta,
    )
    reverted = res.r_norm > lc.revert_r_norm
    T_opt = torch.where(reverted[:, None, None, None], T0s, res.T0s)
    return BAWindowsResult(
        T_opt=T_opt, r_norm=res.r_norm, reverted=reverted,
        n_accepted=res.n_accepted,
    )


def ba_windows(
    T0s: torch.Tensor,
    spec: WindowSpec,
    p: torch.Tensor,
    p_t: torch.Tensor,
    wreps: torch.Tensor | None = None,
    pmask: torch.Tensor | None = None,
    config: BAConfig = BAConfig(),
    use_lanes: bool = True,
    graph: bool | None = None,
) -> BAWindowsResult:
    """Batched windowed BA on T0s's device, with no host sync.

    Args:
      T0s: [W, Z, 4, 4] initial zeta poses per window.
      spec: shared window structure.
      p, p_t: [W, R, N, 3] normalized matches per window constraint.
      wreps: [W, R] constraint weights.
      pmask: [W, R, N] point validity.
      use_lanes: accepted and ignored. The reference picks between two
        solvers that compute the same function, its vmapped LM and a
        lane-major twin laid out for the TPU's vector registers; the port
        has one LM with the window axis first (``lm.solve_batched``).
      graph: ``None`` replays the solve (30 LM iterations) as a CUDA graph
        cached per (spec, ``config.lm``, input shapes) for CUDA tensors;
        ``True`` raises on the CPU; ``False`` runs eagerly
        (``_graphs.wanted``). Both give the same result bit for bit.

    Underfilled constraints should be zero-weighted by the caller; windows
    whose final residual norm exceeds ``config.lm.revert_r_norm`` revert to
    their initialization.
    """
    del use_lanes
    with profiling.span("ba.windows"):
        static = (tuple(map(tuple, np.asarray(spec.reps).tolist())),
                  None if spec.zeta_mask is None
                  else tuple(np.asarray(spec.zeta_mask, bool).tolist()), config.lm)
    if _graphs.wanted(T0s, graph):
        return _graphs.run(_solve, static, T0s, p, p_t, wreps, pmask)
    return _solve(static, T0s, p, p_t, wreps, pmask)


def stitch_windows(T_opt: torch.Tensor) -> torch.Tensor:
    """Concatenate window-owned zetas into one chain.

    With stride == ws-1 each window owns its zetas exclusively (window w
    covers global zetas [w*Z, (w+1)*Z)), so stitching is a reshape:
    [W, Z, 4, 4] -> [W*Z, 4, 4].
    """
    W, Z = T_opt.shape[:2]
    return T_opt.reshape(W * Z, 4, 4)


def trajectory_from_zetas(zetas: torch.Tensor) -> torch.Tensor:
    """Camera-to-world trajectory from a zeta chain [F, 4, 4].

    Zeta j maps frame j -> frame j+1, so cT_{k+1} = cT_k @ inv(T_k),
    starting at identity. Returns [F+1, 4, 4].
    """
    cT = torch.eye(4, dtype=zetas.dtype, device=zetas.device)
    traj = [cT]
    for T in zetas:
        cT = cT @ se3.inverse(T)
        traj.append(cT)
    return torch.stack(traj)


def stereo_left_trajectory(zetas: torch.Tensor) -> torch.Tensor:
    """Left-camera trajectory from the doubled (rig, cross) zeta chain.

    The composed L_k -> L_{k+1} motion is cross_k @ rig_k (first L->R, then
    R->L'). zetas: [2*S, 4, 4] alternating (rig, cross). Returns
    [S+1, 4, 4].
    """
    rig = zetas[0::2]
    cross = zetas[1::2]
    return trajectory_from_zetas(torch.einsum("sij,sjk->sik", cross, rig))


def propagate_scale(zetas: torch.Tensor,
                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """Apply external per-zeta translation magnitudes (monocular scale).

    Given ``scales`` [F] (e.g. from GT or an odometer), set each zeta's
    |t|. With ``scales=None`` this is the identity: the joint LM solve
    recovers the relative scales within each window, and cross-window
    chaining without GT is :func:`boundary_scale_ratio`.
    """
    if scales is None:
        return zetas
    t = zetas[:, :3, 3]
    norms = torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12
    out = zetas.clone()
    out[:, :3, 3] = (t / norms) * scales[:, None]
    return out


def boundary_scale_ratio(
    T_prev,
    T_next,
    p_back,
    pt_back,
    mask_back,
    p_fwd,
    pt_fwd,
    mask_fwd,
    min_common: int = 4,
) -> float:
    """Scale factor expressing window w+1's units in window w's units.

    At a boundary frame b shared by consecutive windows, the same source
    keypoints are tracked backward to b-1 and forward to b+1, so the
    landmark depths in frame b are computed twice: through
    T_back = inv(T_prev) (zeta b-1 -> b in window-w units) and through
    T_next (zeta b -> b+1 in window-w+1 units). Both are depths of the same
    landmarks, so s = median(d_back / d_fwd) rescales window w+1 into
    window w's units (1.0 with fewer than ``min_common`` usable points).

    Rows of (p_back, pt_back) and (p_fwd, pt_fwd) must be aligned on the
    same source keypoints of frame b. Host-side (once per boundary):
    arrays or tensors in, a float out.
    """
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    T_back = se3.inverse(f32(T_prev))
    d_back, v_back = epipolar.epipolar_depth(T_back[:3, :3], T_back[:3, 3],
                                             f32(p_back), f32(pt_back))
    T_next = f32(T_next)
    d_fwd, v_fwd = epipolar.epipolar_depth(T_next[:3, :3], T_next[:3, 3],
                                           f32(p_fwd), f32(pt_fwd))
    d_b, d_f = d_back.numpy(), d_fwd.numpy()
    both = (
        v_back.numpy() & v_fwd.numpy()
        & np.asarray(mask_back) & np.asarray(mask_fwd)
        & (d_b > 1e-3) & (d_b < 1e4) & (d_f > 1e-3) & (d_f < 1e4)
    )
    if both.sum() < min_common:
        return 1.0
    return float(np.median(d_b[both] / d_f[both]))
