"""Multi-loop Sim(3) pose-graph optimization, host float64 (port of
``epivo_tpu/pipeline/posegraph.py``, a copy: it has no device code).

``close_loops`` applies verified loops GREEDILY — one loop per
non-overlapping span, each spread independently — which is exact for a
single revisit but cannot reconcile several loops whose spans overlap
(two laps of a course constrain the same intervening poses twice; the
greedy pass must drop one). This module closes that gap (PARITY known
gaps, "multi-loop Sim(3) pose-GRAPH optimization") with the standard
scale-drift-aware pose graph [Strasdat et al., CVPR'10] built the way
everything host-side in this package is built: tiny, f64, numpy — the
graph has O(F/stride) nodes with 7 DoF each, far below anything worth a
device dispatch (the reference has no loop machinery at all; its global
polish, kitti_ba.cpp:853-870, only ever sees short-span constraints).

Formulation
-----------
Node k carries a Sim(3) ``N_k = [[s_k R_k, t_k], [0, 1]]`` mapping the
frame's SCALED local coordinates to world: monocular chain poses drift
in scale, so local structure at node k lives in units ``sigma_k`` times
the gauge; ``s_k`` estimates ``1 / sigma_k`` (drift inverse) and is
initialized to 1 with the chain pose. Relative prediction
``P_ab = N_a^{-1} N_b`` has scale ``s_b / s_a`` and translation in a's
local units — exactly matching the two measurement families:

- **odometry edges** (consecutive nodes): the chain's relative SE(3)
  embedded with scale 1 (the chain cannot see its own drift, so the
  scale component gets a weak, span-proportional weight);
- **loop edges**: ``verify_loop``'s relative pose (translation already
  in chain-units-at-i) embedded with scale ``1 / sigma_meas`` where
  ``sigma_meas`` is ``measure_scale_drift``'s accumulated drift factor
  (zero-baseline loops carry no scale observation: weight ~0).

Residual per edge: ``r = log_sim3(M^{-1} P_ab)`` in R^7, diagonal
per-component weights, Huber IRLS on loop edges (a geometrically
verified but false loop must not bend the whole graph), Levenberg
damping, gauge fixed by pinning node 0. Jacobians are forward
differences on the 14 involved parameters — each column is two 4x4
matmuls and a log, negligible at graph size.

The corrected full-resolution trajectory is rebuilt segment-by-segment:
within each node interval the original steps are kept, their norms
re-scaled by the geometric interpolation of the solved drift, and the
remaining endpoint discrepancy spread rigidly (same local-frame ramp as
``loopclose.spread_drift``) — endpoint-exact at every node.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import sparse
from scipy.sparse import linalg as splinalg

from epivo_tpu_torch.pipeline.loopclose import (Loop, se3_exp_np, se3_log_np,
                                                _so3_exp_np)

_EPS = 1e-10


# ---------------------------------------------------------------------------
# Sim(3) exp / log (closed form, f64)


def _hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def _so3_log_np(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-9:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                               R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _calc_W(phi: np.ndarray, lam: float) -> np.ndarray:
    """W(phi, lam) = integral_0^1 e^{t lam} e^{t hat(phi)} dt.

    The Sim(3) analogue of SE(3)'s V matrix: t = W rho. Closed form via
    the three scalar integrals (series guards for the small-angle /
    small-log-scale limits)."""
    th = float(np.linalg.norm(phi))
    s = np.exp(lam)
    K = _hat(phi)
    if abs(lam) > 1e-5:
        a = (s - 1.0) / lam
    else:
        a = 1.0 + lam / 2.0 + lam * lam / 6.0
    den = lam * lam + th * th
    if th > 1e-5:
        b = (s * (lam * np.sin(th) - th * np.cos(th)) + th) / den
        c = a - (s * (lam * np.cos(th) + th * np.sin(th)) - lam) / den
        return a * np.eye(3) + (b / th) * K + (c / th**2) * (K @ K)
    # th -> 0: b/th -> int t e^{t lam}, c/th^2 -> int (t^2/2) e^{t lam}
    if abs(lam) > 1e-5:
        b_over_th = (s * (lam - 1.0) + 1.0) / (lam * lam)
        c_over_th2 = (s * (lam * lam - 2 * lam + 2) - 2.0) / (2 * lam**3)
    else:
        b_over_th = 0.5 + lam / 3.0
        c_over_th2 = 1.0 / 6.0 + lam / 8.0
    return a * np.eye(3) + b_over_th * K + c_over_th2 * (K @ K)


def sim3_exp(xi: np.ndarray) -> np.ndarray:
    """[7] (rho, phi, lam) -> [4, 4] [[e^lam R, W rho], [0, 1]]."""
    xi = np.asarray(xi, np.float64)
    rho, phi, lam = xi[:3], xi[3:6], float(xi[6])
    S = np.eye(4)
    S[:3, :3] = np.exp(lam) * _so3_exp_np(phi)
    S[:3, 3] = _calc_W(phi, lam) @ rho
    return S


def sim3_log(S: np.ndarray) -> np.ndarray:
    """[4, 4] Sim(3) -> [7] (rho, phi, lam)."""
    S = np.asarray(S, np.float64)
    sR = S[:3, :3]
    s = float(np.cbrt(np.linalg.det(sR)))
    lam = np.log(max(s, _EPS))
    R = sR / s
    phi = _so3_log_np(R)
    rho = np.linalg.solve(_calc_W(phi, lam), S[:3, 3])
    return np.concatenate([rho, phi, [lam]])


def sim3_inv(S: np.ndarray) -> np.ndarray:
    sR = S[:3, :3]
    s2 = float(np.cbrt(np.linalg.det(sR))) ** 2
    out = np.eye(4)
    out[:3, :3] = sR.T / s2  # (sR)^-1 = R^T / s
    out[:3, 3] = -out[:3, :3] @ S[:3, 3]
    return out


# ---------------------------------------------------------------------------
# Batched Sim(3) ops ([N, 4, 4] at once): the GN inner loop evaluates
# ~14 x n_edges logs per iteration for the multiplicative-perturbation
# Jacobians; scalar calls made a KITTI-scale graph (560 nodes) spend
# ~30 s in Python op overhead (profiled) — batching turns that into a
# handful of vector passes per iteration.


def _hat_batch(w: np.ndarray) -> np.ndarray:
    z = np.zeros(w.shape[0])
    return np.stack([
        np.stack([z, -w[:, 2], w[:, 1]], -1),
        np.stack([w[:, 2], z, -w[:, 0]], -1),
        np.stack([-w[:, 1], w[:, 0], z], -1),
    ], 1)


def _so3_log_batch(R: np.ndarray) -> np.ndarray:
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    th = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    ax = 0.5 * np.stack([R[:, 2, 1] - R[:, 1, 2],
                         R[:, 0, 2] - R[:, 2, 0],
                         R[:, 1, 0] - R[:, 0, 1]], -1)
    small = th < 1e-9
    fac = np.where(small, 1.0, th / np.sin(np.where(small, 1.0, th)))
    return fac[:, None] * ax


def _calc_W_batch(phi: np.ndarray, lam: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(phi, axis=-1)
    s = np.exp(lam)
    K = _hat_batch(phi)
    K2 = K @ K
    big_l = np.abs(lam) > 1e-5
    lam_s = np.where(big_l, lam, 1.0)
    a = np.where(big_l, (s - 1.0) / lam_s, 1.0 + lam / 2 + lam * lam / 6)
    big_t = th > 1e-5
    th_s = np.where(big_t, th, 1.0)
    den = np.where(big_t | big_l, lam * lam + th * th, 1.0)
    sin_t, cos_t = np.sin(th), np.cos(th)
    b_ot = np.where(
        big_t,
        (s * (lam * sin_t - th * cos_t) + th) / (den * th_s),
        np.where(big_l, (s * (lam - 1.0) + 1.0) / (lam_s * lam_s),
                 0.5 + lam / 3))
    c_ot2 = np.where(
        big_t,
        (a - (s * (lam * cos_t + th * sin_t) - lam) / den) / (th_s * th_s),
        np.where(big_l, (s * (lam * lam - 2 * lam + 2) - 2.0)
                 / (2 * lam_s**3), 1.0 / 6 + lam / 8))
    return (a[:, None, None] * np.eye(3)[None]
            + b_ot[:, None, None] * K + c_ot2[:, None, None] * K2)


def sim3_log_batch(S: np.ndarray) -> np.ndarray:
    """[N, 4, 4] -> [N, 7]; vectorized twin of :func:`sim3_log`."""
    sR = S[:, :3, :3]
    s = np.cbrt(np.linalg.det(sR))
    lam = np.log(np.maximum(s, _EPS))
    R = sR / s[:, None, None]
    phi = _so3_log_batch(R)
    W = _calc_W_batch(phi, lam)
    rho = np.linalg.solve(W, S[:, :3, 3][..., None])[..., 0]
    return np.concatenate([rho, phi, lam[:, None]], -1)


def sim3_exp_batch(xi: np.ndarray) -> np.ndarray:
    """[N, 7] -> [N, 4, 4]; vectorized twin of :func:`sim3_exp`."""
    rho, phi, lam = xi[:, :3], xi[:, 3:6], xi[:, 6]
    th = np.linalg.norm(phi, axis=-1)
    K = _hat_batch(phi)
    K2 = K @ K
    big = th > 1e-9
    th_s = np.where(big, th, 1.0)
    A = np.where(big, np.sin(th) / th_s, 1.0)
    B = np.where(big, (1 - np.cos(th)) / (th_s * th_s), 0.5)
    R = (np.eye(3)[None] + A[:, None, None] * K + B[:, None, None] * K2)
    S = np.tile(np.eye(4), (len(xi), 1, 1))
    S[:, :3, :3] = np.exp(lam)[:, None, None] * R
    S[:, :3, 3] = (_calc_W_batch(phi, lam) @ rho[..., None])[..., 0]
    return S


def sim3_inv_batch(S: np.ndarray) -> np.ndarray:
    sR = S[:, :3, :3]
    s2 = np.cbrt(np.linalg.det(sR)) ** 2
    Rinv = np.swapaxes(sR, 1, 2) / s2[:, None, None]
    out = np.tile(np.eye(4), (len(S), 1, 1))
    out[:, :3, :3] = Rinv
    out[:, :3, 3] = -(Rinv @ S[:, :3, 3][..., None])[..., 0]
    return out


# ---------------------------------------------------------------------------
# Graph construction + Gauss-Newton


class Sim3Edge(NamedTuple):
    a: int  # node position (not frame index)
    b: int
    M: np.ndarray  # [4, 4] measured Sim3, maps X_b -> X_a (a <- b)
    w: np.ndarray  # [7] per-component sqrt-information (rho, phi, lam)
    huber: float  # residual-norm Huber delta; 0 = quadratic (odometry)


def _edge_residual(nodes: np.ndarray, e: Sim3Edge) -> np.ndarray:
    P = sim3_inv(nodes[e.a]) @ nodes[e.b]
    return sim3_log(sim3_inv(e.M) @ P)


def optimize_sim3_graph(nodes: np.ndarray, edges: list[Sim3Edge],
                        iters: int = 30, mu0: float = 1e-4,
                        ) -> tuple[np.ndarray, float]:
    """Levenberg-damped Gauss-Newton over Sim(3) nodes; node 0 pinned.

    nodes: [N, 4, 4] initial Sim(3) guesses (chain poses, s=1).
    Returns (optimized nodes, final robust cost). Huber IRLS weights
    recomputed every iteration from each edge's current residual norm.

    Jacobians are forward differences taken MULTIPLICATIVELY: perturbing
    node a by exp(h e_k) changes the prediction P = Na^-1 Nb to
    exp(-h e_k) P (and the b side to P exp(h e_k)), so the 14 constant
    matrices exp(+-h e_k) are precomputed once and every column costs
    one 4x4 matmul + one log — all evaluated in ONE batched
    ``sim3_log_batch`` pass of 14 x n_edges matrices per iteration
    (profiled 25x faster than per-edge scalar calls at KITTI scale).
    """
    nodes = np.asarray(nodes, np.float64).copy()
    N = len(nodes)
    E = len(edges)
    dim = 7 * (N - 1)  # node 0 pinned
    ai = np.array([e.a for e in edges])
    bi = np.array([e.b for e in edges])
    M = np.stack([e.M for e in edges])
    Minv = sim3_inv_batch(M)
    w = np.stack([e.w for e in edges])  # [E, 7]
    hub = np.array([e.huber for e in edges])
    h = 1e-7
    Epos = sim3_exp_batch(h * np.eye(7))  # [7, 4, 4]
    Eneg = sim3_exp_batch(-h * np.eye(7))
    # Minv @ exp(-h e_k): constant across iterations. [E, 7, 4, 4]
    MinvEneg = np.einsum("eij,kjl->ekil", Minv, Eneg)

    def residuals(nds: np.ndarray) -> np.ndarray:
        P = sim3_inv_batch(nds[ai]) @ nds[bi]
        return sim3_log_batch(Minv @ P), P

    def cost_of(r: np.ndarray) -> float:
        n2 = np.einsum("ek,ek->e", w * r, w * r)
        lin = (hub > 0) & (n2 > hub * hub)
        n = np.sqrt(np.maximum(n2, 1e-300))
        return float(np.where(lin, hub * (2 * n - hub), n2).sum())

    mu = mu0
    r_cur, P_cur = residuals(nodes)
    cur = cost_of(r_cur)
    for _ in range(iters):
        r0, P0 = r_cur, P_cur
        # Robust (IRLS) weight per edge from the Huber slope.
        nrm = np.linalg.norm(w * r0, axis=-1)
        rw = np.where((hub > 0) & (nrm > hub),
                      hub / np.maximum(nrm, 1e-300), 1.0)
        # Perturbed predictions, all edges x all 14 columns at once.
        pert_a = MinvEneg @ P0[:, None]  # [E, 7, 4, 4]
        E0 = Minv @ P0
        pert_b = np.einsum("eij,kjl->ekil", E0, Epos)
        pert = np.concatenate([pert_a, pert_b], 1)  # [E, 14, 4, 4]
        logs = sim3_log_batch(pert.reshape(-1, 4, 4)).reshape(E, 14, 7)
        J = (logs - r0[:, None]) / h  # [E, 14, 7] (cols-first layout)
        Jw = np.swapaxes(J, 1, 2) * w[:, :, None] \
            * np.sqrt(rw)[:, None, None]  # [E, 7, 14]
        rv = (w * r0) * np.sqrt(rw)[:, None]
        JtJ = np.einsum("erc,erd->ecd", Jw, Jw)  # [E, 14, 14]
        Jtr = np.einsum("erc,er->ec", Jw, rv)
        # Sparse normal equations: the graph is a chain plus a few loop
        # blocks, so H is block-tridiagonal + O(n_loops) off-band 7x7
        # blocks — a dense solve was 75% of the wall at KITTI scale
        # (3900^2 LAPACK per damping try); sparse LU is milliseconds.
        gidx = np.concatenate([  # [E, 14] global col per local col
            np.where(ai[:, None] == 0, -1,
                     7 * (ai[:, None] - 1) + np.arange(7)),
            np.where(bi[:, None] == 0, -1,
                     7 * (bi[:, None] - 1) + np.arange(7)),
        ], 1)
        valid = gidx >= 0
        g = np.zeros(dim)
        np.add.at(g, gidx[valid], Jtr[valid])
        rows = np.broadcast_to(gidx[:, :, None], (E, 14, 14))
        cols = np.broadcast_to(gidx[:, None, :], (E, 14, 14))
        vmask = valid[:, :, None] & valid[:, None, :]
        H = sparse.coo_matrix(
            (JtJ[vmask], (rows[vmask], cols[vmask])),
            shape=(dim, dim)).tocsc()
        if float(np.abs(g).max(initial=0.0)) < 1e-12:
            break
        dH = sparse.diags(np.maximum(H.diagonal(), 1e-12))
        ok = False
        for _try in range(8):
            try:
                delta = splinalg.splu(
                    (H + mu * dH).tocsc()).solve(-g)
                if not np.all(np.isfinite(delta)):
                    raise RuntimeError("singular")
            except (RuntimeError, ValueError):
                mu *= 10
                continue
            cand = nodes.copy()
            cand[1:] = nodes[1:] @ sim3_exp_batch(delta.reshape(N - 1, 7))
            r_new, P_new = residuals(cand)
            c_new = cost_of(r_new)
            if c_new < cur:
                rel = (cur - c_new) / max(cur, 1e-300)
                nodes, cur, r_cur, P_cur = cand, c_new, r_new, P_new
                mu = max(mu / 3, 1e-9)
                ok = True
                if rel < 1e-10:  # converged
                    return nodes, cur
                break
            mu *= 10
        if not ok:
            break
    return nodes, cur


# ---------------------------------------------------------------------------
# Building the graph from a trajectory + verified loops


def _se3_embed(T: np.ndarray, s_rel: float) -> np.ndarray:
    """Embed an SE(3) measurement as Sim(3) with relative scale s_rel
    (scale multiplies only the rotation block: the translation is fixed
    in the SOURCE node's local units by construction of P_ab)."""
    M = np.asarray(T, np.float64).copy()
    M[:3, :3] = s_rel * M[:3, :3]
    return M


def build_graph(traj: np.ndarray, loops: list[Loop],
                node_idx: list[int],
                odo_t_sigma: float = 0.03,
                # Rotation trust is deliberately LOOSE (0.02 rad/edge):
                # swept across a clean-drift and a catastrophic-turn
                # regime (30% rotation collapse through one arc, the
                # failure KLT actually produces), 0.02 is neutral on the
                # former and 20% better on the latter — verified loop
                # rotations (Huber + chi2-pruned) deserve to dominate a
                # chain segment that is grossly wrong.
                odo_r_sigma: float = 0.02,
                odo_s_rate: float = 0.004,
                loop_t_frac: float = 0.05,
                loop_r_sigma: float = 0.01,
                loop_s_sigma: float = 0.05,
                huber: float = 3.0) -> tuple[np.ndarray, list[Sim3Edge]]:
    """Nodes (chain poses at node_idx, s=1) + odometry and loop edges.

    Odometry scale sigma grows as ``odo_s_rate * span_frames`` — the
    chain's scale random-walk — so loop scale observations dominate over
    long spans but cannot bend a single step. Translation sigmas are
    relative (fraction of the measured norm, floored) since both
    families measure in local chain units.
    """
    traj = np.asarray(traj, np.float64)
    pos = {f: k for k, f in enumerate(node_idx)}
    nodes = traj[np.asarray(node_idx)].copy()
    edges: list[Sim3Edge] = []
    for k in range(len(node_idx) - 1):
        a, b = node_idx[k], node_idx[k + 1]
        T_ab = np.linalg.inv(traj[a]) @ traj[b]
        tn = float(np.linalg.norm(T_ab[:3, 3]))
        span = max(b - a, 1)
        w = np.concatenate([
            np.full(3, 1.0 / max(odo_t_sigma * max(tn, 0.1), _EPS)),
            np.full(3, 1.0 / odo_r_sigma),
            [1.0 / (odo_s_rate * span)],
        ])
        edges.append(Sim3Edge(k, k + 1, _se3_embed(T_ab, 1.0), w, 0.0))
    for lp in loops:
        if lp.i not in pos or lp.j not in pos:
            continue
        # verify_loop's T_meas maps X_i -> X_j; the edge measurement is
        # the i <- j map with relative scale 1/sigma (sigma = accumulated
        # drift sigma_j / sigma_i; s_k estimates its inverse).
        T_ij = np.linalg.inv(np.asarray(lp.T_meas, np.float64))
        tn = float(np.linalg.norm(T_ij[:3, 3]))
        zero_baseline = tn < 1e-9 or not np.isfinite(lp.sigma)
        s_rel = 1.0 if zero_baseline else 1.0 / float(lp.sigma)
        # Measurement information grows ~ sqrt(inliers): a 400-inlier
        # revisit must out-pull a marginal 30-inlier one when they
        # conflict (Huber alone equalizes large residuals to a constant
        # pull, so relative weight IS the tie-breaker).
        inl = np.clip(np.sqrt(max(lp.n_inliers, 1) / 100.0), 0.5, 4.0)
        w = inl * np.concatenate([
            np.full(3, 1.0 / max(loop_t_frac * max(tn, 0.1), _EPS)),
            np.full(3, 1.0 / loop_r_sigma),
            [0.0 if zero_baseline or lp.sigma == 1.0
             else 1.0 / loop_s_sigma],
        ])
        edges.append(Sim3Edge(pos[lp.i], pos[lp.j], _se3_embed(T_ij, s_rel),
                              w, huber))
    return nodes, edges


def _fit_segment(sub: np.ndarray, Ta_new: np.ndarray, Tb_new: np.ndarray,
                 ls_a: float, ls_b: float) -> np.ndarray:
    """Rebuild poses between two solved nodes, endpoint-exact at both.

    sub: original chain poses [m+1, 4, 4] from node a to node b. Step
    norms are multiplied by the geometric interpolation of the solved
    drift-inverse exp(ls) (= s_k, chain units -> gauge units), then the
    remaining endpoint discrepancy is spread rigidly in the local frame
    (the spread_drift ramp restricted to one segment)."""
    m = len(sub) - 1
    if m == 0:
        return Ta_new[None].copy()
    steps = np.linalg.inv(sub[:-1]) @ sub[1:]
    for k in range(m):
        a = (k + 0.5) / m
        steps[k, :3, 3] *= np.exp((1 - a) * ls_a + a * ls_b)
    out = np.empty_like(sub)
    out[0] = Ta_new
    for k in range(m):
        out[k + 1] = out[k] @ steps[k]
    Ta_inv = np.linalg.inv(Ta_new)
    Delta = Ta_inv @ Tb_new @ np.linalg.inv(out[m]) @ Ta_new
    xi = se3_log_np(Delta)
    base = out.copy()
    for k in range(1, m + 1):
        out[k] = Ta_new @ se3_exp_np(k / m * xi) @ Ta_inv @ base[k]
    return out


def self_consistency(traj_old: np.ndarray, traj_new: np.ndarray,
                     loops: list[Loop], max_scale: float = 2.0,
                     ) -> tuple[bool, dict]:
    """Acceptance gate for a pose-graph correction (measured necessity:
    on a course whose odometry is broken beyond smooth drift — KLT turn
    collapses leaving self-consistent ~40%-of-true rotations — the
    zero-baseline position constraints can be 'satisfied' cheapest by
    inflating the scale DOF, and the chip run of the two-lap course did
    exactly that: length ratio 0.46 -> 3.37 with sim3 ATE unimproved,
    POSE_GRAPH.json r5). Two checks, both on quantities the pipeline can
    compute WITHOUT ground truth:

    - the net length change must stay inside ``max_scale`` (a genuine
      drift correction is bounded by plausible accumulated drift; a 7x
      blow-up is the solver exploiting an unobservable direction);
    - the summed positional loop gaps must actually shrink (the solve
      must deliver the thing the loops assert).

    Returns (accept, stats)."""
    def length(t):
        return float(np.linalg.norm(
            np.diff(np.asarray(t, np.float64)[:, :3, 3], axis=0),
            axis=1).sum())

    def gaps(t):
        t = np.asarray(t, np.float64)
        s = 0.0
        for lp in loops:
            pos_meas = (t[lp.i] @ np.linalg.inv(
                np.asarray(lp.T_meas, np.float64)))[:3, 3]
            s += float(np.linalg.norm(pos_meas - t[lp.j, :3, 3]))
        return s

    fac = length(traj_new) / max(length(traj_old), 1e-12)
    g_old, g_new = gaps(traj_old), gaps(traj_new)
    ok = (1.0 / max_scale <= fac <= max_scale) and g_new < g_old
    return ok, {"length_factor": round(fac, 4),
                "loop_gap_before": round(g_old, 3),
                "loop_gap_after": round(g_new, 3)}


def optimize_pose_graph(traj: np.ndarray, loops: list[Loop],
                        stride: int = 8, iters: int = 30,
                        **graph_kwargs) -> np.ndarray:
    """Joint multi-loop correction of a full trajectory.

    Nodes are placed on the keyframe stride plus every loop endpoint and
    both trajectory ends; the Sim(3) graph is solved; the full-res
    trajectory is rebuilt segment-by-segment (original steps, solved
    scale ramp, rigid endpoint spread). With a single loop this agrees
    with ``spread_drift``'s behavior (endpoint-exact closure, drift
    distributed along the span) while overlapping multi-loop spans are
    reconciled jointly instead of greedily dropped."""
    traj64 = np.asarray(traj, np.float64)
    F = len(traj64)
    idx = set(range(0, F, stride)) | {F - 1}
    for lp in loops:
        idx.update((int(lp.i), int(lp.j)))
    node_idx = sorted(i for i in idx if 0 <= i < F)
    nodes0, edges = build_graph(traj64, loops, node_idx, **graph_kwargs)
    if not any(e.huber > 0 for e in edges):
        return np.asarray(traj)
    nodes, _ = optimize_sim3_graph(nodes0, edges, iters=iters)
    # Outlier-edge pruning (the essential-graph chi^2 pass): a FALSE
    # loop that survived geometric verification keeps a large robust
    # residual at the Huber-converged solution — mutually-consistent
    # true loops are satisfied, the contradiction cannot be. Drop loop
    # edges whose weighted residual norm stays far outside the Huber
    # band and re-solve FROM THE CHAIN (the first solution was bent by
    # the outlier's constant pull). Never prunes the whole loop set.
    loop_edges = [e for e in edges if e.huber > 0]
    resid = {id(e): float(np.linalg.norm(e.w * _edge_residual(nodes, e)))
             for e in loop_edges}
    cut = 4.0 * max(e.huber for e in loop_edges)
    keep_best = min(loop_edges, key=lambda e: resid[id(e)])
    pruned = [e for e in loop_edges
              if resid[id(e)] > cut and e is not keep_best]
    if pruned:
        pruned_ids = {id(e) for e in pruned}
        survivors = [e for e in edges if id(e) not in pruned_ids]
        nodes, _ = optimize_sim3_graph(nodes0, survivors, iters=iters)
    # Per-node solved pose (SE(3) part) + log drift-inverse.
    ls = np.empty(len(nodes))
    T_new = np.empty_like(nodes)
    for k, S in enumerate(nodes):
        s = float(np.cbrt(np.linalg.det(S[:3, :3])))
        ls[k] = np.log(max(s, _EPS))
        T_new[k] = np.eye(4)
        T_new[k, :3, :3] = S[:3, :3] / s
        T_new[k, :3, 3] = S[:3, 3]
    out = np.empty_like(traj64)
    for k in range(len(node_idx) - 1):
        a, b = node_idx[k], node_idx[k + 1]
        seg = _fit_segment(traj64[a: b + 1], T_new[k], T_new[k + 1],
                           ls[k], ls[k + 1])
        out[a: b + 1] = seg
    return out.astype(np.asarray(traj).dtype)
