"""Loop closure: keyframe retrieval, verification and drift correction
(port of ``epivo_tpu/pipeline/loopclose.py``).

1. **Retrieval.** Every keyframe's pyramid ORB descriptors come from one
   :func:`orb.detect_and_describe_pyramid` call on the keyframe stack, and
   every keyframe is scored against every other by mutual-nearest-neighbour
   Hamming matches (:func:`retrieval_scores`): the [M, M] Hamming tables
   are one ±1 matmul per chunk of queries, exact in float32. No vocabulary
   tree: at keyframe counts of hundreds, brute-force scoring is cheap and
   has no training artifact.
2. **Verification.** A shortlisted candidate runs the ORB two-view step
   (match, RANSAC-E, recoverPose, LM) on the loop pair (i, j) and on the
   adjacent pair (i, i+1), both in one B = 2 call
   (:func:`vo.vo_step_orb_batched`). Frame i's keypoints triangulate in
   both pairs, so the depth-ratio median gives |t_loop| / |t_{i,i+1}|
   (monocular norm recovery through shared structure), and |t_{i,i+1}|
   is read off the trajectory. The adjacent frame, not the next keyframe,
   is stored for this: descriptor matching across a metres-long forward
   step dies of scale change, while the one-frame pair is trivial.
3. **Correction.** :func:`spread_drift`: when the loop has baseline, the
   accumulated scale drift is measured from reverse-direction shared
   structure (:func:`measure_scale_drift`) and absorbed as a log-linear
   ramp of the step norms; the remaining SE(3) discrepancy is spread over
   the intervening poses in each pose's local frame, closing the loop
   exactly at its endpoints. Zero-baseline revisits spread SE(3) only:
   fitting a scale to their positional gap mistakes yaw drift for scale.
   With two or more loops, :mod:`posegraph` reconciles them in one Sim(3)
   pose-graph solve behind a self-consistency gate.

Keyframes stay on the host as half-resolution uint8
(:class:`KeyframeStore`); the stack goes to the device once per pass. The
SE(3) algebra of the drift spread, the shortlist and every gate run on the
host in float64, as in the reference. Random draws come from a
``torch.Generator`` on the device, seeded from ``seed + 7777``
(:func:`close_loops`) or ``seed + 3333`` (:func:`relocalize`); the
verifiers take ``ransac_samples`` [2, n_hyp, m] (m the solver's sample
size) to replace them.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from epivo_tpu_torch._device import runner_device, upload
from epivo_tpu_torch.pipeline.config import LoopConfig, VOConfig


class Loop(NamedTuple):
    i: int  # earlier frame index
    j: int  # later frame index (revisit)
    T_meas: np.ndarray  # [4, 4] measured i->j transform, |t| in chain units
    n_inliers: int
    score: int  # retrieval mutual-match count
    sigma: float = 1.0  # accumulated scale-drift factor spread over [i, j]


# ---------------------------------------------------------------------------
# Host SE(3) exp / log (float64 numpy, closed-form Rodrigues): the drift
# spread corrects every pose of the trajectory's tail.


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * (K @ K))


def se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """[6] (v, w) -> [4, 4], float64 Rodrigues (matches geometry.se3)."""
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    T = np.eye(4)
    T[:3, :3] = _so3_exp_np(w)
    if th < 1e-12:
        V = np.eye(3) + 0.5 * K
    else:
        V = (np.eye(3) + (1 - np.cos(th)) / th**2 * K
             + (th - np.sin(th)) / th**3 * (K @ K))
    T[:3, 3] = V @ v
    return T


def se3_log_np(T: np.ndarray) -> np.ndarray:
    """[4, 4] -> [6] (v, w), float64."""
    R = T[:3, :3]
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-9:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
    else:
        w = th / (2 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        Vinv = np.eye(3) - 0.5 * K
    else:
        Vinv = (np.eye(3) - 0.5 * K
                + (1 / th**2 - (1 + np.cos(th)) / (2 * th * np.sin(th)))
                * (K @ K))
    return np.concatenate([Vinv @ T[:3, 3], w])


# ---------------------------------------------------------------------------


def keyframe_half(frame: np.ndarray) -> np.ndarray:
    """Half-resolution keyframe copy (2x2 box filter), quantized to uint8:
    an eighth of the float original's memory and a quarter of its ORB
    cost; verification angles do not depend on resolution, and the
    oriented-BRIEF signs tolerate 8-bit quantization."""
    f = np.asarray(frame, np.float32)
    H2, W2 = f.shape[0] // 2, f.shape[1] // 2
    f = f[: 2 * H2, : 2 * W2]
    half = 0.25 * (f[0::2, 0::2] + f[0::2, 1::2] + f[1::2, 0::2]
                   + f[1::2, 1::2])
    return np.clip(np.rint(half), 0, 255).astype(np.uint8)


class KeyframeStore:
    """Bounded keyframe memory for the loop-closure tee.

    Stores (keyframe k, adjacent k+1) uint8 half-resolution pairs for
    every k % stride == 0. When the stored-frame count would exceed
    ``budget``, the stride DOUBLES: the keyframes off the new stride are
    dropped and later offers follow the wider stride, so a full KITTI
    sequence holds at most ``budget`` half-resolution uint8 frames
    (~budget * 0.12 MB at KITTI size) instead of growing without bound.
    """

    def __init__(self, stride: int, budget: int = 512):
        self.stride = int(stride)
        self.budget = max(4, int(budget))
        self.frames: dict[int, np.ndarray] = {}

    def offer(self, idx: int, frame: np.ndarray) -> None:
        r = idx % self.stride
        if r > 1:
            return
        self.frames[idx] = keyframe_half(frame)
        if len(self.frames) > self.budget:
            self.stride *= 2
            self.frames = {
                k: v for k, v in self.frames.items()
                if (k % self.stride) <= 1
            }

    def __len__(self) -> int:
        return len(self.frames)

    def __bool__(self) -> bool:
        return bool(self.frames)

    def get(self, idx: int) -> np.ndarray:
        return self.frames[idx].astype(np.float32)

    def as_dict(self) -> dict[int, np.ndarray]:
        return {k: v.astype(np.float32) for k, v in self.frames.items()}


def _describe_batch(imgs: torch.Tensor, cfg: LoopConfig, fast_threshold):
    """[N, H, W] keyframes -> (signs [N, M, 256], valid [N, M]) from one
    pyramid ORB call on the whole stack."""
    from epivo_tpu_torch.frontend import orb

    kp, d, _ = orb.detect_and_describe_pyramid(imgs, fast_threshold, cfg.max_keypoints)
    return d.signs, kp.valid & d.valid


def _chunk_size(N: int, M: int, max_bytes: int = 1 << 30) -> int:
    """Queries per :func:`retrieval_scores` chunk: the [chunk, N, M, M]
    float32 table stays under ``max_bytes``."""
    return max(1, min(N, max_bytes // max(4 * N * M * M, 1)))


def retrieval_scores(signs, valid, max_dist: float) -> torch.Tensor:
    """[N, N] mutual-match counts between all keyframe pairs (int64, on the
    descriptors' device).

    score[q, k] = the number of descriptors in q whose nearest neighbour in
    k is mutual AND within the Hamming gate: the criterion the verifier's
    matcher applies, so the retrieval score predicts verifiability. The
    reference's map over queries runs here as a loop over chunks of
    queries (:func:`_chunk_size`), each one ±1 matmul and three reductions
    with no host sync. Masked lanes get distance 1e9
    and ties go to the first minimum, as ``jnp.argmin`` breaks them.
    """
    signs = torch.as_tensor(signs)
    valid = torch.as_tensor(valid, device=signs.device)
    N, M, B = signs.shape
    step = _chunk_size(N, M)
    flat = signs.reshape(N * M, B)
    rows = torch.arange(M, device=signs.device)
    out = []
    for q0 in range(0, N, step):
        sq, vq = signs[q0 : q0 + step], valid[q0 : q0 + step]  # [Q, M, B], [Q, M]
        Q = sq.shape[0]
        # D[q, k, m, n]: query q's row m against keyframe k's column n.
        D = (sq.reshape(Q * M, B) @ flat.T).reshape(Q, M, N, M).permute(0, 2, 1, 3)
        D = D.neg_().add_(B).mul_(0.5)  # (B - dot) / 2, in place
        D.masked_fill_(~(vq[:, None, :, None] & valid[None, :, None, :]), 1e9)
        best2 = torch.argmin(D, dim=3)  # [Q, N, M]
        dist = torch.amin(D, dim=3)
        best1 = torch.argmin(D, dim=2)  # [Q, N, M']
        mutual = torch.gather(best1, 2, best2) == rows
        out.append(torch.sum(mutual & (dist <= max_dist), dim=2))  # [Q, N]
    return torch.cat(out)


def shortlist(scores: np.ndarray, kf_idx: list[int], cfg: LoopConfig,
              per_query: int = 3) -> list[tuple[int, int, int]]:
    """Pick per-query top earlier keyframes passing the gap and score gates.

    Returns [(qi_pos, ki_pos, score)] sorted by score descending, at most
    ``per_query`` candidates per query keyframe. More than one per query
    matters in self-similar places: the best-scoring match can be a
    perceptually ALIASED keyframe whose verified loop the odometry gate
    then rejects, and the true revisit is often the second or third hit."""
    scores = np.asarray(scores)
    out = []
    for q in range(len(kf_idx)):
        row = [(int(scores[q, k]), k) for k in range(q)
               if kf_idx[q] - kf_idx[k] >= cfg.min_gap
               and scores[q, k] >= cfg.min_matches]
        row.sort(reverse=True)
        out.extend((q, k, s) for s, k in row[:per_query])
    out.sort(key=lambda r: -r[2])
    return out


class LoopMeasurement(NamedTuple):
    T_meas: np.ndarray  # [4, 4] i->j, |t| in chain units
    n_inliers: int
    zero_baseline: bool  # the t=0 coincidence branch fired
    ratio: float  # |t_loop| / |t_{i,i+1}| (nan on the t=0 branch)


def _vo_pairs(src: np.ndarray, tgt_a: np.ndarray, tgt_b: np.ndarray, vo_cfg: VOConfig,
              generator: torch.Generator | None, ransac_samples, device):
    """The ORB two-view step on (src, tgt_a) and (src, tgt_b) as one B = 2
    call on ``device``, back in one device-to-host copy. Returns
    (T [2, 4, 4] float64, n_inliers [2], reverted [2], depth [2, K],
    points_valid [2, K])."""
    from epivo_tpu_torch.pipeline import vo

    dev = runner_device(device)
    img = upload(np.stack([src, src, tgt_a, tgt_b]).astype(np.float32), dev)
    smp = None if ransac_samples is None else torch.as_tensor(ransac_samples).to(dev)
    r = vo.vo_step_orb_batched(img[:2], img[2:], generator, vo_cfg, ransac_samples=smp)
    h = torch.cat([r.T.reshape(2, 16), r.n_inliers[:, None].to(r.T.dtype),
                   r.reverted[:, None].to(r.T.dtype), r.points[..., 2],
                   r.points_valid.to(r.T.dtype)], dim=1).cpu().numpy()
    K = r.points.shape[1]
    return (h[:, :16].reshape(2, 4, 4).astype(np.float64), h[:, 16].astype(np.int64),
            h[:, 17] > 0.5, h[:, 18 : 18 + K], h[:, 18 + K :] > 0.5)


def verify_loop(img_i: np.ndarray, img_j: np.ndarray,
                img_i_next: np.ndarray, t_next_norm: float,
                vo_cfg: VOConfig, generator: torch.Generator | None = None,
                ransac_samples=None, device=None) -> LoopMeasurement | None:
    """Geometric verification and monocular norm recovery for one candidate.

    Runs the ORB two-view step on (i, j) and on the adjacent pair (i, i+1)
    in one B = 2 call; frame i's keypoints shared between the two
    triangulations give |t_loop| / |t_{i,i+1}| as a depth-ratio median
    (the no-GT chain's shared-structure scheme), and ``t_next_norm`` (the
    trajectory's step norm) converts it to chain units. ``generator``
    draws both lanes' RANSAC samples; ``ransac_samples`` [2, n_hyp, m]
    replaces that draw.

    The parallax-degenerate t=0 branch (almost no loop inlier
    triangulates: the revisit is epipolar-consistent with ZERO baseline)
    carries no odometry check here: bounding it by the trajectory's
    predicted translation rejects exactly the loops that matter, since
    under real drift the prediction is what is wrong. The caller's
    :func:`implied_drift_rate` budget enforces odometry consistency
    instead.
    """
    T2, n_inl2, rev, depth, pv = _vo_pairs(img_i, img_j, img_i_next, vo_cfg, generator,
                                           ransac_samples, device)
    n_inl = int(n_inl2[0])
    if bool(rev[0]) or bool(rev[1]):
        return None
    T = T2[0].copy()
    n = np.linalg.norm(T[:3, 3])
    d_loop, d_next = depth[0], depth[1]
    lv = pv[0]
    ok = lv & pv[1] & (d_loop > 1e-3) & (d_next > 1e-3)
    if ok.sum() >= 8 and n > 1e-9:
        # Shared structure: the monocular norm through the depth-ratio
        # median against the adjacent pair.
        ratio = float(np.median(d_next[ok] / d_loop[ok]))
        if not np.isfinite(ratio) or ratio <= 0:
            return None
        T[:3, 3] *= ratio * t_next_norm / n
        return LoopMeasurement(T, n_inl, False, ratio)
    if lv.sum() < 0.2 * max(n_inl, 1):
        # The loop pair itself is parallax-degenerate: the match is
        # epipolar-consistent with ZERO baseline, and that IS the
        # measurement.
        T[:3, 3] = 0.0
        return LoopMeasurement(T, n_inl, True, float("nan"))
    return None


def measure_scale_drift(img_j, img_i, img_j_next, t_next_norm_j: float,
                        loop_t_chain_i: float, vo_cfg: VOConfig,
                        generator: torch.Generator | None = None,
                        ransac_samples=None, device=None) -> float | None:
    """Accumulated scale-drift factor sigma over the loop span.

    The loop translation is one physical length measured twice through
    shared structure: at frame i (|t_loop| in chain units at i, the
    forward verification) and at frame j (the reverse pair (j, i) against
    (j, j+1), one B = 2 call). Their ratio is the chain's accumulated
    scale drift between i and j:

        sigma = (ratio_j * |t_{j,j+1}|_chain) / |t_loop|_chain_at_i

    Returns sigma, or None when the reverse pair cannot be verified or the
    loop has too little baseline for the ratio to mean anything.
    ``generator`` / ``ransac_samples`` as in :func:`verify_loop`.
    """
    _, _, rev, depth, pv = _vo_pairs(img_j, img_i, img_j_next, vo_cfg, generator,
                                     ransac_samples, device)
    if bool(rev[0]) or bool(rev[1]):
        return None
    d_loop, d_next = depth[0], depth[1]
    ok = pv[0] & pv[1] & (d_loop > 1e-3) & (d_next > 1e-3)
    if ok.sum() < 8 or loop_t_chain_i <= 1e-9:
        return None
    ratio_j = float(np.median(d_next[ok] / d_loop[ok]))
    if not np.isfinite(ratio_j) or ratio_j <= 0:
        return None
    sigma = ratio_j * t_next_norm_j / loop_t_chain_i
    if not np.isfinite(sigma) or sigma <= 0:
        return None
    return float(sigma)


def _apply_scale_ramp(traj: np.ndarray, i: int, j: int,
                      sigma: float) -> np.ndarray:
    """Divide step translations by a log-linear ramp 1 -> sigma over
    [i, j) (and by sigma after j): undoes an accumulated scale drift of
    factor sigma at j relative to i. Rotations untouched."""
    traj = np.asarray(traj, np.float64)
    F = traj.shape[0]
    steps = np.linalg.inv(traj[:-1]) @ traj[1:]
    ls = np.log(sigma)
    for k in range(i, F - 1):
        a = min(1.0, (k - i + 0.5) / max(j - i, 1))
        steps[k, :3, 3] *= np.exp(-a * ls)
    out = traj.copy()
    for k in range(i, F - 1):
        out[k + 1] = out[k] @ steps[k]
    return out


def spread_drift(traj: np.ndarray, i: int, j: int, T_meas: np.ndarray,
                 sigma: float = 1.0) -> np.ndarray:
    """Distribute the loop discrepancy along poses i..j (local frames).

    traj: [F, 4, 4] camera-to-world. T_meas maps X_i -> X_j (the VO pair
    convention), translation already in chain units. With ``sigma`` != 1
    the step norms first absorb the accumulated scale drift (a log-linear
    ramp over the span, carried past j), the Sim(3) part, and the
    REMAINING discrepancy is spread rigidly: anchored in pose i's frame
    (Delta = inv(traj_i) @ traj_j_meas @ inv(traj_j) @ traj_i), applied as
    traj'_k = traj_i @ exp(alpha_k log(Delta)) @ inv(traj_i) @ traj_k with
    alpha ramping 0 -> 1 over [i, j] and staying 1 after j (a rigid carry
    of the post-loop segment). Anchoring at pose i gives rotational drift
    its physical lever arm. Endpoint-exact: inv(traj'_i) @ traj'_j ==
    inv(T_meas). All host float64."""
    traj = np.asarray(traj, np.float64)
    if sigma != 1.0:
        traj = _apply_scale_ramp(traj, i, j, sigma)
    Ti = traj[i]
    Ti_inv = np.linalg.inv(Ti)
    traj_j_meas = Ti @ np.linalg.inv(T_meas)
    Delta = Ti_inv @ traj_j_meas @ np.linalg.inv(traj[j]) @ Ti
    xi = se3_log_np(Delta)
    out = traj.copy()
    F = traj.shape[0]
    alphas = np.minimum(1.0, (np.arange(i + 1, F) - i) / max(j - i, 1))
    for k, a in zip(range(i + 1, F), alphas):
        out[k] = Ti @ se3_exp_np(a * xi) @ Ti_inv @ traj[k]
    return out


def implied_drift_rate(traj: np.ndarray, i: int, j: int,
                       T_meas: np.ndarray) -> float:
    """Odometry-consistency measure of a candidate loop: the positional
    discrepancy the loop would correct, over the path length travelled
    between i and j (both in the trajectory's own units).

    A TRUE loop's discrepancy is the chain's accumulated drift, a fraction
    of the path (~0.3 on the 93 m out-and-back course in the reference's
    runs). A PERCEPTUALLY ALIASED candidate (repeating facades, tiled
    textures) verifies geometrically but implies the chain is wrong by
    ~100 % of the distance travelled. Loop acceptance gates on this rate
    (``LoopConfig.max_drift_rate``)."""
    traj = np.asarray(traj, np.float64)
    pos_meas = (traj[i] @ np.linalg.inv(np.asarray(T_meas, np.float64)))[:3, 3]
    disc = float(np.linalg.norm(pos_meas - traj[j][:3, 3]))
    path = float(np.linalg.norm(
        np.diff(traj[i : j + 1, :3, 3], axis=0), axis=-1).sum())
    return disc / max(path, 1e-9)


def _keyframe_index(keyframes, lcfg: LoopConfig):
    """(stride, {idx: float32 image}, keyframe indices with their adjacent
    frame stored) of a :class:`KeyframeStore` or a plain dict."""
    if isinstance(keyframes, KeyframeStore):
        stride = keyframes.stride
        keyframes = keyframes.as_dict()
    else:
        stride = lcfg.keyframe_stride
        keyframes = {k: np.asarray(v, np.float32) for k, v in keyframes.items()}
    kf_idx = [k for k in sorted(keyframes) if k % stride == 0 and k + 1 in keyframes]
    return stride, keyframes, kf_idx


def _scores(imgs: list, lcfg: LoopConfig, fast_threshold, dev, stats: dict) -> np.ndarray:
    """Describe the keyframe stack and score it (one upload, one copy back),
    timing both stages into ``stats``."""
    t0 = time.perf_counter()
    signs, valid = _describe_batch(upload(np.stack(imgs), dev), lcfg, fast_threshold)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    scores = retrieval_scores(signs, valid, lcfg.max_dist).cpu().numpy()
    stats["describe_s"] = t1 - t0
    stats["retrieval_s"] = time.perf_counter() - t1
    return scores


def relocalize(traj: np.ndarray, keyframes, config, vo_cfg_half: VOConfig,
               collapse_idx: int, seed: int = 0, mlog=None, device=None,
               stats: dict | None = None) -> tuple[np.ndarray, Loop | None]:
    """Kidnapped-robot re-entry: re-anchor the chain after a tracking
    collapse.

    After a collapse at ``collapse_idx`` the post-collapse segment is
    internally consistent but its anchor pose is garbage. Every
    post-collapse keyframe is scored against every PRE-collapse keyframe
    (the retrieval of :func:`close_loops`), the best candidates are
    verified in order, and the whole post-collapse segment is re-anchored
    rigidly so that inv(traj'_i) @ traj'_j == inv(T_meas). No drift is
    spread: the pre-collapse chain is trusted as it is.

    keyframes: KeyframeStore or {idx: half-res image} covering both sides
    of the collapse. Returns (trajectory, the applied Loop or None: None
    means no verifiable re-entry view exists yet). ``stats`` (a dict)
    receives the counts and the stages' host wall seconds.
    """
    from epivo_tpu_torch.frontend.orb import PATCH

    lcfg: LoopConfig = config.loop
    stats = {} if stats is None else stats
    stride, keyframes, kf_idx = _keyframe_index(keyframes, lcfg)
    pre = [k for k in kf_idx if k + 1 < collapse_idx]
    post = [k for k in kf_idx if k > collapse_idx and k + 1 < len(traj)]
    stats.update(keyframes=len(kf_idx), verifications=0, verify_s=0.0)
    if not pre or not post:
        return traj, None
    if min(keyframes[kf_idx[0]].shape) < 2 * PATCH:
        return traj, None
    dev = runner_device(device)
    # One retrieval pass: every post-collapse keyframe against every
    # pre-collapse one; the robot may not re-enter known territory at
    # once, so post keyframes are tried in order until one verifies.
    scores = _scores([keyframes[k] for k in pre + post], lcfg,
                     vo_cfg_half.frontend.fast_threshold, dev, stats)
    gen = torch.Generator(device=dev).manual_seed(seed + 3333)
    traj = np.asarray(traj, np.float64)
    for jp, j in enumerate(post):
        row = scores[len(pre) + jp][: len(pre)]
        order = np.argsort(-row)
        for kp_ in order[:3]:  # top candidates by retrieval score
            if row[kp_] < lcfg.min_matches:
                break
            i = pre[int(kp_)]
            t_next = np.linalg.inv(traj[i]) @ traj[i + 1]
            t0 = time.perf_counter()
            res = verify_loop(keyframes[i], keyframes[j], keyframes[i + 1],
                              float(np.linalg.norm(t_next[:3, 3])),
                              vo_cfg_half, gen, device=dev)
            stats["verifications"] += 1
            stats["verify_s"] += time.perf_counter() - t0
            if res is None or res.n_inliers < lcfg.min_inliers:
                continue
            # Rigid re-anchor of the post-collapse segment at pose j.
            T_j_new = traj[i] @ np.linalg.inv(res.T_meas)
            fix = T_j_new @ np.linalg.inv(traj[j])
            out = traj.copy()
            out[j:] = fix[None] @ traj[j:]
            lp = Loop(i, j, res.T_meas, res.n_inliers, int(row[kp_]))
            if mlog is not None:
                mlog.log({"stage": "relocalize", "i": i, "j": j,
                          "inliers": res.n_inliers, "score": int(row[kp_]),
                          "zero_baseline": bool(res.zero_baseline)})
            return out.astype(np.float32), lp
    return traj.astype(np.float32), None


def close_loops(traj: np.ndarray, keyframes, config,
                vo_cfg_half: VOConfig, seed: int = 0,
                mlog=None, device=None,
                stats: dict | None = None) -> tuple[np.ndarray, list[Loop]]:
    """Full loop-closure pass over an assembled trajectory.

    keyframes: a :class:`KeyframeStore` or {frame_idx: half-res image};
    each keyframe index k must also have its adjacent frame k+1 stored
    (the norm-recovery pair). Returns (corrected trajectory, applied
    loops). Retrieval is one describe call on ``device`` and one copy of
    the scores back; each verification is one B = 2 call.

    With ``config.loop.pose_graph`` (default) all accepted loops are
    COLLECTED (overlapping spans allowed, near-duplicate revisits skipped)
    and, when two or more verify, reconciled in one Sim(3) pose-graph
    solve (:mod:`epivo_tpu_torch.pipeline.posegraph`), kept only if it
    passes the self-consistency gate. A single accepted loop, a rejected
    joint solve, and the whole pass when ``pose_graph=False`` use the
    greedy endpoint-exact spread (one loop per non-overlapping span).

    ``stats`` (a dict) receives the keyframes, candidates, verifications
    (and scale-drift checks), loops applied, whether the pose graph ran
    and was accepted, and the host wall seconds of describe, retrieval,
    verification and the pose graph.
    """
    from epivo_tpu_torch.frontend.orb import PATCH

    lcfg: LoopConfig = config.loop
    stats = {} if stats is None else stats
    stride, keyframes, kf_idx = _keyframe_index(keyframes, lcfg)
    stats.update(keyframes=len(kf_idx), candidates=0, verifications=0, scale_checks=0,
                 loops_applied=0, pose_graph=None, verify_s=0.0, pose_graph_s=0.0)
    if len(kf_idx) < 3:
        return traj, []
    if min(keyframes[kf_idx[0]].shape) < 2 * PATCH:
        # Half-resolution keyframes too small for the oriented-BRIEF patch
        # (tiny test fixtures): loop closure has nothing to work with.
        return traj, []
    dev = runner_device(device)
    scores = _scores([keyframes[k] for k in kf_idx], lcfg,
                     vo_cfg_half.frontend.fast_threshold, dev, stats)
    cands = shortlist(scores, kf_idx, lcfg)
    stats["candidates"] = len(cands)

    gen = torch.Generator(device=dev).manual_seed(seed + 7777)
    applied: list[Loop] = []
    closed_spans: list[tuple[int, int]] = []
    traj = np.asarray(traj, np.float64)
    for (qp, kp_, score) in cands:
        if len(applied) >= lcfg.max_loops:
            break
        i, j = kf_idx[kp_], kf_idx[qp]  # i earlier, j revisit
        if lcfg.pose_graph:
            # Joint mode: overlapping spans are welcome (the graph
            # reconciles them), but each revisit frame contributes ONE
            # loop: a query matching several earlier keyframes is one
            # physical place, and the runner-up matches of a verified
            # query are the perceptual aliases. Neighbouring-keyframe
            # duplicates of one revisit re-measure the same constraint.
            if any(abs(j - b) <= 2 * stride for (_, b) in closed_spans):
                continue
        elif any(not (j < a or i > b) for (a, b) in closed_spans):
            # Greedy mode: one loop per overlapping span; spreading twice
            # over overlapping ranges double-corrects.
            continue
        if i + 1 >= traj.shape[0] or j + 1 >= traj.shape[0]:
            continue
        t_next = np.linalg.inv(traj[i]) @ traj[i + 1]
        t_next_norm = float(np.linalg.norm(t_next[:3, 3]))
        t0 = time.perf_counter()
        res = verify_loop(keyframes[i], keyframes[j], keyframes[i + 1],
                          t_next_norm, vo_cfg_half, gen, device=dev)
        stats["verifications"] += 1
        stats["verify_s"] += time.perf_counter() - t0
        if res is None:
            continue
        if res.n_inliers < lcfg.min_inliers:
            continue
        T_meas = res.T_meas
        # Perceptual-aliasing gate: reject geometrically verified
        # candidates whose implied drift exceeds the odometry budget
        # (implied_drift_rate); in a self-similar corridor false loops
        # between co-linear poses verify, and their spans would block the
        # true revisit.
        rate = implied_drift_rate(traj, i, j, T_meas)
        if rate > lcfg.max_drift_rate:
            if mlog is not None:
                mlog.log({"stage": "loop_reject_aliasing", "i": i, "j": j,
                          "inliers": res.n_inliers,
                          "implied_drift_rate": round(rate, 3)})
            continue
        # Sim(3): measure the accumulated scale drift when the loop has
        # baseline (reverse-direction shared structure); zero-baseline
        # revisits spread SE(3) only. sigma == 1.0 is the SE(3) spread.
        sigma = 1.0
        if lcfg.sim3 and not res.zero_baseline:
            t_next_j = np.linalg.inv(traj[j]) @ traj[j + 1]
            t0 = time.perf_counter()
            s = measure_scale_drift(
                keyframes[j], keyframes[i], keyframes[j + 1],
                float(np.linalg.norm(t_next_j[:3, 3])),
                float(np.linalg.norm(T_meas[:3, 3])),
                vo_cfg_half, gen, device=dev)
            stats["scale_checks"] += 1
            stats["verify_s"] += time.perf_counter() - t0
            if s is not None:
                sigma = s
        if not lcfg.pose_graph:
            traj = spread_drift(traj, i, j, T_meas, sigma=sigma)
        applied.append(Loop(i, j, T_meas, res.n_inliers, score, sigma))
        closed_spans.append((i, j))
        if mlog is not None:
            mlog.log({"stage": "loop_close", "i": i, "j": j,
                      "inliers": res.n_inliers, "score": score,
                      "sigma": round(float(sigma), 4),
                      "zero_baseline": bool(res.zero_baseline)})
    stats["loops_applied"] = len(applied)
    if lcfg.pose_graph and applied:
        if len(applied) >= 2:
            # Joint Sim(3) reconciliation of all loops, accepted only if
            # it passes the no-GT self-consistency gate (length-change
            # budget, loop gaps shrinking); on odometry broken beyond
            # smooth drift the solve can exploit the scale DOF instead,
            # and the greedy per-span spread is the safer correction.
            from epivo_tpu_torch.pipeline import posegraph

            t0 = time.perf_counter()
            cand = np.asarray(
                posegraph.optimize_pose_graph(traj, applied,
                                              stride=stride), np.float64)
            ok, pg_stats = posegraph.self_consistency(
                traj, cand, applied, lcfg.pose_graph_max_scale)
            stats["pose_graph_s"] = time.perf_counter() - t0
            stats["pose_graph"] = bool(ok)
            if mlog is not None:
                mlog.log({"stage": "loop_pose_graph",
                          "n_loops": len(applied), "accepted": bool(ok),
                          **pg_stats})
            if ok:
                traj = cand
            else:
                # Greedy fallback over the collected loops (strongest
                # first, one per non-overlapping span).
                spans: list[tuple[int, int]] = []
                for lp in sorted(applied, key=lambda l: -l.n_inliers):
                    if any(not (lp.j < a or lp.i > b) for (a, b) in spans):
                        continue
                    traj = spread_drift(traj, lp.i, lp.j, lp.T_meas,
                                        sigma=lp.sigma)
                    spans.append((lp.i, lp.j))
        else:
            lp = applied[0]
            traj = spread_drift(traj, lp.i, lp.j, lp.T_meas,
                                sigma=lp.sigma)
    return traj.astype(np.float32), applied
