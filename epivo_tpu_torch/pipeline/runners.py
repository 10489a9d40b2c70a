"""Monocular sequence runners (port of the monocular part of
``epivo_tpu/pipeline/runners.py``).

``run_vo_sequence`` chains two-view VO over consecutive pairs (GT scale
injection, trajectory accumulation, cloud); ``run_ba_sequence`` extracts
the pairs every window needs, recovers the no-GT relative scales through
the scale graph, solves all windows in one batched LM call and stitches
the trajectory.

Host/device split: frame decode and GT stay on the host; frames go to the
device in batches, and each batch of pairs is one batched step
(``vo.vo_step_batched`` or ``vo.vo_step_orb_batched``), whose results come
back as one packed device-to-host copy. Dispatch runs ``pipeline_depth``
batches ahead of the fetch (:class:`stream.PipelinedDispatch`).

Each runner works on ``device`` (default: the CUDA card; it raises when
there is none, see :func:`_device.runner_device`) and draws its RANSAC
samples from one ``torch.Generator`` seeded from ``seed``. Not ported
yet, and refused with ``NotImplementedError`` rather than dropped: the
multi-device ``mesh`` (ROADMAP A14), the global-BA polish
(``config.global_ba.enabled``, A14) and loop closure
(``config.loop.enabled``, A13).
"""

from __future__ import annotations

import time
from typing import Iterable, NamedTuple

import numpy as np
import torch

from epivo_tpu_torch._device import constant, runner_device
from epivo_tpu_torch.eval import metrics
from epivo_tpu_torch.geometry import camera as cam, epipolar, se3
from epivo_tpu_torch.pipeline import ba as ba_mod, scale as scale_mod, stream, vo
from epivo_tpu_torch.pipeline.config import (BAConfig, ScaleConfig, VOConfig,
                                             underfill_floor)
from epivo_tpu_torch.utils import checkpoint as ckpt_mod, profiling


class SequenceResult(NamedTuple):
    trajectory: np.ndarray  # [F, 4, 4] estimated camera-to-world
    gt_trajectory: np.ndarray | None  # [F, 4, 4] or None
    ate: float | None
    rpe_t: float | None
    cloud: np.ndarray  # [N, 3] triangulated world points
    cloud_limits: np.ndarray  # [F-1] cumulative counts per frame (lims file)
    per_frame: dict  # diagnostics arrays
    loops: tuple = ()  # applied loop edges (loop closure is not ported)
    stats: dict | None = None  # counts and host wall seconds per stage
    pair_data: dict | None = None  # run_ba_sequence: the extracted pairs


def _refuse(mesh, config: BAConfig | None = None) -> None:
    """Raise on the options whose stages are not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the multi-device layer is not ported yet (ROADMAP A14)")
    if config is not None and config.global_ba.enabled:
        raise NotImplementedError(
            "config.global_ba.enabled: the global-BA polish is not ported "
            "yet (ROADMAP A14)")
    if config is not None and config.loop.enabled:
        raise NotImplementedError(
            "config.loop.enabled: loop closure is not ported yet (ROADMAP A13)")


def _upload(frames: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host frame stack on ``dev``: staged through pinned memory and
    copied without blocking, so the host goes on issuing work."""
    t = torch.from_numpy(np.ascontiguousarray(frames))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _batched_vo(config: VOConfig, collect_cloud: bool = True):
    """The batch step of :func:`run_vo_sequence`: frames [B+1, H, W] on the
    device -> ``vo_step_batched`` on the B consecutive pairs, its outputs
    packed into (head [B, 20] = pose and n_tracked / n_inliers / r_norm /
    reverted, cloud [B, K, 4] = points and validity, or None)."""

    def run(frames: torch.Tensor, generator: torch.Generator):
        frames = frames.to(torch.float32)
        res = vo.vo_step_batched(frames[:-1], frames[1:], generator, config)
        B = res.T.shape[0]
        head = torch.cat([
            res.T.reshape(B, 16),
            torch.stack([res.n_tracked.to(torch.float32),
                         res.n_inliers.to(torch.float32), res.r_norm,
                         res.reverted.to(torch.float32)], dim=-1),
        ], dim=-1)
        cloud = None
        if collect_cloud:
            cloud = torch.cat([res.points, res.points_valid[..., None].to(
                res.points.dtype)], dim=-1)
        return head, cloud

    return run


def run_vo_sequence(
    frames: Iterable[np.ndarray],
    config: VOConfig,
    gt_poses: np.ndarray | None = None,
    batch: int = 8,
    seed: int = 0,
    collect_cloud: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 64,
    metrics_path: str | None = None,
    pipeline_depth: int = 2,
    mesh=None,
    device=None,
) -> SequenceResult:
    """Two-view VO over a frame stream (ref `kitti_E.cpp:54-255`).

    ``gt_poses`` supplies the per-step scale as the reference does
    (`kitti_E.cpp:218-223`); without GT, steps keep unit translation norm.
    With ``checkpoint_dir``, per-step relative poses (and the cloud)
    snapshot every ``checkpoint_every`` frames and a restarted run resumes
    at the last snapshot (callers pass the same stream again; the
    generator restarts from ``seed + resumed frames``).

    Each batch's poses and scalars come back in one device-to-host copy;
    the cloud buffers are fetched at checkpoint boundaries and at the end.
    """
    _refuse(mesh)
    dev = runner_device(device)
    step_fn = _batched_vo(config, collect_cloud=collect_cloud)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mlog = profiling.MetricsLogger(metrics_path)

    ckpt = (ckpt_mod.SequenceCheckpointer(checkpoint_dir, every=checkpoint_every)
            if checkpoint_dir else None)
    resume_from = 0
    dTs, n_inl, n_trk, reverted = [], [], [], []
    clouds, limits = [], []
    total_pts = 0
    fidx = 0
    if ckpt is not None:
        restored = ckpt.restore()
        if restored is not None:
            resume_from, state = restored
            dTs = list(state["dTs"])
            n_inl = list(state["n_inliers"])
            n_trk = list(state["n_tracked"])
            reverted = list(state["reverted"])
            if collect_cloud and "cloud_counts" in state:
                counts = state["cloud_counts"].astype(np.int64)
                if counts.size:
                    clouds = list(np.split(state["cloud_concat"],
                                           np.cumsum(counts)[:-1]))
                    limits = list(np.concatenate([[0], np.cumsum(counts)[:-1]]))
                    total_pts = int(counts.sum())
            gen = torch.Generator(device=dev).manual_seed(seed + resume_from)
            fidx = resume_from

    frames = iter(frames)
    try:
        first = next(frames)
        for _ in range(resume_from):  # skip already-processed frames
            first = next(frames)
    except StopIteration:
        raise ValueError("empty (or shorter-than-checkpoint) frame stream")

    buf = [np.asarray(first, np.float32)]
    cloud_pending: list = []

    def _drain_cloud():
        nonlocal total_pts
        for cloud_dev, B in cloud_pending:
            c = cloud_dev.cpu().numpy()[:B]
            for b in range(B):
                val = c[b, :, 3] > 0.5
                clouds.append(c[b, val, :3])
                limits.append(total_pts)
                total_pts += int(val.sum())
        cloud_pending.clear()

    def on_ready(res, B):
        nonlocal fidx
        head, cloud = res
        if collect_cloud:
            cloud_pending.append((cloud, B))
        h = head.cpu().numpy()[:B]
        T = h[:, :16].reshape(B, 4, 4)
        scal = h[:, 16:]  # [B, 4] tracked/inliers/r_norm/reverted
        dTs.extend(T)
        n_trk.extend(scal[:, 0].astype(np.int32))
        n_inl.extend(scal[:, 1].astype(np.int32))
        reverted.extend(scal[:, 3] > 0.5)
        fidx += B
        mlog.log({
            "frame": fidx,
            "n_inliers_mean": float(scal[:, 1].mean()),
            "n_tracked_mean": float(scal[:, 0].mean()),
            "reverted": int((scal[:, 3] > 0.5).sum()),
            "r_norm_max": float(scal[:, 2].max()),
        })
        if ckpt is not None and ckpt.due(fidx):
            _drain_cloud()  # checkpointed cloud state must be complete
            state = {
                "dTs": np.stack(dTs),
                "n_inliers": np.asarray(n_inl),
                "n_tracked": np.asarray(n_trk),
                "reverted": np.asarray(reverted),
            }
            if collect_cloud:
                state["cloud_concat"] = (
                    np.concatenate(clouds) if clouds else np.zeros((0, 3), np.float32))
                state["cloud_counts"] = np.asarray([len(c) for c in clouds], np.int64)
            ckpt.maybe_save(fidx, state)

    pipe = stream.PipelinedDispatch(on_ready, depth=pipeline_depth)

    def flush(buf):
        B = len(buf) - 1
        if B < 1:
            return
        stack = _upload(np.stack(buf), dev)
        pipe.submit(lambda d=stack: step_fn(d, gen), B)

    for f in frames:
        buf.append(np.asarray(f, np.float32))
        if len(buf) == batch + 1:
            flush(buf)
            buf = [buf[-1]]
    flush(buf)
    pipe.flush()
    _drain_cloud()

    dTs = np.stack(dTs).astype(np.float32) if dTs else np.zeros((0, 4, 4), np.float32)
    F = dTs.shape[0]

    # Scale injection + accumulation (host: tiny 4x4 chains in float32).
    if gt_poses is not None:
        rel = np.linalg.inv(gt_poses[:F]) @ gt_poses[1 : F + 1]
        scales = np.linalg.norm(rel[:, :3, 3], axis=-1)
    else:
        scales = np.ones(F)
    if F:
        dTs_scaled = vo.apply_scale(torch.from_numpy(dTs),
                                    torch.from_numpy(scales.astype(np.float32)))
        traj = vo.accumulate_trajectory(dTs_scaled).numpy()
    else:
        traj = np.eye(4)[None]

    # World-frame cloud: points are in each source camera frame.
    world_cloud = [pts @ traj[i][:3, :3].T + traj[i][:3, 3]
                   for i, pts in enumerate(clouds)]
    cloud = np.concatenate(world_cloud) if world_cloud else np.zeros((0, 3))

    ate = rpe_t = None
    gt_traj = None
    if gt_poses is not None and F:
        gt_traj = gt_poses[: F + 1]
        gt_traj = np.linalg.inv(gt_traj[0])[None] @ gt_traj  # start at identity
        ate = metrics.ate_rmse(traj, gt_traj, align=True, with_scale=False)
        rpe_t, _ = metrics.rpe(traj, gt_traj)

    mlog.close()
    return SequenceResult(
        trajectory=traj,
        gt_trajectory=gt_traj,
        ate=ate,
        rpe_t=rpe_t,
        cloud=cloud,
        cloud_limits=np.asarray(limits, np.int64),
        per_frame={
            "n_inliers": np.asarray(n_inl),
            "n_tracked": np.asarray(n_trk),
            "reverted": np.asarray(reverted),
            "scales": scales,
        },
    )


def _extract_step(vo_cfg: VOConfig, use_orb: bool):
    """The batch step of :func:`_extract_pairs`: (src, tgt [B, H, W] on the
    device, generator, optional samples [B, n_hyp, 8]) -> one packed
    [B, 16 + 8K + 2] tensor: pose, normalized source and target points,
    the LM-ready and the epipolar-inlier masks, n_inliers and reverted."""
    step_fn = vo.vo_step_orb_batched if use_orb else vo.vo_step_batched

    def run(src, tgt, generator, samples=None):
        res = step_fn(src.to(torch.float32), tgt.to(torch.float32), generator,
                      vo_cfg, ransac_samples=samples)
        K_inv = vo_cfg.camera.K_inv(torch.float32, src.device)
        p0 = cam.normalize(res.matches_src, K_inv)
        p1 = cam.normalize(res.matches_tgt, K_inv)
        B = p0.shape[0]
        f32 = lambda x: x.to(torch.float32).reshape(B, -1)
        return torch.cat([f32(res.T), f32(p0), f32(p1), f32(res.points_valid),
                          f32(res.inlier_mask), f32(res.n_inliers),
                          f32(res.reverted)], dim=-1)

    return run


def _unpack_step(h: np.ndarray):
    """Host side of :func:`_extract_step`'s packing: (T, p0, p1, sel, inl,
    scal [B, 2] = n_inliers, reverted)."""
    B = h.shape[0]
    K = (h.shape[1] - 18) // 8
    o = 16
    p0 = h[:, o : o + 3 * K].reshape(B, K, 3)
    p1 = h[:, o + 3 * K : o + 6 * K].reshape(B, K, 3)
    sel = h[:, o + 6 * K : o + 7 * K] > 0.5
    inl = h[:, o + 7 * K : o + 8 * K] > 0.5
    return h[:, :16].reshape(B, 4, 4), p0, p1, sel, inl, h[:, -2:]


_PAIR_FIELDS = ("p", "p_t", "mask", "T", "p_full", "p_t_full", "mask_full")


def _pack_pairs(pair_data: dict) -> dict:
    keys = sorted(pair_data)
    state = {"pair_keys": np.asarray(keys, np.int64)}
    for f in _PAIR_FIELDS:
        state["pair_" + f] = np.stack([pair_data[k][f] for k in keys])
    return state


def _unpack_pairs(state: dict) -> dict:
    if "pair_keys" not in state:
        return {}
    keys = [tuple(int(v) for v in row) for row in state["pair_keys"]]
    return {
        k: {f: state["pair_" + f][i] for f in _PAIR_FIELDS}
        for i, k in enumerate(keys)
    }


def _extract_pairs(frames, pairs, vo_cfg: VOConfig, seed: int,
                   n_points: int, batch: int = 8, ckpt=None,
                   use_orb: bool = False, mlog=None,
                   pipeline_depth: int = 2, mesh=None, device=None,
                   ransac_samples: dict | None = None,
                   orb_samples: dict | None = None,
                   stats: dict | None = None) -> dict:
    """Two-view match extraction for arbitrary (i, j) frame pairs, one
    batched step per ``batch`` pairs (the reference's `_initializer`,
    `kitti_ba.cpp:280-349`).

    ``frames`` may be a :class:`stream.FrameStream`: pairs are processed
    in the given order and frames are evicted as soon as no remaining pair
    needs them. Each batch uploads its distinct frames once. With ``ckpt``,
    partial extractions snapshot periodically and a restarted run skips
    the pairs already extracted.

    ORB retry (the reference's `really_robust_ass` as a fallback,
    `kitti_ba.cpp:584-754`): with KLT association, a pair whose step
    reverted or kept fewer RANSAC inliers than ``orb_fallback_frac`` of
    the keypoint budget keeps its frames as uint8 (at most
    ``orb_fallback_max`` pairs); after the KLT pass those pairs are
    re-associated by ORB descriptor matching, and the ORB result replaces
    the KLT one when it did not revert and has more inliers.

    ``ransac_samples`` / ``orb_samples`` ({(i, j): LongTensor [n_hyp, 8]})
    replace the generator's draws of the KLT and the ORB pass, for parity
    runs. ``stats`` (a dict) receives the pair, retry and replace counts
    and the passes' host wall seconds.

    Returns {(i, j): {p, p_t, mask (top-n_points score-ranked), T,
    p_full, p_t_full, mask_full, n_inl, rev}} with points in normalized
    coordinates.
    """
    if not pairs:
        return {}
    _refuse(mesh)
    dev = runner_device(device)
    t0 = time.perf_counter()
    fs = frames if isinstance(frames, stream.FrameStream) \
        else stream.FrameStream(frames)
    out = {}
    if ckpt is not None:
        restored = ckpt.restore()
        if restored is not None:
            out = _unpack_pairs(restored[1])
    todo = [pr for pr in pairs if pr not in out]
    if stats is not None:
        stats.update(n_pairs=len(todo), n_retried=0, n_replaced=0,
                     extract_s=0.0, orb_retry_s=0.0)
    if not todo:
        return out
    # Smallest frame index any not-yet-dispatched pair needs (suffix min):
    # the eviction watermark after dispatching todo[:k] is sufmin[k].
    sufmin = np.empty(len(todo) + 1, np.int64)
    sufmin[-1] = np.iinfo(np.int64).max
    for q in range(len(todo) - 1, -1, -1):
        sufmin[q] = min(sufmin[q + 1], todo[q][0], todo[q][1])
    fs.evict_below(int(sufmin[0]))  # resume: skip already-covered frames

    step = _extract_step(vo_cfg, use_orb)
    gen = torch.Generator(device=dev).manual_seed(seed + len(out))

    fb_frac = vo_cfg.frontend.orb_fallback_frac if not use_orb else 0.0
    fb_floor = fb_frac * vo_cfg.frontend.max_keypoints
    pend_frames: dict = {}
    retry_frames: dict = {}

    def samples_of(table, chunk):
        if table is None:
            return None
        return torch.stack([table[pr] for pr in chunk]).to(dev)

    def entry(T, p0, p1, sel, inl, scal_row):
        take = np.argsort(~sel)[:n_points]
        return dict(
            p=p0[take], p_t=p1[take], mask=sel[take],
            T=T, p_full=p0, p_t_full=p1,
            # Depth-ratio consumers want the parallax-ungated inliers.
            mask_full=inl,
            n_inl=int(scal_row[0]), rev=bool(scal_row[1] > 0.5),
        )

    def on_ready(res, chunk):
        T, p0_all, p1_all, sel_all, inl_all, scal = _unpack_step(res.cpu().numpy())
        for b, (i, j) in enumerate(chunk):
            out[(i, j)] = e = entry(T[b], p0_all[b], p1_all[b], sel_all[b],
                                    inl_all[b], scal[b])
            fr = pend_frames.pop((i, j), None)
            if (fb_frac > 0 and fr is not None
                    and (e["rev"] or e["n_inl"] < fb_floor)
                    and len(retry_frames) < vo_cfg.frontend.orb_fallback_max):
                retry_frames[(i, j)] = tuple(
                    np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in fr)
        if mlog is not None:
            mlog.log({
                "stage": "extract", "pairs_done": len(out),
                "n_inliers_mean": float(scal[:, 0].mean()),
                "reverted": int((scal[:, 1] > 0.5).sum()),
            })
        if ckpt is not None:
            ckpt.maybe_save(len(out), _pack_pairs(out))

    pipe = stream.PipelinedDispatch(on_ready, depth=pipeline_depth)
    for c0 in range(0, len(todo), batch):
        chunk = todo[c0 : c0 + batch]
        if fb_frac > 0:
            for (i, j) in chunk:
                pend_frames[(i, j)] = (fs.get(i), fs.get(j))
        ids = sorted({f for pr in chunk for f in pr})
        pos = {f: k for k, f in enumerate(ids)}
        stack = _upload(np.stack([fs.get(f) for f in ids]), dev)
        src = stack.index_select(0, constant([pos[i] for i, _ in chunk], torch.int64, dev))
        tgt = stack.index_select(0, constant([pos[j] for _, j in chunk], torch.int64, dev))
        smp = samples_of(ransac_samples, chunk)
        pipe.submit(lambda s=src, t=tgt, m=smp: step(s, t, gen, m), chunk)
        # Keep only what the remaining pairs still need (sufmin is +inf
        # after the last batch, which evicts everything).
        fs.evict_below(int(min(sufmin[min(c0 + batch, len(todo))], 2**62)))
    pipe.flush()
    t1 = time.perf_counter()

    n_swap = 0
    if retry_frames:
        orb_step = _extract_step(vo_cfg, True)

        def on_retry(res, chunk):
            nonlocal n_swap
            T, p0_all, p1_all, sel_all, inl_all, scal = _unpack_step(res.cpu().numpy())
            for b, (i, j) in enumerate(chunk):
                e = entry(T[b], p0_all[b], p1_all[b], sel_all[b], inl_all[b], scal[b])
                if not e["rev"] and e["n_inl"] > out[(i, j)]["n_inl"]:
                    out[(i, j)] = e
                    n_swap += 1

        pipe2 = stream.PipelinedDispatch(on_retry, depth=pipeline_depth)
        rpairs = sorted(retry_frames)
        for c0 in range(0, len(rpairs), batch):
            chunk = rpairs[c0 : c0 + batch]
            src = _upload(np.stack([retry_frames[pr][0] for pr in chunk]), dev)
            tgt = _upload(np.stack([retry_frames[pr][1] for pr in chunk]), dev)
            smp = samples_of(orb_samples, chunk)
            pipe2.submit(lambda s=src, t=tgt, m=smp: orb_step(s, t, gen, m), chunk)
        pipe2.flush()
        if mlog is not None:
            mlog.log({"stage": "extract_orb_fallback",
                      "n_retried": len(rpairs), "n_replaced": n_swap})
        if ckpt is not None:
            ckpt.maybe_save(len(out), _pack_pairs(out))
    if stats is not None:
        stats.update(n_retried=len(retry_frames), n_replaced=n_swap,
                     extract_s=t1 - t0, orb_retry_s=time.perf_counter() - t1)
    return out


def _chained_scales(pair_data: dict, n_zeta_total: int,
                    sc: ScaleConfig = ScaleConfig(), device=None) -> np.ndarray:
    """No-GT relative-scale chain ``c_scale`` via depth-ratio boundaries.

    The sequential ``ba.boundary_scale_ratio`` recursion (c_scale[b] = the
    depth ratio at boundary b in window-w units), with every boundary's
    epipolar depths in one batched call on ``device``; the sequential part
    (range gates see scaled depths, a failed boundary carries the previous
    scale forward, the parallax gate, the catastrophic-boundary Hampel gate
    and the optional smoothing of log-ratios) is numpy, as in the
    reference. The scale graph (:func:`scale.scale_graph_solve`) replaces
    this chain by default; it remains the fallback when the graph has no
    measurements.
    """
    rows, idxs = [], []
    for b in range(1, n_zeta_total):
        back = pair_data.get((b, b - 1))
        fwd = pair_data.get((b, b + 1))
        prev = pair_data.get((b - 1, b))
        if back is None or fwd is None or prev is None:
            continue
        rows.append((prev["T"], fwd["T"],
                     back["p_full"], back["p_t_full"], back["mask_full"],
                     fwd["p_full"], fwd["p_t_full"], fwd["mask_full"]))
        idxs.append(b)
    c = np.ones(n_zeta_total, np.float32)
    if not rows:
        return c

    dev = runner_device(device)
    st = lambda q: torch.from_numpy(
        np.stack([np.asarray(r[q], np.float32) for r in rows])).to(dev)
    Tb, Tn = se3.inverse(st(0)), st(1)
    d_b, v_b = epipolar.epipolar_depth(Tb[:, :3, :3], Tb[:, :3, 3], st(2), st(3))
    d_f, v_f = epipolar.epipolar_depth(Tn[:, :3, :3], Tn[:, :3, 3], st(5), st(6))
    got = torch.stack([d_b, v_b.to(d_b.dtype), d_f, v_f.to(d_f.dtype)]).cpu().numpy()
    db, vb, df, vf = got[0], got[1] > 0.5, got[2], got[3] > 0.5
    mb = np.stack([r[4] for r in rows])
    mf = np.stack([r[7] for r in rows])
    # Per-point flow magnitudes in normalized coords (parallax proxy;
    # quantile gating is unit-invariant) for the flow gate.
    flow_min = np.minimum(
        np.linalg.norm(np.stack([r[3] - r[2] for r in rows])[..., :2], axis=-1),
        np.linalg.norm(np.stack([r[6] - r[5] for r in rows])[..., :2], axis=-1))
    row_of = {b: i for i, b in enumerate(idxs)}
    for b in range(1, n_zeta_total):
        i = row_of.get(b)
        if i is None:
            c[b] = c[b - 1]
            continue
        dbs = db[i] * c[b - 1]  # depths in window-w units (linear in |t|)
        both = (vb[i] & vf[i] & mb[i] & mf[i]
                & (dbs > sc.depth_min) & (dbs < sc.depth_max)
                & (df[i] > sc.depth_min) & (df[i] < sc.depth_max))
        # Parallax gate: small-baseline pose error is common-mode across
        # points, so keep only the largest-flow fraction when enough remain.
        if sc.chain_flow_topfrac > 0 and both.sum() >= 2 * sc.min_common:
            thr = np.quantile(flow_min[i][both], 1 - sc.chain_flow_topfrac)
            gated = both & (flow_min[i] >= thr)
            if gated.sum() >= sc.min_common:
                both = gated
        if both.sum() < sc.min_common:
            c[b] = c[b - 1]
            continue
        c[b] = np.median(dbs[both] / df[i][both])

    # Catastrophic-boundary gate: replace gross outlier ratios by the
    # local median (a wrong boundary would otherwise scale every step
    # after it).
    if sc.chain_hampel_ratio > 0 and n_zeta_total > 2:
        ratios = c[1:] / np.maximum(c[:-1], 1e-12)
        ratios_f, _rep = scale_mod.hampel_log(
            ratios, window=sc.chain_hampel_window,
            max_ratio=sc.chain_hampel_ratio,
            mad_k=sc.chain_hampel_mad_k or None)
        c = np.concatenate([c[:1], c[0] * np.cumprod(ratios_f)]).astype(np.float32)

    # Optional running median over the per-boundary log-ratios.
    k = int(sc.chain_smooth)
    if k > 1 and n_zeta_total > 2:
        r = np.diff(np.log(np.maximum(c, 1e-12)))
        h = k // 2
        pad = np.concatenate([r[:1].repeat(h), r, r[-1:].repeat(h)])
        r_f = np.array([np.median(pad[j : j + k]) for j in range(len(r))])
        c = np.concatenate([[c[0]], c[0] * np.exp(np.cumsum(r_f))])
        c = c.astype(np.float32)
    return c


def _solve_windows(T0s, spec, p, p_t, wreps, pmask, config: BAConfig,
                   mesh=None, device=None) -> ba_mod.BAWindowsResult:
    """All windows in one :func:`ba.ba_windows` call on ``device``; the
    result comes back as numpy arrays in one device-to-host copy."""
    _refuse(mesh)
    dev = runner_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = ba_mod.ba_windows(up(T0s), spec, up(p), up(p_t), wreps=up(wreps),
                            pmask=up(pmask), config=config)
    W = T0s.shape[0]
    h = torch.cat([out.T_opt.reshape(W, -1), out.r_norm[:, None],
                   out.reverted.to(out.r_norm.dtype)[:, None],
                   out.n_accepted.to(out.r_norm.dtype)[:, None]], dim=-1).cpu().numpy()
    return ba_mod.BAWindowsResult(
        T_opt=h[:, :-3].reshape(T0s.shape), r_norm=h[:, -3],
        reverted=h[:, -2] > 0.5, n_accepted=h[:, -1].astype(np.int32))


def _log_windows(mlog, anchors, out) -> None:
    """Per-window LM health stream (ref printed this, `kitti_ba.cpp:884-894`)."""
    for w, a in enumerate(anchors):
        mlog.log({"stage": "ba_window", "window": w, "anchor": int(a),
                  "r_norm": float(out.r_norm[w]), "reverted": bool(out.reverted[w]),
                  "n_accepted": int(out.n_accepted[w])})


class MonoWindows(NamedTuple):
    """Assembled mono-BA window tensors (stage 1 output; input to the
    batched LM solve)."""

    F: int
    anchors: list
    spec: ba_mod.WindowSpec
    T0s: np.ndarray  # [W, Z, 4, 4]
    p: np.ndarray  # [W, R, N, 3]
    p_t: np.ndarray  # [W, R, N, 3]
    wreps: np.ndarray  # [W, R]
    pmask: np.ndarray  # [W, R, N]
    c_scale: np.ndarray  # [F-1] no-GT relative scales (ones with GT)
    pair_data: dict


def prepare_mono_windows(
    frames: Iterable[np.ndarray],
    config: BAConfig,
    gt_poses: np.ndarray | None = None,
    seed: int = 0,
    ckpt=None,
    use_orb: bool = False,
    n_frames: int | None = None,
    mlog=None,
    batch: int = 8,
    pipeline_depth: int = 2,
    mesh=None,
    device=None,
    stats: dict | None = None,
) -> MonoWindows:
    """Stage 1 of windowed mono BA: streamed pair extraction, the no-GT
    scale graph and window tensor assembly (the reference's matcher thread
    + window packing, `kitti_ba.cpp:352-581,757-870`). See
    :func:`run_ba_sequence`; ``stats`` (a dict) receives the extraction
    counts and the scale graph's measurements and host wall seconds."""
    _refuse(mesh)
    fs = stream.FrameStream(frames, n_frames)
    if not fs.sized:
        fs.materialize()
    F = len(fs)
    ws = config.window_size
    spec = ba_mod.mono_window_spec(ws)
    stride = config.stride
    anchors = list(range(0, F - ws + 1, stride))
    if not anchors:
        raise ValueError(f"need at least {ws} frames, got {F}")

    vo_cfg = VOConfig(camera=config.camera, frontend=config.frontend,
                      ransac=config.ransac, lm=config.lm)
    # Match extraction for every (global) pair needed by any window.
    need = {(a + int(p0), a + int(p1)) for a in anchors
            for p0, p1 in spec.frame_pairs if a + int(p1) < F}
    if gt_poses is None:
        # No-GT scale recovery needs BACKWARD pairs at every interior frame
        # b (keypoints of b tracked to b-1: the same landmarks as the
        # forward pair (b, b+1) under the previous zeta's pose).
        last = anchors[-1] + ws - 1
        need |= {(b, b - 1) for b in range(1, min(F - 1, last))}
        if config.scale.graph:
            # Scale graph: skip pairs at every frame and backward-skip
            # pairs give the skip_boundary measurements that bridge single
            # corrupted boundaries.
            need |= {(a, a + 2) for a in range(F - 2)}
            need |= {(b, b - 2) for b in range(2, F)}
    pairs = sorted(need)
    stats = {} if stats is None else stats
    pair_data = _extract_pairs(fs, pairs, vo_cfg, seed,
                               n_points=config.lm.n_points, ckpt=ckpt,
                               use_orb=use_orb, mlog=mlog, batch=batch,
                               pipeline_depth=pipeline_depth, device=device,
                               stats=stats)
    N = config.lm.n_points

    # Pre-LM relative-scale chain (no-GT only): two-view poses are
    # unit-norm, so the zeta inits carry no relative scale.
    t0 = time.perf_counter()
    n_zeta_total = F - 1
    c_scale = np.ones(n_zeta_total, np.float32)
    n_meas = 0
    if gt_poses is None:
        if config.scale.graph:
            meas = scale_mod.scale_graph_measurements(
                pair_data, n_zeta_total, config.scale, device=device)
            n_meas = len(meas)
            if meas:
                c_scale = scale_mod.scale_graph_solve(meas, n_zeta_total, config.scale)
                if mlog is not None:
                    mlog.log({"stage": "scale_graph", "n_measurements": len(meas),
                              "n_boundaries": n_zeta_total - 1})
            else:
                c_scale = _chained_scales(pair_data, n_zeta_total, config.scale,
                                          device=device)
        else:
            c_scale = _chained_scales(pair_data, n_zeta_total, config.scale,
                                      device=device)
    stats.update(scale_graph_s=time.perf_counter() - t0, n_measurements=n_meas)

    # Assemble window tensors.
    W = len(anchors)
    R_ = spec.reps.shape[0]
    p = np.zeros((W, R_, N, 3), np.float32)
    p_t = np.zeros((W, R_, N, 3), np.float32)
    pmask = np.zeros((W, R_, N), bool)
    wreps = np.ones((W, R_), np.float32)
    T0s = np.tile(np.eye(4, dtype=np.float32), (W, spec.n_zeta, 1, 1))
    for w, a in enumerate(anchors):
        for r, (f0, f1) in enumerate(spec.frame_pairs):
            gi, gj = a + int(f0), a + int(f1)
            if (gi, gj) not in pair_data:
                wreps[w, r] = 0.0  # underfilled constraint: zero weight
                continue
            d = pair_data[(gi, gj)]
            p[w, r] = d["p"]
            p_t[w, r] = d["p_t"]
            pmask[w, r] = d["mask"]
            # Zero-weight underfilled constraints (ref kitti_ba.cpp:821-826).
            if d["mask"].sum() < underfill_floor(N):
                wreps[w, r] = 0.0
        for z in range(spec.n_zeta):
            gi, gj = a + z, a + z + 1
            if (gi, gj) in pair_data:
                T0s[w, z] = pair_data[(gi, gj)]["T"].copy()
                T0s[w, z, :3, 3] *= c_scale[gi]
    return MonoWindows(F=F, anchors=anchors, spec=spec, T0s=T0s, p=p,
                       p_t=p_t, wreps=wreps, pmask=pmask, c_scale=c_scale,
                       pair_data=pair_data)


def run_ba_sequence(
    frames: Iterable[np.ndarray],
    config: BAConfig,
    gt_poses: np.ndarray | None = None,
    seed: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 64,
    use_orb: bool = False,
    n_frames: int | None = None,
    metrics_path: str | None = None,
    batch: int = 8,
    pipeline_depth: int = 2,
    mesh=None,
    device=None,
) -> SequenceResult:
    """Windowed mono BA over a frame sequence (ref `kitti_ba` mono path).

    ``use_orb`` associates every pair by ORB descriptor matching instead
    of KLT (the reference's `really_robust_ass` window orchestrator,
    `kitti_ba.cpp:584-754`).

    Stage 1 (:func:`prepare_mono_windows`): the pairs of every window
    (and, without GT, the scale graph's backward and skip pairs) are
    initialized by the two-view step. Stage 2: all windows solve in ONE
    batched LM call. With GT, each zeta's |t| comes from GT; without, LM
    contributes rotations and translation directions and the scale graph
    the magnitudes (the window energy is gauge-free in scale), with the
    global gauge left free.

    Frames stream through a bounded buffer: pass a generator plus
    ``n_frames`` (or any sized sequence); an unsized generator without
    ``n_frames`` is materialized. ``metrics_path`` streams per-batch
    extraction stats and per-window LM health as JSONL. The result's
    ``stats`` holds the pair, retry, replace, measurement and window
    counts and the host wall seconds of each stage, its ``pair_data`` the
    extracted pairs (see :func:`_extract_pairs`).
    """
    _refuse(mesh, config)
    t_start = time.perf_counter()
    mlog = profiling.MetricsLogger(metrics_path)
    ckpt = (ckpt_mod.SequenceCheckpointer(checkpoint_dir, every=checkpoint_every)
            if checkpoint_dir else None)
    stats: dict = {}
    win = prepare_mono_windows(frames, config, gt_poses=gt_poses, seed=seed,
                               ckpt=ckpt, use_orb=use_orb, n_frames=n_frames,
                               mlog=mlog, batch=batch,
                               pipeline_depth=pipeline_depth, device=device,
                               stats=stats)
    F = win.F
    t0 = time.perf_counter()
    out = _solve_windows(win.T0s, win.spec, win.p, win.p_t, win.wreps, win.pmask,
                         config, device=device)
    stats["solve_s"] = time.perf_counter() - t0
    _log_windows(mlog, win.anchors, out)
    zetas = out.T_opt.reshape(-1, 4, 4)[: F - 1]  # ba.stitch_windows

    if gt_poses is not None:
        rel = np.linalg.inv(gt_poses[: len(zetas)]) @ gt_poses[1 : len(zetas) + 1]
        scales = np.linalg.norm(rel[:, :3, 3], axis=-1)
        zetas = ba_mod.propagate_scale(
            torch.from_numpy(zetas), torch.from_numpy(scales.astype(np.float32))).numpy()
    else:
        # No-GT monocular scale: the window LM energy is gauge-free in
        # scale, so |t| comes from the scale graph (``c_scale``), computed
        # with each pair's own two-view pose; LM contributes the rotations
        # and translation directions.
        zetas = zetas.copy()
        t = zetas[:, :3, 3]
        norms = np.linalg.norm(t, axis=-1, keepdims=True)
        norms = np.where(norms > 1e-12, norms, 1.0)
        zetas[:, :3, 3] = (t / norms) * win.c_scale[: zetas.shape[0], None]
    traj = ba_mod.trajectory_from_zetas(torch.from_numpy(
        np.ascontiguousarray(zetas, np.float32))).numpy()
    mlog.close()

    ate = rpe_t = None
    gt_traj = None
    if gt_poses is not None:
        gt_traj = gt_poses[: traj.shape[0]]
        gt_traj = np.linalg.inv(gt_traj[0])[None] @ gt_traj
        ate = metrics.ate_rmse(traj, gt_traj, align=True, with_scale=False)
        rpe_t, _ = metrics.rpe(traj, gt_traj)

    stats.update(n_windows=len(win.anchors), n_reverted=int(out.reverted.sum()),
                 total_s=time.perf_counter() - t_start)
    return SequenceResult(
        trajectory=traj,
        gt_trajectory=gt_traj,
        ate=ate,
        rpe_t=rpe_t,
        cloud=np.zeros((0, 3)),
        cloud_limits=np.zeros(0, np.int64),
        per_frame={
            "window_r_norm": np.asarray(out.r_norm),
            "window_reverted": np.asarray(out.reverted),
        },
        stats=stats,
        pair_data=win.pair_data,
    )
