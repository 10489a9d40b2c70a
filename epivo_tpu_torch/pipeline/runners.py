"""Sequence runners (port of ``epivo_tpu/pipeline/runners.py``).

``run_vo_sequence`` chains two-view VO over consecutive pairs (GT scale
injection, trajectory accumulation, cloud); ``run_ba_sequence`` extracts
the pairs every window needs, recovers the no-GT relative scales through
the scale graph, solves all windows in one batched LM call and stitches
the trajectory; ``run_stereo_ba_sequence`` does the same on a stereo rig
in a doubled frame index, with the metric scale of every step taken from
the calibrated baseline (no ground truth needed);
``run_gt_triangulation_sequence`` triangulates the extracted matches
against the ground-truth motion. With ``config.global_ba.enabled``
``run_ba_sequence`` polishes the windowed result with one joint LM over
the whole chain (:func:`refine_global`, :mod:`parallel.global_ba`). With
``config.loop.enabled`` both BA runners keep half-resolution keyframes
off their frame stream and close loops on the finished trajectory
(:func:`_loop_stage`, :mod:`loopclose`).

Host/device split: frame decode and GT stay on the host; frames go to the
device in batches, and each batch of pairs is one batched step
(``vo.vo_step_batched`` or ``vo.vo_step_orb_batched``), whose results come
back as one packed device-to-host copy. Dispatch runs ``pipeline_depth``
batches ahead of the fetch (:class:`stream.PipelinedDispatch`). The
stereo scale estimator's depths are one batched call and one copy; its
estimators, and the post-LM rescale, run in float64 on the host.

Each runner works on ``device`` (default: the CUDA card; it raises when
there is none, see :func:`_device.runner_device`) and draws its RANSAC
samples from one ``torch.Generator`` seeded from ``seed``.

With ``mesh`` (a ``DeviceMesh`` from :func:`parallel.mesh.make_mesh`,
built for ``device``'s type) every rank of the mesh runs the same runner
on the same frames. The pair batch of each step is split over the mesh's
``win`` axis: every rank draws the whole batch's RANSAC samples from the
same generator, steps only its own lanes and gathers the packed results
before it reads them, so the ORB retry decisions and everything after are
the same on every rank. A ``hyp`` axis above 1 splits every pair's
hypotheses (:func:`ransac.ransac_essential`). The window solve
(:func:`parallel.dist.distributed_ba_step`) and the global polish
(constraint-sharded :func:`parallel.global_ba.global_ba_solve`) split
over ``win`` too; the host stages (scale graph, stitching, the loop
stage) run replicated. Only global rank 0 writes checkpoints and metrics.
At a world size of 1 a mesh run is bit-equal to the run without one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, NamedTuple

import numpy as np
import torch

from epivo_tpu_torch._device import constant, runner_device, upload as _upload
from epivo_tpu_torch.eval import metrics
from epivo_tpu_torch.geometry import camera as cam, epipolar, se3
from epivo_tpu_torch import ransac as ransac_mod
from epivo_tpu_torch.parallel import dist as dist_mod, global_ba as gba, mesh as mesh_mod
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
    loops: tuple = ()  # applied loop edges (loopclose.Loop), loop closure on
    stats: dict | None = None  # counts and host wall seconds per stage
    pair_data: dict | None = None  # run_ba_sequence: the extracted pairs


def _mesh_device(mesh, device) -> torch.device:
    """The runner's device (:func:`runner_device`), with ``mesh`` checked
    against it."""
    dev = runner_device(device)
    if mesh is not None:
        mesh_mod.check_mesh(mesh, dev)
    return dev


def _writes(mesh) -> bool:
    """Whether this process writes the run's files (checkpoints, metrics):
    always without a mesh, only on global rank 0 with one."""
    return mesh is None or torch.distributed.get_rank() == 0


def _mesh_batch(batch: int, mesh) -> int:
    """``batch`` rounded up to a multiple of the mesh's ``win`` axis."""
    n = mesh_mod.axis_size(mesh, "win")
    return -(-batch // n) * n


def _hyp_mesh(mesh):
    """The mesh when its ``hyp`` axis splits hypotheses, else None."""
    return mesh if mesh_mod.axis_size(mesh, "hyp") > 1 else None


def _lanes(n: int, mesh) -> list:
    """The lanes of an n-lane batch this rank steps: its block of
    ceil(n / win) lanes along the mesh's ``win`` axis, lanes past the end
    repeating the last one (their results are dropped); all n without a
    mesh."""
    size, r = mesh_mod.axis_size(mesh, "win"), mesh_mod.axis_rank(mesh, "win")
    per = -(-n // size)
    return [min(q, n - 1) for q in range(r * per, (r + 1) * per)]


def _draw(generator: torch.Generator, lanes: list, n: int, mesh):
    """The RANSAC draw of a rank stepping ``lanes`` of an n-lane batch: the
    whole batch's samples, this rank's rows (:class:`ransac.BatchDraw`)."""
    return generator if mesh is None else ransac_mod.BatchDraw(generator, tuple(lanes), n)


def _gather_lanes(x: torch.Tensor | None, n: int, mesh):
    """Every rank's lanes of a batch in batch order: the n real lanes."""
    if x is None or mesh is None:
        return x
    return mesh_mod.gather_rows(x, mesh, "win")[:n]


def _pair_inputs(get, pairs: list, dev):
    """(src, tgt [len(pairs), H, W]) on ``dev`` for frame pairs (i, j),
    each distinct frame ``get(i)`` uploaded once."""
    ids = sorted({f for pr in pairs for f in pr})
    pos = {f: k for k, f in enumerate(ids)}
    stack = _upload(np.stack([get(f) for f in ids]), dev)
    pick = lambda side: stack.index_select(
        0, constant([pos[pr[side]] for pr in pairs], torch.int64, dev))
    return pick(0), pick(1)


def _batched_vo(config: VOConfig, collect_cloud: bool = True, hyp_mesh=None):
    """The batch step of :func:`run_vo_sequence`: (src, tgt [B, H, W] on
    the device, generator) -> ``vo_step_batched`` on the B pairs, its
    outputs packed into (head [B, 20] = pose and n_tracked / n_inliers /
    r_norm / reverted, cloud [B, K, 4] = points and validity, or None)."""

    def run(src: torch.Tensor, tgt: torch.Tensor, generator):
        res = vo.vo_step_batched(src.to(torch.float32), tgt.to(torch.float32),
                                 generator, config, hyp_mesh=hyp_mesh)
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
    With ``mesh`` the pairs of each batch are split over its ``win`` axis
    (``batch`` rounds up to a multiple of it); see the module docstring.
    """
    dev = _mesh_device(mesh, device)
    batch = _mesh_batch(batch, mesh)
    step_fn = _batched_vo(config, collect_cloud=collect_cloud, hyp_mesh=_hyp_mesh(mesh))
    gen = torch.Generator(device=dev).manual_seed(seed)
    mlog = profiling.MetricsLogger(metrics_path if _writes(mesh) else None)

    ckpt = (ckpt_mod.SequenceCheckpointer(checkpoint_dir, every=checkpoint_every,
                                          read_only=not _writes(mesh))
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
        head, cloud = (_gather_lanes(x, B, mesh) for x in res)
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
        lanes = _lanes(B, mesh)
        src, tgt = _pair_inputs(buf.__getitem__, [(q, q + 1) for q in lanes], dev)
        pipe.submit(lambda s=src, t=tgt, g=_draw(gen, lanes, B, mesh): step_fn(s, t, g), B)

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


def _extract_step(vo_cfg: VOConfig, use_orb: bool, hyp_mesh=None):
    """The batch step of :func:`_extract_pairs`: (src, tgt [B, H, W] on the
    device, generator, optional samples [B, n_hyp, m]) -> one packed
    [B, 16 + 8K + 2] tensor: pose, normalized source and target points,
    the LM-ready and the epipolar-inlier masks, n_inliers and reverted."""
    step_fn = vo.vo_step_orb_batched if use_orb else vo.vo_step_batched

    def run(src, tgt, generator, samples=None):
        res = step_fn(src.to(torch.float32), tgt.to(torch.float32), generator,
                      vo_cfg, ransac_samples=samples, hyp_mesh=hyp_mesh)
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

    ``ransac_samples`` / ``orb_samples`` ({(i, j): LongTensor [n_hyp, m]},
    m the solver's sample size: 8, or 5 with ``solver="5pt"``) replace the
    generator's draws of the KLT and the ORB pass, for parity runs.
    ``stats`` (a dict) receives the pair, retry and replace counts, the
    retried pairs, the passes' host wall seconds, and the lanes of each
    step this rank ran in either pass (``step_lanes``, ``retry_lanes``).

    With ``mesh`` each batch (``batch`` rounded up to a multiple of the
    ``win`` axis) is split over ``win``: every rank reads the same stream,
    draws the whole batch's samples (or takes ``ransac_samples``), uploads
    and steps its own lanes, and gathers the packed results before it
    reads them; the ORB retry pass is split the same way.

    Returns {(i, j): {p, p_t, mask (top-n_points score-ranked), T,
    p_full, p_t_full, mask_full, n_inl, rev}} with points in normalized
    coordinates.
    """
    if not pairs:
        return {}
    dev = _mesh_device(mesh, device)
    batch = _mesh_batch(batch, mesh)
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
                     extract_s=0.0, orb_retry_s=0.0, step_lanes=[], retry_lanes=[])
    if not todo:
        return out
    # Smallest frame index any not-yet-dispatched pair needs (suffix min):
    # the eviction watermark after dispatching todo[:k] is sufmin[k].
    sufmin = np.empty(len(todo) + 1, np.int64)
    sufmin[-1] = np.iinfo(np.int64).max
    for q in range(len(todo) - 1, -1, -1):
        sufmin[q] = min(sufmin[q + 1], todo[q][0], todo[q][1])
    fs.evict_below(int(sufmin[0]))  # resume: skip already-covered frames

    step = _extract_step(vo_cfg, use_orb, _hyp_mesh(mesh))
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
        T, p0_all, p1_all, sel_all, inl_all, scal = _unpack_step(
            _gather_lanes(res, len(chunk), mesh).cpu().numpy())
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
        lanes = _lanes(len(chunk), mesh)
        mine = [chunk[q] for q in lanes]
        src, tgt = _pair_inputs(fs.get, mine, dev)
        smp = samples_of(ransac_samples, mine)
        if stats is not None:
            stats["step_lanes"].append(src.shape[0])
        pipe.submit(lambda s=src, t=tgt, g=_draw(gen, lanes, len(chunk), mesh), m=smp:
                    step(s, t, g, m), chunk)
        # Keep only what the remaining pairs still need (sufmin is +inf
        # after the last batch, which evicts everything).
        fs.evict_below(int(min(sufmin[min(c0 + batch, len(todo))], 2**62)))
    pipe.flush()
    t1 = time.perf_counter()

    n_swap = 0
    if retry_frames:
        orb_step = _extract_step(vo_cfg, True, _hyp_mesh(mesh))

        def on_retry(res, chunk):
            nonlocal n_swap
            T, p0_all, p1_all, sel_all, inl_all, scal = _unpack_step(
                _gather_lanes(res, len(chunk), mesh).cpu().numpy())
            for b, (i, j) in enumerate(chunk):
                e = entry(T[b], p0_all[b], p1_all[b], sel_all[b], inl_all[b], scal[b])
                if not e["rev"] and e["n_inl"] > out[(i, j)]["n_inl"]:
                    out[(i, j)] = e
                    n_swap += 1

        pipe2 = stream.PipelinedDispatch(on_retry, depth=pipeline_depth)
        rpairs = sorted(retry_frames)
        for c0 in range(0, len(rpairs), batch):
            chunk = rpairs[c0 : c0 + batch]
            lanes = _lanes(len(chunk), mesh)
            mine = [chunk[q] for q in lanes]
            src = _upload(np.stack([retry_frames[pr][0] for pr in mine]), dev)
            tgt = _upload(np.stack([retry_frames[pr][1] for pr in mine]), dev)
            smp = samples_of(orb_samples, mine)
            if stats is not None:
                stats["retry_lanes"].append(src.shape[0])
            pipe2.submit(lambda s=src, t=tgt, g=_draw(gen, lanes, len(chunk), mesh), m=smp:
                         orb_step(s, t, g, m), chunk)
        pipe2.flush()
        if mlog is not None:
            mlog.log({"stage": "extract_orb_fallback",
                      "n_retried": len(rpairs), "n_replaced": n_swap})
        if ckpt is not None:
            ckpt.maybe_save(len(out), _pack_pairs(out))
    if stats is not None:
        stats.update(n_retried=len(retry_frames), n_replaced=n_swap,
                     retried=sorted(retry_frames),
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
    result comes back as numpy arrays in one device-to-host copy. With
    ``mesh`` the windows are split over its ``win`` axis by
    :func:`parallel.dist.distributed_ba_step`, padded to a multiple of it
    by repeating the last window; the padding is dropped."""
    dev = _mesh_device(mesh, device)
    W = T0s.shape[0]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if mesh is None:
        out = ba_mod.ba_windows(up(T0s), spec, up(p), up(p_t), wreps=up(wreps),
                                pmask=up(pmask), config=config)
    else:
        n_pad = _mesh_batch(W, mesh) - W
        pad = lambda a: up(np.concatenate([a, np.repeat(a[-1:], n_pad, axis=0)]))
        out = dist_mod.distributed_ba_step(mesh, spec, config)(
            *(pad(a) for a in (T0s, p, p_t, wreps, pmask)))
        out = ba_mod.BAWindowsResult(*(f[:W] for f in (out.T_opt, out.r_norm, out.reverted,
                                                        out.n_accepted)))
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
    counts and the scale graph's measurements and host wall seconds.
    ``mesh`` splits the pair extraction (:func:`_extract_pairs`)."""
    _mesh_device(mesh, device)
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
                               pipeline_depth=pipeline_depth, mesh=mesh, device=device,
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

    T0s, p, p_t, wreps, pmask = _mono_windows(pair_data, anchors, spec, c_scale, N)
    return MonoWindows(F=F, anchors=anchors, spec=spec, T0s=T0s, p=p,
                       p_t=p_t, wreps=wreps, pmask=pmask, c_scale=c_scale,
                       pair_data=pair_data)


def _mono_windows(pair_data: dict, anchors: list, spec, c_scale: np.ndarray, N: int):
    """Window tensors of the mono runner: (T0s [W, Z, 4, 4], p, p_t
    [W, R, N, 3], wreps [W, R], pmask [W, R, N]). Zetas start at their
    pair's two-view pose with its translation scaled by ``c_scale``; a
    constraint whose pair is missing or underfilled gets weight 0."""
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
    return T0s, p, p_t, wreps, pmask


def _loop_vo_config(config: BAConfig) -> VOConfig:
    """The two-view configuration of the loop stage: half-resolution
    keyframes (the camera halved) and pyramid ORB with the loop's keypoint
    budget. A revisit at a lateral offset sees the scene at another scale,
    and single-scale descriptors die of it (the reference measured 0-5
    inliers single-scale against 27-54 with the pyramid on its offset loop
    course)."""
    c = config.camera
    half_cam = cam.Pinhole(c.fx / 2, c.fy / 2, c.cx / 2, c.cy / 2,
                           c.width // 2, c.height // 2)
    return VOConfig(camera=half_cam,
                    frontend=dataclasses.replace(
                        config.frontend, max_keypoints=config.loop.max_keypoints,
                        orb_pyramid=True),
                    ransac=config.ransac, lm=config.lm)


def _loop_stage(traj: np.ndarray, kf_store, config: BAConfig, seed: int, mlog,
                device=None, stats: dict | None = None):
    """The loop-closure post-stage of both BA runners: keyframe retrieval,
    ORB verification and Sim(3) / SE(3) drift correction on the finished
    trajectory (:func:`loopclose.close_loops`), the lever on the
    long-trajectory drift that the short-span stages cannot reach.
    Returns (trajectory, applied loops); ``stats`` receives the stage's
    counts and host wall seconds, ``loop_s`` the whole stage."""
    from epivo_tpu_torch.pipeline import loopclose

    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    out = loopclose.close_loops(traj, kf_store, config, _loop_vo_config(config),
                                seed=seed, mlog=mlog, device=device, stats=stats)
    stats["loop_s"] = time.perf_counter() - t0
    return out


def _keyframe_tee(frames: Iterable[np.ndarray], config: BAConfig):
    """(frames, store): ``frames`` passed through while a
    :class:`loopclose.KeyframeStore` keeps each keyframe k and its adjacent
    frame k+1 (the verification's norm-recovery pair) as half-resolution
    uint8 under the budget; (frames, None) with loop closure off."""
    if not config.loop.enabled:
        return frames, None
    from epivo_tpu_torch.pipeline import loopclose

    store = loopclose.KeyframeStore(config.loop.keyframe_stride, config.loop.keyframe_budget)

    def tee():
        for idx, f in enumerate(frames):
            store.offer(idx, f)
            yield f

    return tee(), store


def _close_loops(traj, store, config, seed, mlog, device, stats):
    """Run :func:`_loop_stage` when the runner kept keyframes; records its
    stats under ``stats["loop"]``. Returns (trajectory, loops tuple)."""
    if store is None or not store:
        return traj, ()
    stats["loop"] = {}
    traj, loops = _loop_stage(traj, store, config, seed, mlog, device=device,
                              stats=stats["loop"])
    return traj, tuple(loops)


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
    extracted pairs (see :func:`_extract_pairs`), its
    ``per_frame["zetas"]`` the scaled relative poses [F-1, 4, 4] the
    trajectory is chained from (before the loop stage).

    With ``config.global_ba.enabled`` the scaled zetas go through
    :func:`refine_global` before the trajectory is chained
    (``stats["global_ba_s"]`` holds its wall seconds). With
    ``config.loop.enabled`` a keyframe tee on the frame stream keeps
    every ``keyframe_stride``-th frame and its successor at half
    resolution, and the loop stage (:func:`_loop_stage`) corrects the
    finished trajectory; the result's ``loops`` holds the applied loops
    and ``stats["loop"]`` the stage's counts and wall seconds.

    With ``mesh`` the pair extraction, the window solve and the global
    polish are split over it (see the module docstring).
    """
    _mesh_device(mesh, device)
    t_start = time.perf_counter()
    mlog = profiling.MetricsLogger(metrics_path if _writes(mesh) else None)
    ckpt = (ckpt_mod.SequenceCheckpointer(checkpoint_dir, every=checkpoint_every,
                                          read_only=not _writes(mesh))
            if checkpoint_dir else None)
    stats: dict = {}
    if n_frames is None and hasattr(frames, "__len__"):
        n_frames = len(frames)  # the tee below hides the length
    frames, kf_store = _keyframe_tee(frames, config)
    win = prepare_mono_windows(frames, config, gt_poses=gt_poses, seed=seed,
                               ckpt=ckpt, use_orb=use_orb, n_frames=n_frames,
                               mlog=mlog, batch=batch,
                               pipeline_depth=pipeline_depth, mesh=mesh, device=device,
                               stats=stats)
    F = win.F
    t0 = time.perf_counter()
    out = _solve_windows(win.T0s, win.spec, win.p, win.p_t, win.wreps, win.pmask,
                         config, mesh=mesh, device=device)
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
    if config.global_ba.enabled:
        # Global full-trajectory polish over the complete constraint graph
        # (consecutive + skip pairs): the cross-window drift the
        # independent windows cannot see.
        t0 = time.perf_counter()
        zetas, _ = refine_global(zetas, win.pair_data, config, mesh=mesh, mlog=mlog,
                                 device=device)
        stats["global_ba_s"] = time.perf_counter() - t0
        mlog.log({"stage": "global_ba_wall", "wall_s": round(stats["global_ba_s"], 2)})
    traj = ba_mod.trajectory_from_zetas(torch.from_numpy(
        np.ascontiguousarray(zetas, np.float32))).numpy()
    traj, loops = _close_loops(traj, kf_store, config, seed, mlog, device, stats)
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
            "zetas": zetas,
        },
        loops=loops,
        stats=stats,
        pair_data=win.pair_data,
    )


def refine_global(zetas: np.ndarray, pair_data: dict, config: BAConfig,
                  mesh=None, mlog=None, device=None):
    """Global (full-trajectory) BA polish of the windowed result.

    Builds the complete constraint graph from the extracted pairs
    (consecutive pairs -> span (i, i); skip pairs -> span (i, i+1)) and
    runs ONE joint LM over the whole zeta chain with the matrix-free PCG
    solver (:func:`parallel.global_ba.global_ba_solve`) on ``device``
    (default: the CUDA card). Constraints with fewer valid matches than
    :func:`underfill_floor` of the point budget get zero weight, as in the
    windowed path (ref `kitti_ba.cpp:821-826`). With ``mesh`` the
    constraints are split over its ``win`` axis, padded to a multiple of
    it with zero-weight constraints.

    With ``config.global_ba.keep_norms`` the joint solve contributes
    rotations and translation *directions* only; per-zeta |t| is kept
    from the input chain (GT scales or the no-GT scale graph). ``mlog``
    receives one ``global_ba`` health line.

    Returns (refined zetas [Z, 4, 4] float32, GlobalBAResult on the host,
    or None when no pair gives a constraint).
    """
    dev = _mesh_device(mesh, device)
    Z = zetas.shape[0]
    gcfg = config.global_ba
    N = config.lm.n_points
    reps, rows = [], []
    for (i, j) in sorted(pair_data):
        if not (0 <= i < Z and i < j <= Z):
            continue  # backward pairs are mirrors of forward ones
        if j == i + 1:
            reps.append((i, i))
        elif j == i + 2 and i + 1 < Z:
            reps.append((i, i + 1))
        else:
            continue
        rows.append(pair_data[(i, j)])
    if not reps:
        return zetas.astype(np.float32), None
    up = lambda a: _upload(np.asarray(a), dev)
    p = np.stack([d["p"] for d in rows]).astype(np.float32)
    p_t = np.stack([d["p_t"] for d in rows]).astype(np.float32)
    pmask = np.stack([d["mask"] for d in rows])
    wreps = np.asarray(
        [1.0 if d["mask"].sum() >= underfill_floor(N) else 0.0 for d in rows], np.float32)
    reps = np.asarray(reps, np.int32)
    n_pad = (-len(reps)) % mesh_mod.axis_size(mesh, "win")
    if n_pad:
        pad = lambda a, v: np.concatenate([a, np.full((n_pad,) + a.shape[1:], v, a.dtype)])
        reps, p, p_t = pad(reps, 0), pad(p, 1.0), pad(p_t, 1.0)
        pmask, wreps = pad(pmask, False), pad(wreps, 0.0)
    res = gba.global_ba_solve(
        up(zetas.astype(np.float32)), reps, up(p), up(p_t),
        wreps=up(wreps), pmask=up(pmask), max_span=2, lambda0=config.lm.lambda0,
        max_iters=gcfg.max_iters, cg_iters=gcfg.cg_iters,
        huber_delta=config.lm.huber_delta, mesh=mesh)
    # One device-to-host copy: poses, r_norm, n_accepted, lambda.
    h = torch.cat([res.T0s.reshape(-1), torch.stack([
        res.r_norm, res.n_accepted.to(res.r_norm.dtype), res.lam])]).cpu()
    res = gba.GlobalBAResult(T0s=h[:-3].reshape(Z, 4, 4), r_norm=h[-3],
                             n_accepted=h[-2].to(torch.int32), lam=h[-1])
    z = res.T0s.numpy().astype(np.float64)
    if gcfg.keep_norms:
        n_old = np.linalg.norm(zetas[:, :3, 3], axis=-1, keepdims=True)
        n_new = np.linalg.norm(z[:, :3, 3], axis=-1, keepdims=True)
        z[:, :3, 3] = z[:, :3, 3] / np.where(n_new > 1e-12, n_new, 1.0) * n_old
    if mlog is not None:
        mlog.log({"stage": "global_ba", "r_norm": float(res.r_norm),
                  "n_accepted": int(res.n_accepted),
                  "n_constraints": int((wreps > 0).sum())})
    return z.astype(np.float32), res


class StereoScales(NamedTuple):
    """The stereo runner's metric scale per temporal step k (frames
    L_k -> L_{k+1}), before LM: see :func:`stereo_step_scales`."""

    ks: list  # steps with both a rig and a temporal pair (rows below)
    rows: list  # per row: (rig p_full, rig p_t_full, temporal T, p_full, p_t_full)
    both: np.ndarray  # [rows, K] the depth-gated points of each row
    s0: np.ndarray  # [F-1] pass 1: ratio-median init (NaN when underfilled)
    n_used: np.ndarray  # [F-1] points the init used
    gated_frac: np.ndarray  # [F-1]
    s0_clean: np.ndarray  # [F-1] s0 after the Hampel pass
    refined: np.ndarray  # [F-1] bool: pass 2 converged
    rel_err: np.ndarray  # [F-1] pass 2's relative error (NaN when not run)
    inlier_frac: np.ndarray  # [F-1] (NaN when not converged)
    s_refined: np.ndarray  # [F-1] pass 2 before its Hampel pass
    replaced0: np.ndarray  # [F-1] bool: replaced by the first Hampel pass
    replaced1: np.ndarray  # [F-1] bool: replaced by the second
    scale: np.ndarray  # [F-1] float32: the scale used (NaNs carried forward)


def _stereo_depths(rows: list, T_rig: np.ndarray, dev) -> torch.Tensor:
    """Rig (metric) and temporal (mono) epipolar depths of every step in
    one batched call on ``dev``: [4, rows, K] = (d_met, v_met, d_mono,
    v_mono), validity as 0 / 1. The rig is taken in float32, as the JAX
    package's device depths take it. Makes no host sync."""
    st = lambda q: _upload(np.stack([np.asarray(r[q], np.float32) for r in rows]), dev)
    M = len(rows)
    rig = _upload(np.asarray(T_rig, np.float32), dev)
    T_ll = st(2)
    d_met, v_met = epipolar.epipolar_depth(rig[:3, :3].expand(M, 3, 3),
                                           rig[:3, 3].expand(M, 3), st(0), st(1))
    d_mono, v_mono = epipolar.epipolar_depth(T_ll[:, :3, :3], T_ll[:, :3, 3], st(3), st(4))
    return torch.stack([d_met, v_met.to(d_met.dtype), d_mono, v_mono.to(d_mono.dtype)])


def stereo_step_scales(pair_data: dict, F: int, T_rig: np.ndarray, config: BAConfig,
                       device=None) -> StereoScales:
    """Metric scale of every temporal step from the calibrated baseline
    (the JAX package's stereo runner, two passes).

    Mono two-view poses are unit-norm; the rig provides absolute scale.
    Pass 1: the rig pair (2k, 2k+1) and the temporal pair (2k, 2k+2) share
    the keypoints of L_k (FAST is deterministic), so their epipolar depths
    give a depth ratio per point; after depth-sanity gates,
    :func:`scale.ratio_median_scale` takes the init, and
    :func:`scale.hampel_log` replaces the catastrophic ones (a tracking
    collapse makes s0 wrong by 8x). All steps' depths are one batched call
    on ``device`` and one device-to-host copy. Pass 2 (``config.scale.refine``):
    :func:`scale.estimate_step_scale`, the f64 joint ML refinement over raw
    reprojections (it removes the 1/disparity bias of the triangulated
    init), from the cleaned inits, then a second Hampel pass. Steps left
    without a scale carry the previous one forward (1.0 at the start).
    """
    sc = config.scale
    T_rig64 = np.asarray(T_rig, np.float64)
    rows, ks = [], []
    for k in range(F - 1):
        rig = pair_data.get((2 * k, 2 * k + 1))
        tem = pair_data.get((2 * k, 2 * k + 2))
        if rig is not None and tem is not None:
            rows.append((rig["p_full"], rig["p_t_full"], tem["T"],
                         tem["p_full"], tem["p_t_full"]))
            ks.append(k)
    n = max(F - 1, 0)
    s0_of, n_of, gf_of = np.full(n, np.nan), np.zeros(n, np.int32), np.zeros(n)
    ref_of, rel_of, inl_of = np.zeros(n, bool), np.full(n, np.nan), np.full(n, np.nan)
    repl0 = repl1 = np.zeros(n, bool)
    s0_clean = s_ref = s_of = np.full(n, np.nan)
    both = np.zeros((0, 0), bool)
    if rows:
        got = _stereo_depths(rows, T_rig64, runner_device(device)).cpu().numpy()
        d_met, v_met, d_mono, v_mono = got[0], got[1] > 0.5, got[2], got[3] > 0.5
        # Depth-sanity gating only: the strict per-pair inlier masks leave
        # too few common points under forward motion, and the estimators
        # are robust to the outliers this lets through.
        both = (v_met & v_mono
                & (d_met > sc.rig_depth_min) & (d_met < sc.depth_max)
                & (d_mono > sc.depth_min) & (d_mono < sc.depth_max))
        for row, k in enumerate(ks):
            s0_of[k], n_of[k], gf_of[k] = scale_mod.ratio_median_scale(
                d_met[row], d_mono[row], both[row],
                rig_depth_quantile=sc.rig_depth_quantile, min_common=sc.min_common)
        s0_clean, repl0 = scale_mod.hampel_log(
            s0_of, window=sc.hampel_window, max_ratio=sc.hampel_ratio)
        s_ref = s0_clean.copy()
        if sc.refine:
            huber_norm = sc.huber_px / float(config.camera.fx)
            for row, k in enumerate(ks):
                if not np.isfinite(s0_clean[k]) or s0_clean[k] <= 0:
                    continue
                T_ll = rows[row][2]
                u = T_ll[:3, 3] / max(np.linalg.norm(T_ll[:3, 3]), 1e-12)
                est = scale_mod.estimate_step_scale(
                    p=rows[row][0], q=rows[row][1], p2=rows[row][4],
                    R_rig=T_rig64[:3, :3], t_rig=T_rig64[:3, 3],
                    R=T_ll[:3, :3], u=u, mask=both[row], s0=float(s0_clean[k]),
                    huber=huber_norm, iters=sc.refine_iters,
                    rel_err_max=sc.rel_err_max, trust_region=sc.trust_region)
                rel_of[k] = est.rel_err
                if est.converged:
                    s_ref[k], ref_of[k] = est.s, True
                    inl_of[k] = est.inlier_frac
            # Safety net: the refinement can latch onto a wrong shallow
            # minimum on a degraded step.
            s_of, repl1 = scale_mod.hampel_log(
                s_ref, window=sc.hampel_window, max_ratio=sc.hampel_ratio)
        else:
            s_of = s_ref
    scale = np.ones(n, np.float32)
    prev = 1.0
    for k in range(n):
        if np.isfinite(s_of[k]) and s_of[k] > 0:
            prev = float(s_of[k])
        scale[k] = prev
    return StereoScales(ks=ks, rows=rows, both=both, s0=s0_of, n_used=n_of,
                        gated_frac=gf_of, s0_clean=s0_clean, refined=ref_of,
                        rel_err=rel_of, inlier_frac=inl_of, s_refined=s_ref,
                        replaced0=repl0, replaced1=repl1, scale=scale)


def _stereo_windows(pair_data: dict, anchors: list, spec, w_pattern: np.ndarray,
                    T_rig: np.ndarray, scale: np.ndarray, N: int):
    """Window tensors of the stereo runner: (T0s [W, Z, 4, 4], p, p_t
    [W, R, N, 3], wreps [W, R], pmask [W, R, N]). Even zetas start at the
    rig's calibration; odd zetas (R_k -> L_{k+1}) at the temporal pair's
    motion scaled to the metric step, composed with the inverse rig. A
    constraint whose pair is missing or underfilled gets weight 0."""
    W, R_ = len(anchors), spec.reps.shape[0]
    p = np.zeros((W, R_, N, 3), np.float32)
    p_t = np.zeros((W, R_, N, 3), np.float32)
    pmask = np.zeros((W, R_, N), bool)
    wreps = np.tile(w_pattern, (W, 1)).astype(np.float32)
    T0s = np.tile(np.eye(4, dtype=np.float32), (W, spec.n_zeta, 1, 1))
    T_rig = np.asarray(T_rig, np.float32)
    for w, a in enumerate(anchors):
        base = 2 * a
        for r, (f0, f1) in enumerate(spec.frame_pairs):
            if wreps[w, r] == 0.0:
                continue
            gi, gj = base + int(f0), base + int(f1)
            if (gi, gj) not in pair_data:
                wreps[w, r] = 0.0
                continue
            d = pair_data[(gi, gj)]
            p[w, r], p_t[w, r], pmask[w, r] = d["p"], d["p_t"], d["mask"]
            if d["mask"].sum() < underfill_floor(N):
                wreps[w, r] = 0.0
        for z in range(spec.n_zeta):
            if z % 2 == 0:
                T0s[w, z] = T_rig
                continue
            k_step = a + z // 2
            tem = pair_data.get((2 * k_step, 2 * k_step + 2))
            if tem is not None:
                T_ll = tem["T"].copy()
                tn = np.linalg.norm(T_ll[:3, 3]) + 1e-12
                T_ll[:3, 3] *= float(scale[k_step]) / tn
                T0s[w, z] = (T_ll @ np.linalg.inv(T_rig)).astype(np.float32)
            elif (base + z, base + z + 1) in pair_data:
                T0s[w, z] = pair_data[(base + z, base + z + 1)]["T"]
    return T0s, p, p_t, wreps, pmask


def _post_lm_rescale(zetas: np.ndarray, n_steps: int, ss: StereoScales,
                     T_rig: np.ndarray, config: BAConfig, mlog) -> None:
    """Re-impose the metric scale on the LM-refined chain, in place, in
    float64: the f64 joint estimator runs again against the refined step
    motion (rotation and direction) of L_k -> L_{k+1} = cross @ rig, and
    EVERY step gets a norm (the init scale where the estimator's gates
    reject; the LM's own |t| is never trusted: its heavy tail alone
    inflates the trajectory's length). A Hampel pass guards the result."""
    sc = config.scale
    T_rig64 = np.asarray(T_rig, np.float64)
    huber_norm = sc.huber_px / float(config.camera.fx)
    row_of = {k: i for i, k in enumerate(ss.ks)}
    s_post = np.full(n_steps, np.nan)
    ref_post = np.zeros(n_steps, bool)
    for k in range(n_steps):
        LtoL = zetas[2 * k + 1] @ zetas[2 * k]
        tn = float(np.linalg.norm(LtoL[:3, 3]))
        if tn < 1e-9:
            continue
        s_post[k] = float(ss.scale[k])
        row = row_of.get(k)
        if row is not None:
            r = ss.rows[row]
            est = scale_mod.estimate_step_scale(
                p=r[0], q=r[1], p2=r[4], R_rig=T_rig64[:3, :3], t_rig=T_rig64[:3, 3],
                R=LtoL[:3, :3], u=LtoL[:3, 3] / tn, mask=ss.both[row],
                s0=float(ss.scale[k]), huber=huber_norm, iters=sc.refine_iters,
                rel_err_max=sc.rel_err_max, trust_region=sc.trust_region)
            if est.converged:
                s_post[k], ref_post[k] = est.s, True
    s_post, repl_post = scale_mod.hampel_log(
        s_post, window=sc.hampel_window, max_ratio=sc.hampel_ratio)
    for k in range(n_steps):
        if not (np.isfinite(s_post[k]) and s_post[k] > 0):
            continue
        rig_T = zetas[2 * k]
        LtoL = zetas[2 * k + 1] @ rig_T
        tn = float(np.linalg.norm(LtoL[:3, 3]))
        if tn < 1e-9:
            continue
        LtoL[:3, 3] = LtoL[:3, 3] / tn * float(s_post[k])
        zetas[2 * k + 1] = LtoL @ np.linalg.inv(rig_T)
        mlog.log({"stage": "stereo_scale_post", "step": k, "s": float(s_post[k]),
                  "refined": bool(ref_post[k]), "hampel_replaced": bool(repl_post[k])})


def run_stereo_ba_sequence(
    frames_left: Iterable[np.ndarray],
    frames_right: Iterable[np.ndarray],
    config: BAConfig,
    T_rig: np.ndarray,
    gt_poses: np.ndarray | None = None,
    seed: int = 0,
    freeze_rig: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 64,
    n_frames: int | None = None,
    metrics_path: str | None = None,
    batch: int = 8,
    pipeline_depth: int = 2,
    mesh=None,
    device=None,
) -> SequenceResult:
    """Windowed stereo BA (ref `kitti_ba` stereo path, `kitti_ba.cpp:908-1068`).

    Doubled index space (2i = L_i, 2i+1 = R_i); per temporal step the
    constraints are L->L' (span rig+cross), R->L' (cross only), and the rig
    itself. ``T_rig`` is the calibrated L->R transform (from
    ``KittiSequence.stereo_baseline_T``); with ``freeze_rig`` the rig zetas
    are held exactly at calibration, so the metric scale comes from the
    baseline and no GT scale is needed.

    Left and right frames stream through one bounded interleaved buffer:
    pass generators plus ``n_frames`` (or sized sequences) and only the
    frames the pending pairs need stay resident. The rig pairs (2k, 2k+1)
    are extracted with the temporal (2k, 2k+2) and cross (2k+1, 2k+2)
    pairs, in sorted order (the ORB retry's cap takes the first pairs that
    qualify): they never enter LM but give the metric depths of
    :func:`stereo_step_scales`. All windows solve in one batched LM call;
    the stitched chain comes back once and the post-LM rescale composes
    it in float64 on the host. The ATE is metric (no scale alignment).
    The host waits on the card at three places only: one device-to-host
    copy per extraction batch (the pipelined fetch), one for every step's
    depths, one for the solved windows; the float64 scale stages between
    them run on the host by design.

    The result's ``stats`` holds the pair, retry and replace counts, the
    frame stream's ``peak_buffered``, the Hampel replacements and window
    counts, and the host wall seconds of each stage; its ``pair_data``
    the extracted pairs. With ``config.loop.enabled`` the keyframe tee
    takes the LEFT frames, indexed by frame k (not the doubled index): the
    trajectory the loop stage corrects is the per-frame left-camera chain
    (see :func:`run_ba_sequence`). With ``mesh`` the pair extraction and
    the window solve are split over it. The stereo runner has no global-BA
    stage, as in the reference.
    """
    _mesh_device(mesh, device)
    t_start = time.perf_counter()
    mlog = profiling.MetricsLogger(metrics_path if _writes(mesh) else None)
    if n_frames is None:
        try:
            n_frames = min(len(frames_left), len(frames_right))
        except TypeError:
            frames_left = [np.asarray(f, np.float32) for f in frames_left]
            frames_right = [np.asarray(f, np.float32) for f in frames_right]
            n_frames = min(len(frames_left), len(frames_right))
    F = n_frames
    frames_left, kf_store = _keyframe_tee(frames_left, config)

    def doubled_stream():
        for k, (l_img, r_img) in enumerate(zip(frames_left, frames_right)):
            if k >= F:
                break
            yield np.asarray(l_img, np.float32)
            yield np.asarray(r_img, np.float32)

    fs = stream.FrameStream(doubled_stream(), n_frames=2 * F)
    ws = config.window_size
    spec, w_pattern = ba_mod.stereo_window_spec(ws, freeze_rig=freeze_rig)
    anchors = list(range(0, F - ws + 1, config.stride))
    if not anchors:
        raise ValueError(f"need at least {ws} stereo frames, got {F}")
    vo_cfg = VOConfig(camera=config.camera, frontend=config.frontend,
                      ransac=config.ransac, lm=config.lm)
    N = config.lm.n_points
    need = {(2 * a + int(f0), 2 * a + int(f1)) for a in anchors
            for f0, f1 in spec.frame_pairs if 2 * a + int(f1) < 2 * F}
    ckpt = (ckpt_mod.SequenceCheckpointer(checkpoint_dir, every=checkpoint_every,
                                          read_only=not _writes(mesh))
            if checkpoint_dir else None)
    stats: dict = {}
    pair_data = _extract_pairs(fs, sorted(need), vo_cfg, seed, n_points=N, ckpt=ckpt,
                               mlog=mlog, batch=batch, pipeline_depth=pipeline_depth,
                               mesh=mesh, device=device, stats=stats)
    stats["peak_buffered"] = fs.peak_buffered

    t0 = time.perf_counter()
    ss = stereo_step_scales(pair_data, F, T_rig, config, device=device)
    opt = lambda v, nd: None if not np.isfinite(v) else round(float(v), nd)
    for k in range(F - 1 if ss.rows else 0):
        mlog.log({"stage": "stereo_scale", "step": k, "s0": opt(ss.s0[k], 5),
                  "s": float(ss.scale[k]), "n_used": int(ss.n_used[k]),
                  "gated_frac": round(float(ss.gated_frac[k]), 3),
                  "refined": bool(ss.refined[k]),
                  "hampel_replaced": bool(ss.replaced0[k] or ss.replaced1[k]),
                  "inlier_frac": opt(ss.inlier_frac[k], 3),
                  "rel_err": opt(ss.rel_err[k], 4)})
    T0s, p, p_t, wreps, pmask = _stereo_windows(pair_data, anchors, spec, w_pattern,
                                                T_rig, ss.scale, N)
    t1 = time.perf_counter()
    out = _solve_windows(T0s, spec, p, p_t, wreps, pmask, config, mesh=mesh, device=device)
    t2 = time.perf_counter()
    _log_windows(mlog, anchors, out)
    zetas = ba_mod.stitch_windows(torch.from_numpy(out.T_opt)).numpy().astype(np.float64)
    n_steps = min(F - 1, zetas.shape[0] // 2)
    sc = config.scale
    if sc.post_lm_rescale and sc.refine and ss.rows:
        _post_lm_rescale(zetas, n_steps, ss, T_rig, config, mlog)
    traj = ba_mod.stereo_left_trajectory(torch.from_numpy(
        np.ascontiguousarray(zetas[: 2 * n_steps], np.float32))).numpy()
    t3 = time.perf_counter()
    traj, loops = _close_loops(traj, kf_store, config, seed, mlog, device, stats)
    mlog.close()

    ate = rpe_t = None
    gt_traj = None
    if gt_poses is not None:
        gt_traj = gt_poses[: traj.shape[0]]
        gt_traj = np.linalg.inv(gt_traj[0])[None] @ gt_traj
        ate = metrics.ate_rmse(traj, gt_traj, align=True, with_scale=False)
        rpe_t, _ = metrics.rpe(traj, gt_traj)

    stats.update(n_scale_steps=len(ss.ks), n_refined=int(ss.refined.sum()),
                 n_hampel=int((ss.replaced0 | ss.replaced1).sum()),
                 n_windows=len(anchors), n_reverted=int(out.reverted.sum()),
                 scale_s=t1 - t0, solve_s=t2 - t1, rescale_s=t3 - t2,
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
        loops=loops,
        stats=stats,
        pair_data=pair_data,
    )


def run_gt_triangulation_sequence(
    frames: Iterable[np.ndarray],
    config: VOConfig,
    gt_poses: np.ndarray,
    seed: int = 0,
    device=None,
) -> SequenceResult:
    """GT-motion triangulation sanity runner (ref `kitti.cpp:39-188`, C25).

    No pose estimation is trusted: the frontend supplies matches, but the
    relative motion comes from GT, and the cloud is triangulated against
    it (the 'validate triangulation before trusting estimated motion'
    tool). All pairs triangulate in one batched call on ``device``, with
    one device-to-host copy. The trajectory returned IS the GT trajectory.
    """
    fs = stream.FrameStream(frames)
    if not fs.sized:
        fs.materialize()
    F = min(len(fs), len(gt_poses))
    pairs = [(i, i + 1) for i in range(F - 1)]
    pair_data = _extract_pairs(fs, pairs, config, seed, n_points=config.lm.n_points,
                               device=device)

    gt = np.asarray(gt_poses[:F])
    gt = np.linalg.inv(gt[0])[None] @ gt  # start at identity
    clouds, limits = [], []
    if pairs:
        dev = runner_device(device)
        # Source camera i -> camera j, for every pair.
        T_zeta = (np.linalg.inv(gt[1:]) @ gt[:-1]).astype(np.float32)
        up = lambda a: _upload(np.asarray(a, np.float32), dev)
        X, ok = epipolar.triangulate(
            up(T_zeta[:, :3, :3]), up(T_zeta[:, :3, 3]),
            up(np.stack([pair_data[pr]["p_full"] for pr in pairs])),
            up(np.stack([pair_data[pr]["p_t_full"] for pr in pairs])))
        h = torch.cat([X, ok[..., None].to(X.dtype)], dim=-1).cpu().numpy()
        total = 0
        for b, (i, j) in enumerate(pairs):
            keep = (h[b, :, 3] > 0.5) & pair_data[(i, j)]["mask_full"]
            clouds.append(h[b, keep, :3] @ gt[i][:3, :3].T + gt[i][:3, 3])
            limits.append(total)
            total += int(keep.sum())

    cloud = np.concatenate(clouds) if clouds else np.zeros((0, 3))
    return SequenceResult(
        trajectory=gt,
        gt_trajectory=gt,
        ate=0.0,
        rpe_t=0.0,
        cloud=cloud,
        cloud_limits=np.asarray(limits, np.int64),
        per_frame={"n_points": np.asarray([len(c) for c in clouds])},
        pair_data=pair_data,
    )
