"""Two-view visual odometry step (port of ``epivo_tpu/pipeline/vo.py``).

    images -> FAST -> KLT -> RANSAC essential -> (refine E) -> recoverPose
           -> fallbacks -> top-K cheirality-filtered matches -> LM refine
           -> revert-on-high-uncertainty -> relative pose + triangulated cloud

The ORB step (:func:`vo_step_orb_batched`) replaces FAST -> KLT by FAST ->
oriented BRIEF -> Hamming matching and shares everything after it.

Every step after image upload runs on the images' device with static
shapes and no host sync (``chip_smoke.py`` runs the batched step under
``torch.cuda.set_sync_debug_mode("error")``). The single step is the
batched step of one pair, so there is one code path.

With ``config.distortion`` set the step takes raw frames and undistorts
both frames of every pair first, in one call (``frontend/undistort.py``;
one kernel launch on CUDA images), inside the captured graph.

A step that runs the hand-written kernels launches its stage marks on
its stream while it is captured or profiled (``utils/profiling.py::mark``):
``undistort`` before the undistortion (raw frames only), ``frontend``
before detection and tracking or matching, ``estimate`` before the RANSAC
samples, ``refine`` before the top-N selection and the LM, ``end`` after
triangulation. The plain route carries no marks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from epivo_tpu_torch import _graphs, ransac as ransac_mod
from epivo_tpu_torch._device import constant
from epivo_tpu_torch.frontend import fast, klt, match as match_mod, orb, undistort
from epivo_tpu_torch.geometry import camera as cam, epipolar, essential, se3
from epivo_tpu_torch.optim import lm
from epivo_tpu_torch.parallel import mesh as mesh_mod
from epivo_tpu_torch.pipeline.config import VOConfig
from epivo_tpu_torch.utils import profiling


class VOStepResult(NamedTuple):
    """One pair's result; :func:`vo_step_batched` gives every field a
    leading [B]."""

    T: torch.Tensor  # [4, 4] refined relative pose (source -> target)
    n_tracked: torch.Tensor  # [] int32
    n_inliers: torch.Tensor  # [] int32
    r_norm: torch.Tensor  # [] LM residual norm
    reverted: torch.Tensor  # [] bool: LM result rejected, E-pose kept
    points: torch.Tensor  # [K, 3] triangulated points (source frame)
    points_valid: torch.Tensor  # [K] bool (tracked & inlier & triangulable)
    matches_src: torch.Tensor  # [K, 2] pixel coords in source image
    matches_tgt: torch.Tensor  # [K, 2]
    inlier_mask: torch.Tensor  # [K] bool: tracked & epipolar-inlier


def _unit_translation(T: torch.Tensor) -> torch.Tensor:
    """Normalize the pose's translation to unit norm (a zero translation is
    left untouched). T [..., 4, 4]."""
    t = T[..., :3, 3]
    n = torch.linalg.norm(t, dim=-1, keepdim=True)
    safe = torch.where(n > 1e-12, n, 1.0)
    out = T.clone()
    out[..., :3, 3] = t / safe
    return out


def _select_top(mask: torch.Tensor, k: int):
    """Indices of the first k True lanes of the last axis (score-ordered
    input assumed); returns (idx [..., k], valid [..., k])."""
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)  # True first
    idx = order[..., :k]
    return idx, torch.gather(mask, -1, idx)


def _two_view_tail(p0: torch.Tensor, p1: torch.Tensor, status: torch.Tensor,
                   n_tracked: torch.Tensor, matches_src: torch.Tensor,
                   matches_tgt: torch.Tensor, generator: torch.Generator | None,
                   config: VOConfig, ransac_samples: torch.Tensor | None,
                   too_few: torch.Tensor | None = None, hyp_mesh=None,
                   use_kernel: bool | None = None) -> VOStepResult:
    """Everything after association, shared by the KLT and ORB steps: B
    pairs of normalized matches p0/p1 [B, K, 3] with their mask
    ``status`` [B, K] -> RANSAC essential, refine-E, recoverPose and its
    fallback, the top-N cheirality-passing inliers into one batched LM
    (one window per pair), revert-on-uncertainty, unit translation and
    triangulation.

    ``too_few`` [B] (the ORB step's match gate) replaces a pair's E-pose
    by the identity rotation and translation [0.1, 0.1, -0.9] and forces
    its revert. ``hyp_mesh`` splits RANSAC's hypotheses over a mesh's
    ``hyp`` axis (:func:`ransac.ransac_essential`). ``use_kernel``, the
    step's, says whether it marks the ``refine`` and ``end`` stages
    (``utils/profiling.py::mark``).
    """
    rc, lc = config.ransac, config.lm
    dev = p0.device
    thr = (rc.threshold_px / config.camera.fx) ** 2
    rres = ransac_mod.ransac_essential(
        generator, p0, p1, n_hyp=rc.hypotheses(), threshold=thr,
        mask=status, method=rc.method, solver=rc.solver,
        samples=ransac_samples, hyp_mesh=hyp_mesh,
    )
    E = rres.E
    if rc.refine_e:
        E = essential.refine_essential(E, p0, p1, mask=rres.inliers,
                                       iters=rc.refine_iters)
    R_e, t_e, front = essential.recover_pose(E, p0, p1, mask=rres.inliers)
    R_e, t_e = essential.pose_fallback(R_e, t_e)
    if too_few is not None:
        eye = torch.eye(3, dtype=R_e.dtype, device=dev)
        t_fb = constant([0.1, 0.1, -0.9], t_e.dtype, dev)
        R_e = torch.where(too_few[:, None, None], eye, R_e)
        t_e = torch.where(too_few[:, None], t_fb, t_e)
    T_e = se3.rt_to_matrix(R_e, t_e)  # [B, 4, 4]

    profiling.mark("refine", p0, use_kernel)
    # Top-N cheirality-passing inliers of each pair for LM refinement: one
    # window per pair, one pose, one constraint.
    sel = rres.inliers & front & status
    idx, sel_valid = _select_top(sel, lc.n_points)  # [B, n]
    pick = lambda q: torch.gather(q, 1, idx[..., None].expand(-1, -1, 3))[:, None]
    out = lm.solve_batched(
        T_e[:, None], torch.zeros((1, 2), dtype=torch.int64, device=dev),
        pick(p0), pick(p1), pmask=sel_valid[:, None],
        lambda0=lc.lambda0, epsilon=lc.epsilon, max_iters=lc.max_iters,
        huber_delta=lc.huber_delta,
    )
    # Revert to the E-pose when LM uncertainty is high or too few points
    # were available to refine.
    enough = torch.sum(sel_valid, dim=-1) >= lc.min_points
    revert = (out.r_norm > lc.revert_r_norm) | ~enough  # [B]
    if too_few is not None:
        revert = revert | too_few
    T = torch.where(revert[:, None, None], T_e, out.T0s[:, 0])
    # Two-view geometry is gauge-free in |t|: pin the unit norm.
    T = _unit_translation(T)

    R, t = se3.matrix_to_rt(T)
    pts, pts_valid = epipolar.triangulate(R, t, p0, p1)
    track_inl = status & rres.inliers
    profiling.mark("end", p0, use_kernel)

    return VOStepResult(
        T=T,
        n_tracked=n_tracked,
        n_inliers=rres.n_inliers,
        r_norm=out.r_norm,
        reverted=revert,
        points=pts,
        points_valid=pts_valid & track_inl,
        matches_src=matches_src,
        matches_tgt=matches_tgt,
        inlier_mask=track_inl,
    )


def _undistorted(img0: torch.Tensor, img1: torch.Tensor, config: VOConfig,
                 use_kernel: bool | None):
    """The pairs' frames [B, H, W] undistorted through ``config.distortion``
    in one call, behind the ``undistort`` mark; as given without one."""
    if config.distortion is None:
        return img0, img1
    profiling.mark("undistort", img0, use_kernel)
    both = undistort.undistort((img0, img1), config.camera, config.distortion, use_kernel)
    return both[:img0.shape[0]], both[img0.shape[0]:]


def _klt_matches(img0: torch.Tensor, img1: torch.Tensor, config: VOConfig,
                 use_kernel: bool | None):
    """FAST -> KLT of B pairs: (p0, p1 [B, K, 3] normalized, status [B, K],
    n_tracked [B], source and target pixels [B, K, 2])."""
    fc = config.frontend
    K_inv = config.camera.K_inv(img0.dtype, img0.device)

    kp = fast.detect(img0, fc.fast_threshold, fc.max_keypoints,
                     use_kernel=use_kernel)
    flow = klt.track(
        img0, img1, kp.xy, valid=kp.valid, win=fc.klt_window,
        levels=fc.klt_levels, iters=fc.klt_iters, min_eig=fc.klt_min_eig,
        use_kernel=use_kernel,
    )
    n_tracked = torch.sum(flow.status, dim=-1).to(torch.int32)
    p0 = cam.normalize(kp.xy, K_inv)  # [B, K, 3]
    p1 = cam.normalize(flow.xy, K_inv)
    return p0, p1, flow.status, n_tracked, kp.xy, flow.xy


def _captured_samples(draw, status, config: VOConfig, drawn: bool):
    """The samples of a captured step: the Gumbel top-k over the matched
    mask ``status`` of the uniforms ``draw`` [B, n_hyp, K] when ``drawn``
    (as in :func:`ransac._sample_indices`), else ``draw`` itself, the
    samples [B, n_hyp, m]."""
    if not drawn:
        return draw
    return ransac_mod.gumbel_top_k(draw, status, ransac_mod.SAMPLE_SIZE[
        config.ransac.solver], device=status.device)


def _klt_graphed(static, img0, img1, draw):
    """The captured KLT step: ``static`` = (config, use_kernel, drawn, the
    hyp split's ``MeshKey`` or None); ``draw`` is the uniforms [B, n_hyp,
    K] of :func:`ransac.draw_uniforms` (``drawn``) or the samples [B,
    n_hyp, m]."""
    config, use_kernel, drawn, hyp = static
    img0, img1 = _undistorted(img0, img1, config, use_kernel)
    profiling.mark("frontend", img0, use_kernel)
    m = _klt_matches(img0, img1, config, use_kernel)
    profiling.mark("estimate", img0, use_kernel)
    return _two_view_tail(*m, None, config, _captured_samples(draw, m[2], config, drawn),
                          hyp_mesh=None if hyp is None else hyp.mesh, use_kernel=use_kernel)


def _orb_graphed(static, img0, img1, draw):
    """The captured ORB step, with the 8-match gate; arguments as in
    :func:`_klt_graphed`."""
    config, use_kernel, drawn, hyp = static
    img0, img1 = _undistorted(img0, img1, config, use_kernel)
    profiling.mark("frontend", img0, use_kernel)
    m = _orb_matches(img0, img1, config, use_kernel)
    profiling.mark("estimate", img0, use_kernel)
    return _two_view_tail(*m, None, config, _captured_samples(draw, m[2], config, drawn),
                          too_few=m[3] < 8, hyp_mesh=None if hyp is None else hyp.mesh,
                          use_kernel=use_kernel)


def _run_graphed(step, img0, img1, generator, config: VOConfig, ransac_samples,
                 use_kernel, hyp_mesh, K: int) -> VOStepResult:
    """``step`` (:func:`_klt_graphed` or :func:`_orb_graphed`) through the
    graph cache: on injected samples, or on uniforms [B, n_hyp, K] drawn
    from ``generator`` (or a :class:`ransac.BatchDraw`'s rows of its whole
    batch) before each replay (K: the step's match count)."""
    hyp = None if hyp_mesh is None else mesh_mod.MeshKey(hyp_mesh)
    if ransac_samples is not None:
        return _graphs.run(step, (config, use_kernel, False, hyp), img0, img1,
                           ransac_samples)
    if generator is None:
        raise ValueError("a graphed step needs a generator or ransac_samples")
    shape = (img0.shape[0], config.ransac.hypotheses(), K)
    draw = _graphs.Fill(shape, torch.float32, img0.device, lambda out: (
        ransac_mod.draw_uniforms(generator, shape[1], shape[2], shape[:1], out=out)))
    return _graphs.run(step, (config, use_kernel, True, hyp), img0, img1, draw)


def _hyp_split(hyp_mesh):
    """The mesh when its ``hyp`` axis splits the hypotheses, else None (a
    ``hyp`` axis of one rank leaves RANSAC as it is)."""
    return hyp_mesh if mesh_mod.axis_size(hyp_mesh, "hyp") > 1 else None


def _eager_reason(img0, generator, hyp_mesh) -> str | None:
    """Why a step on these arguments cannot be captured, or None."""
    if not mesh_mod.capturable(hyp_mesh):
        return "a gloo mesh"  # the hyp split's all_gather
    if isinstance(generator, ransac_mod.BatchDraw):
        generator = generator.generator
    if isinstance(generator, torch.Generator):
        g, d = generator.device, img0.device
        if g.type != d.type or (g.index is not None and d.index is not None
                                and g.index != d.index):
            return f"a generator on {g} for images on {d}"
    return None


def vo_step_batched(img0: torch.Tensor, img1: torch.Tensor,
                    generator: torch.Generator | None, config: VOConfig,
                    ransac_samples: torch.Tensor | None = None,
                    use_kernel: bool | None = None, hyp_mesh=None,
                    graph: bool | None = None) -> VOStepResult:
    """B two-view VO steps at once. img0/img1: [B, H, W] float32 grayscale,
    raw frames of the camera's lens where ``config.distortion`` is set.

    The reference's ``jax.vmap(vo_step)`` with the pair axis written out:
    one FAST candidate launch and one KLT level launch per pyramid level
    for all B pairs, per-pair RANSAC winners, refine-E and one batched LM
    (W = B windows of one pose and one constraint), with no host sync.
    ``generator`` draws every pair's RANSAC samples in one draw;
    ``ransac_samples`` (a LongTensor [B, n_hyp, m], m the solver's sample
    size: 8, or 5 with ``config.ransac.solver == "5pt"``) replaces that
    draw; a :class:`ransac.BatchDraw` in place of ``generator`` draws a
    larger batch and keeps these B lanes' rows of it. ``hyp_mesh`` (a
    ``DeviceMesh`` with a ``hyp`` axis) splits every pair's hypotheses over
    that axis, as the reference's ``vo_step(hyp_mesh=)`` does (one
    ``all_gather`` inside the step).
    ``use_kernel=None`` runs the CUDA kernels for CUDA images and the plain
    versions for CPU images. Every field of the result has a leading [B].

    ``graph`` (``_graphs.wanted``): ``None`` replays the step as a CUDA
    graph cached per (config, ``use_kernel``, the hyp split's groups,
    input shapes) for CUDA images, unless a hyp split over a gloo mesh, a
    generator on another device or ``use_kernel=False`` keeps it eager;
    ``True`` raises where it cannot capture; ``False`` runs eagerly. The
    uniforms behind the samples (a ``BatchDraw``'s rows of its whole
    batch) are drawn eagerly before each replay, so a graphed and an eager
    step from one generator state draw the same samples, and give the same
    result bit for bit. A hyp split over an NCCL mesh is captured with its
    ``all_gather``: every rank of the ``hyp`` axis must make the same calls
    (``_graphs.py``).
    """
    hyp_mesh = _hyp_split(hyp_mesh)
    drawn_by = generator if ransac_samples is None else None
    if _graphs.wanted(img0, graph, _eager_reason(img0, drawn_by, hyp_mesh),
                      default=use_kernel is not False):
        H, W = img0.shape[-2:]
        return _run_graphed(_klt_graphed, img0, img1, generator, config, ransac_samples,
                            use_kernel, hyp_mesh,
                            fast.n_keypoints(H, W, config.frontend.max_keypoints))
    img0, img1 = _undistorted(img0, img1, config, use_kernel)
    profiling.mark("frontend", img0, use_kernel)
    m = _klt_matches(img0, img1, config, use_kernel)
    profiling.mark("estimate", img0, use_kernel)
    return _two_view_tail(*m, generator, config, ransac_samples, hyp_mesh=hyp_mesh,
                          use_kernel=use_kernel)


def orb_associate(img0: torch.Tensor, img1: torch.Tensor, config: VOConfig,
                  use_kernel: bool | None = None):
    """ORB association of B pairs [B, H, W]: both frames of every pair
    detected in one stacked call (single-scale, or the pyramid when
    ``config.frontend.orb_pyramid``) and described in one call, then
    Hamming matching with cross-check at distance 64.

    Returns (source keypoints, matched target coordinates [B, K, 2],
    match mask [B, K]). Invalid lanes carry an in-bounds target index and
    are masked.
    """
    fc = config.frontend
    B = img0.shape[0]
    both = torch.cat([img0, img1])  # [2B, H, W]
    if fc.orb_pyramid:
        kp, d, _ = orb.detect_and_describe_pyramid(
            both, fc.fast_threshold, fc.max_keypoints, n_levels=fc.orb_levels,
            scale_factor=fc.orb_scale_factor, use_kernel=use_kernel)
    else:
        kp = fast.detect(both, fc.fast_threshold, fc.max_keypoints,
                         use_kernel=use_kernel)
        d = orb.describe(both, kp.xy, kp.valid, use_kernel=use_kernel)
    m = match_mod.match(d.signs[:B], d.signs[B:], valid1=kp.valid[:B],
                        valid2=kp.valid[B:], max_dist=64.0)
    tgt = torch.clamp(m.idx, min=0)[..., None].expand(-1, -1, 2)
    kp0 = fast.Keypoints(xy=kp.xy[:B], score=kp.score[:B], valid=kp.valid[:B])
    return kp0, torch.gather(kp.xy[B:], 1, tgt), m.valid


def _orb_matches(img0: torch.Tensor, img1: torch.Tensor, config: VOConfig,
                 use_kernel: bool | None):
    """ORB association of B pairs in :func:`_klt_matches`'s form: (p0, p1
    [B, K, 3] normalized, match mask [B, K], match count [B], source and
    target pixels [B, K, 2])."""
    K_inv = config.camera.K_inv(img0.dtype, img0.device)
    kp0, tgt_xy, status = orb_associate(img0, img1, config, use_kernel)
    n_matches = torch.sum(status, dim=-1).to(torch.int32)
    return (cam.normalize(kp0.xy, K_inv), cam.normalize(tgt_xy, K_inv), status, n_matches,
            kp0.xy, tgt_xy)


def vo_step_orb_batched(img0: torch.Tensor, img1: torch.Tensor,
                        generator: torch.Generator | None, config: VOConfig,
                        ransac_samples: torch.Tensor | None = None,
                        use_kernel: bool | None = None, hyp_mesh=None,
                        graph: bool | None = None) -> VOStepResult:
    """B two-view steps with ORB descriptor matching instead of KLT
    tracking (the reference's ``vo_step_orb``, pair axis written out).
    img0/img1: [B, H, W] float32.

    :func:`orb_associate`, then the tail of :func:`vo_step_batched`, with a
    >= 8-match gate: a pair with fewer matches keeps the identity rotation
    and translation [0.1, 0.1, -0.9] and is marked reverted. Descriptor
    matching survives larger motions than KLT at the cost of subpixel
    accuracy. On CUDA images a single-scale call launches the FAST
    candidate kernel once and the window-extraction kernel once, and
    makes no host sync. ``n_tracked`` counts the matches.
    ``ransac_samples``, ``use_kernel``, ``hyp_mesh`` and ``graph`` as in
    :func:`vo_step_batched`: association, the gate and the tail are
    captured together, and the uniforms behind the samples are drawn
    before each replay (their K from :func:`orb.n_keypoints`).
    """
    hyp_mesh = _hyp_split(hyp_mesh)
    drawn_by = generator if ransac_samples is None else None
    if _graphs.wanted(img0, graph, _eager_reason(img0, drawn_by, hyp_mesh),
                      default=use_kernel is not False):
        H, W = img0.shape[-2:]
        return _run_graphed(_orb_graphed, img0, img1, generator, config, ransac_samples,
                            use_kernel, hyp_mesh, orb.n_keypoints(H, W, config.frontend))
    img0, img1 = _undistorted(img0, img1, config, use_kernel)
    profiling.mark("frontend", img0, use_kernel)
    m = _orb_matches(img0, img1, config, use_kernel)
    profiling.mark("estimate", img0, use_kernel)
    return _two_view_tail(*m, generator, config, ransac_samples, too_few=m[3] < 8,
                          hyp_mesh=hyp_mesh, use_kernel=use_kernel)


def vo_step(img0: torch.Tensor, img1: torch.Tensor,
            generator: torch.Generator | None, config: VOConfig,
            ransac_samples: torch.Tensor | None = None,
            use_kernel: bool | None = None, graph: bool | None = None) -> VOStepResult:
    """One two-view VO step: :func:`vo_step_batched` with B = 1.
    img0/img1: [H, W] float32 grayscale.

    ``generator`` draws the RANSAC samples; ``ransac_samples`` (a LongTensor
    [n_hyp, m], m = 8, or 5 with the 5-point solver) replaces that draw. ``use_kernel=None`` runs the CUDA
    kernels for CUDA images and the plain versions for CPU images;
    ``graph`` as in :func:`vo_step_batched`.
    """
    out = vo_step_batched(img0[None], img1[None], generator, config,
                          None if ransac_samples is None else ransac_samples[None],
                          use_kernel, graph=graph)
    return VOStepResult(*(f[0] for f in out))


def vo_step_orb(img0: torch.Tensor, img1: torch.Tensor,
                generator: torch.Generator | None, config: VOConfig,
                ransac_samples: torch.Tensor | None = None,
                use_kernel: bool | None = None, graph: bool | None = None) -> VOStepResult:
    """One two-view step with ORB matching: :func:`vo_step_orb_batched`
    with B = 1. img0/img1: [H, W] float32; ``ransac_samples`` [n_hyp, m]
    and ``graph`` as in :func:`vo_step`."""
    out = vo_step_orb_batched(img0[None], img1[None], generator, config,
                              None if ransac_samples is None else ransac_samples[None],
                              use_kernel, graph=graph)
    return VOStepResult(*(f[0] for f in out))


def apply_scale(T: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Keep rotation + translation direction, set the translation magnitude."""
    t = T[..., :3, 3]
    t_unit = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)
    out = T.clone()
    out[..., :3, 3] = t_unit * torch.as_tensor(scale, dtype=T.dtype,
                                               device=T.device)[..., None]
    return out


def accumulate_trajectory(dTs: torch.Tensor, T_init: torch.Tensor | None = None):
    """cT_{i+1} = cT_i @ inv(dT_i). dTs [F, 4, 4] per-step relative poses;
    returns the [F+1, 4, 4] camera-to-world trajectory starting at identity
    (or T_init)."""
    cT = torch.eye(4, dtype=dTs.dtype, device=dTs.device) if T_init is None else T_init
    traj = [cT]
    for dT in dTs:
        cT = cT @ se3.inverse(dT)
        traj.append(cT)
    return torch.stack(traj)
