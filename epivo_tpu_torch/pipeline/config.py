"""Pipeline configuration dataclasses (port of
``epivo_tpu/pipeline/config.py``).

Field names and defaults match the reference, so
:func:`epivo_tpu_torch.convert.config_from_reference` can copy them one by
one. ``BAConfig`` nests ``ScaleConfig`` (read by the scale graph and the
mono chain), ``GlobalBAConfig`` and ``LoopConfig``; the last two stages
are not ported yet (the runners refuse them when enabled), and their
fields are carried so that configs convert field for field.
"""

from __future__ import annotations

import dataclasses

from epivo_tpu_torch.geometry import camera as cam


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    fast_threshold: float = 40.0
    max_keypoints: int = 1024  # fixed budget
    klt_window: int = 21
    klt_levels: int = 4
    klt_iters: int = 12  # fixed count (accuracy is flat beyond ~10)
    klt_min_eig: float = 1e-4
    # ORB path (vo_step_orb): multi-scale detection when orb_pyramid.
    orb_pyramid: bool = False
    orb_levels: int = 8
    orb_scale_factor: float = 1.2
    # ORB retry of pairs whose KLT association collapses (the runners'
    # _extract_pairs): RANSAC inliers below this fraction of the budget,
    # or a reverted step; 0 disables. At most orb_fallback_max pairs.
    orb_fallback_frac: float = 0.25
    orb_fallback_max: int = 128


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    # Hypothesis count; None derives it from (confidence, outlier_ratio).
    n_hyp: int | None = None
    confidence: float = 0.99
    outlier_ratio: float = 0.5
    threshold_px: float = 1.0  # pixel threshold; normalized by fx at use
    method: str = "ransac"  # or "lmeds"
    solver: str = "8pt"  # "5pt" is not ported yet
    # Gauss-Newton refinement of E on its 5-DoF manifold after RANSAC.
    refine_e: bool = True
    refine_iters: int = 8

    def hypotheses(self) -> int:
        """Static hypothesis count: explicit ``n_hyp``, else derived from
        the confidence policy, rounded up to a multiple of 128 and clamped
        to [128, 4096] (the reference's rule)."""
        if self.n_hyp is not None:
            return self.n_hyp
        from epivo_tpu_torch import ransac as _ransac

        n = _ransac.n_iterations(self.confidence, self.outlier_ratio,
                                 sample_size=5 if self.solver == "5pt"
                                 else _ransac.MIN_SAMPLE)
        return int(min(max(128, -(-n // 128) * 128), 4096))


def underfill_floor(n_points: int) -> int:
    """Minimum valid matches for a window constraint to keep its weight
    (below it the constraint is zero-weighted, the reference's
    underfilled-constraint handling, `kitti_ba.cpp:821-826`): a quarter of
    the point budget, and at least the 8 an essential matrix needs."""
    return max(8, n_points // 4)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    lambda0: float = 1e-2
    epsilon: float = 1e-8
    max_iters: int = 30
    huber_delta: float = 1e-5
    n_points: int = 48  # LM point budget
    # Minimum valid points to accept a refinement.
    min_points: int = 12
    # Revert to the E-pose above this final residual norm (f32 calibrated);
    # BA windows use 1e-2.
    revert_r_norm: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """Scale recovery: the no-GT mono scale graph and chain
    (``pipeline/scale.py``) and the stereo metric scale of
    ``runners.run_stereo_ba_sequence`` (depth-ratio init, f64 refinement,
    post-LM rescale)."""

    # Depth sanity gates for ratio medians (mono chain + stereo init).
    depth_min: float = 1e-3
    depth_max: float = 1e4
    rig_depth_min: float = 0.1  # rig-triangulated depths below are bad tracks
    rig_depth_quantile: float = 0.4  # nearest fraction kept for the stereo init
    min_common: int = 4  # jointly valid points to trust a boundary estimate
    # f64 joint ML scale refinement from raw reprojections.
    refine: bool = True
    refine_iters: int = 25
    huber_px: float = 2.0
    rel_err_max: float = 0.08  # accept a refined scale below this rel. error
    trust_region: float = 1.3  # max ratio of a refinement to its robust init
    # Stereo per-step temporal consistency (Hampel filter in log space).
    hampel_window: int = 7
    hampel_ratio: float = 1.5
    chain_smooth: int = 1  # median filter width over mono log-ratios (1: off)
    # Mono-chain catastrophic-boundary gate (0 disables; mad_k 0: fixed gate).
    chain_hampel_window: int = 7
    chain_hampel_ratio: float = 1.5
    chain_hampel_mad_k: float = 0.0
    chain_flow_topfrac: float = 0.3  # top-parallax fraction for the ratio median
    # No-GT mono scale graph (Huber M-estimate per edge, constant-speed prior).
    graph: bool = True
    graph_huber: float = 2.0
    graph_prior_sigma: float = 0.10
    graph_cut: float = 0.8
    post_lm_rescale: bool = True  # re-impose the scale after the window solve


@dataclasses.dataclass(frozen=True)
class GlobalBAConfig:
    """Global full-trajectory BA polish over the windowed result
    (``parallel/global_ba.py`` in the reference; not ported yet)."""

    enabled: bool = False
    max_iters: int = 20
    cg_iters: int = 32
    keep_norms: bool = True  # take |t| from the scale chain, not the solve


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closure (``pipeline/loopclose.py`` in the reference; not ported
    yet)."""

    enabled: bool = False
    keyframe_stride: int = 8  # store every Nth frame (half-res) as keyframe
    min_gap: int = 120  # loop candidates at least this many frames old
    max_dist: float = 64.0  # Hamming gate for candidate scoring + verify
    min_matches: int = 60  # mutual matches to shortlist a candidate
    min_inliers: int = 40  # RANSAC inliers to accept a verified loop
    max_keypoints: int = 512  # ORB budget per keyframe (half-res image)
    max_loops: int = 4  # strongest verified loops applied per run
    max_drift_rate: float = 0.9  # odometry-consistency gate
    sim3: bool = True  # also spread the scale drift along the span
    keyframe_budget: int = 512  # cap on stored keyframe images
    pose_graph: bool = True  # joint Sim(3) pose-graph solve for >= 2 loops
    pose_graph_max_scale: float = 2.0


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Two-view VO pipeline."""

    camera: cam.Pinhole = cam.KITTI_00
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    lm: LMConfig = LMConfig()


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Windowed BA pipeline."""

    camera: cam.Pinhole = cam.KITTI_00
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig(confidence=0.99, outlier_ratio=0.4,
                                        threshold_px=1.0)
    lm: LMConfig = dataclasses.field(
        default_factory=lambda: LMConfig(n_points=32, revert_r_norm=1e-2)
    )
    scale: ScaleConfig = ScaleConfig()
    global_ba: GlobalBAConfig = GlobalBAConfig()
    loop: LoopConfig = LoopConfig()
    window_size: int = 3  # ws
    stride: int = 2  # ws - 1: each window owns its zetas
