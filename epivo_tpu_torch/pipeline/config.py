"""Pipeline configuration dataclasses (port of
``epivo_tpu/pipeline/config.py``: the two-view VO configs only).

Field names and defaults match the reference, so
:func:`epivo_tpu_torch.convert.config_from_reference` can copy them one by
one. ``ScaleConfig`` and ``BAConfig`` come with the BA port.
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
    # ORB path fields (vo_step_orb, not ported yet); kept so configs
    # convert field for field.
    orb_pyramid: bool = False
    orb_levels: int = 8
    orb_scale_factor: float = 1.2
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


@dataclasses.dataclass(frozen=True)
class LMConfig:
    lambda0: float = 1e-2
    epsilon: float = 1e-8
    max_iters: int = 30
    huber_delta: float = 1e-5
    n_points: int = 48  # LM point budget
    # Minimum valid points to accept a refinement.
    min_points: int = 12
    # Revert to the E-pose above this final residual norm (f32 calibrated).
    revert_r_norm: float = 1e-4


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Two-view VO pipeline."""

    camera: cam.Pinhole = cam.KITTI_00
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    lm: LMConfig = LMConfig()
