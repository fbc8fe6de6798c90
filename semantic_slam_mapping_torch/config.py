"""Configuration of the stereo frontend, as plain dataclasses.

A copy of the sections of ``semantic_slam_mapping_tpu/config.py`` that the
frontend reads, with the same field names and defaults, so a JAX config
converts one-to-one (``utils.convert.config_from_dict``). The port keeps
its own copy: it imports nothing of the JAX package.

The TPU knobs of :class:`SgbmConfig` (``use_pallas``, ``scan_block``,
``scan_halo``) are kept for that conversion and ignored here: the port
always runs the exact full-length SGM recurrence, which is what the Pallas
kernel runs on the TPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole stereo camera (KITTI 00-02 intrinsics by default)."""

    fx: float = 718.8560
    fy: float = 718.8560
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.532331858  # metres
    scale: float = 1000.0          # depth units per metre
    d: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    # 3D region of interest half-extents (metres)
    roix: float = 20.0
    roiy: float = 5.0
    roiz: float = 40.0

    @property
    def bf(self) -> float:
        return self.fx * self.baseline


@dataclass(frozen=True)
class SgbmConfig:
    """Semi-global matching parameters (OpenCV StereoSGBM settings)."""

    min_disparity: int = 0
    num_disparities: int = 80
    sad_window_size: int = 11
    p1: int = 8 * 11 * 11
    p2: int = 32 * 11 * 11
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    disp12_max_diff: int = 1
    pre_filter_cap: int = 63
    full_dp: bool = False          # 8 directions; not ported yet (raises)
    num_directions: int = 4
    scan_block: int = 128          # ignored: TPU blocked-scan knob
    scan_halo: int = 32            # ignored: TPU blocked-scan knob
    speckle_cc_sweeps: int = 4
    speckle_cc_jumps: int = 1
    use_pallas: bool = True        # ignored: the port always runs its kernel
    cost_dtype: str = "bfloat16"   # cost-volume dtype: bfloat16 | float32


@dataclass(frozen=True)
class GfttConfig:
    """Shi-Tomasi detector of the quad matcher."""

    max_corners: int = 500
    quality_level: float = 0.04
    min_distance: int = 8
    block_size: int = 3


@dataclass(frozen=True)
class KltConfig:
    """Pyramidal Lucas-Kanade parameters."""

    window_size: int = 11
    pyramid_levels: int = 3
    max_iterations: int = 20
    epsilon: float = 0.01
    min_eig_threshold: float = 1e-6  # OpenCV units (8-bit images)


@dataclass(frozen=True)
class QuadMatchConfig:
    """Geometric gates of circular-track filtering."""

    max_dy_stereo: float = 20.0
    max_dy_temporal: float = 30.0
    max_dx_temporal: float = 200.0
    min_disparity: float = 3.0
    loop_consistency_px: float = 1.0
    max_features: int = 512


@dataclass(frozen=True)
class VoConfig:
    """RANSAC + Gauss-Newton stereo VO parameters."""

    ransac_iters: int = 200
    inlier_threshold: float = 6.0
    gn_iters_hypothesis: int = 20
    gn_iters_refine: int = 100
    gn_step_tol: float = 1e-8
    reweighting: bool = True
    match_radius_reweight: float = 0.5


@dataclass(frozen=True)
class UVDisparityConfig:
    """U-V-disparity moving-object detector parameters."""

    min_intensity: int = 11
    min_disparity_raw: float = 3.0
    min_area: int = 20
    inlier_tolerance: int = 3
    sigmoid_alpha: float = 0.02
    sigmoid_beta: float = 32.0
    kf_process_noise: float = 1e-5
    kf_measurement_noise: float = 1e-2
    kf_error_cov_post: float = 1.0
    v_blur_ksize: int = 3
    otsu_bins: int = 256
    flood_fill_sweeps: int = 4


@dataclass(frozen=True)
class TrackerConfig:
    """Tracking state machine parameters."""

    inlier_threshold: float = 6.0
    max_lost_frames: int = 10
    ref_frames: int = 5


@dataclass(frozen=True)
class SlamConfig:
    """The frontend's part of the JAX package's ``SlamConfig``."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    sgbm: SgbmConfig = field(default_factory=SgbmConfig)
    gftt: GfttConfig = field(default_factory=GfttConfig)
    klt: KltConfig = field(default_factory=KltConfig)
    quadmatch: QuadMatchConfig = field(default_factory=QuadMatchConfig)
    vo: VoConfig = field(default_factory=VoConfig)
    uvdisparity: UVDisparityConfig = field(default_factory=UVDisparityConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)

    def replace(self, **kwargs: Any) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


def default_config() -> SlamConfig:
    return SlamConfig()
