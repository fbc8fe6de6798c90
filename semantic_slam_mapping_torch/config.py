"""Configuration of the SLAM system, as plain dataclasses.

A copy of the sections of ``semantic_slam_mapping_tpu/config.py`` that the
dataset readers, the frontend, the keyframe epoch, SegNet and the map
read, and of its multi-device section (:class:`ParallelConfig`), with the
same field names and defaults, so a JAX config converts
one-to-one (``utils.convert.config_from_dict``), and of its loader of the
reference's ``key=value`` ``parameters.txt`` (:func:`load_parameters_file`;
an unknown key warns on stderr). The port keeps its own copy: it imports
nothing of the JAX package.

The TPU knobs of :class:`SgbmConfig` (``use_pallas``, ``scan_block``,
``scan_halo``) are kept for that conversion and ignored here: the port
always runs the exact full-length SGM recurrence, which is what the Pallas
kernel runs on the TPU.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


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
class DatasetConfig:
    """Dataset paths and frame range (the reference's parameters.txt)."""

    data_source: str = ""
    gtpose_source: str = ""
    rgb_dir: str = "image_2/"
    rgb_extension: str = ".png"
    depth_dir: str = "stereo/"
    depth_extension: str = ".png"
    start_index: int = 0
    end_index: int = 100
    dataset_type: str = "kitti"  # "kitti" | "tum" | "synthetic"


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
class OrbConfig:
    """ORB extractor parameters (8-level 1.2x pyramid, FAST 20/7)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    knn_match_ratio: float = 0.8
    max_candidates_per_level: int = 4096  # unused: a TPU budget knob
    patch_size: int = 31       # rBRIEF sampling patch
    half_patch_size: int = 15  # orientation intensity-centroid radius
    edge_threshold: int = 19


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
class PnpConfig:
    """Motion-only bundle adjustment (4 rounds of 10 LM steps)."""

    min_inliers: int = 10
    min_matches: int = 15
    rounds: int = 4
    iters_per_round: int = 10
    chi2_threshold: float = 5.991     # 95% chi-square, 2 DoF
    huber_delta: float = 5.991 ** 0.5


@dataclass(frozen=True)
class TrackerConfig:
    """Tracking state machine parameters."""

    inlier_threshold: float = 6.0
    max_lost_frames: int = 10
    ref_frames: int = 5


@dataclass(frozen=True)
class PoseGraphConfig:
    """Keyframe policy, edge weights and the LM + PCG pose-graph solver.

    Nearby-keyframe edges are weighted at ``nearby_information_weight``
    (not the odometry weight), and a loop edge's information scales with
    its PnP inliers: ``information_weight * clip(inliers /
    info_full_inliers, info_min_scale, 1)^2``. Both are deliberate
    deviations of the JAX package from the C++ reference, kept here."""

    nearby_keyframes: int = 5
    keyframe_min_translation: float = 5.5
    keyframe_min_rotation: float = 2.5
    loop_accumulate_error: float = 4.0
    local_accumulate_error: float = 1.0
    local_window: int = 5             # vertices left free in local optimize
    global_iters: int = 10            # LM iterations for global optimize
    information_weight: float = 100.0
    nearby_information_weight: float = 1.0
    loop_min_inliers: int = 12
    info_from_inliers: bool = True
    info_full_inliers: float = 200.0
    info_min_scale: float = 0.04
    huber_delta: float = 1.0
    pcg_iters: int = 100
    pcg_tol: float = 1e-6             # unused: PCG runs pcg_iters steps
    max_keyframes: int = 2048         # keyframe budget


@dataclass(frozen=True)
class LooperConfig:
    """BoW loop detection: score gate, frame-gap gate and the vocabulary
    tree's shape."""

    vocab_file: str = ""
    min_sim_score: float = 0.015
    min_interval: int = 60
    branching: int = 10
    depth: int = 6
    scoring_level: int = 4
    bow_budget: int = 0               # words kept per keyframe (0: all)


@dataclass(frozen=True)
class SegNetConfig:
    """SegNet segmentation: the input size (padded up to a multiple of 32),
    12 classes, the working dtype, whether ``SlamSystem`` runs it online on
    each keyframe, the channel width multiplier (1.0: the full VGG16
    SegNet) and the path of a trained pickle (None: a seeded random
    init)."""

    input_height: int = 360
    input_width: int = 480
    num_classes: int = 12
    dtype: str = "bfloat16"
    online: bool = False
    width_mult: float = 1.0
    weights: Optional[str] = None


@dataclass(frozen=True)
class MapperConfig:
    """Dense semantic map: the voxel leaf, the depth cutoff, the rebuild
    policy (every ``full_rebuild_every``-th update a full rebuild from every
    ``full_rebuild_stride``-th keyframe, else the last
    ``incremental_window``), the motion-overlay thresholds, the semantic
    moving mask's dilation, the per-keyframe voxel budget and the pixel
    stride of the keyframe cloud."""

    resolution: float = 0.1
    max_distance: float = 40.0
    full_rebuild_every: int = 15
    full_rebuild_stride: int = 2
    incremental_window: int = 5
    motion_area_threshold: int = 1000
    motion_overlay_portion_threshold: float = 0.143
    dilate_iters: int = 2
    max_points_per_frame: int = 1 << 17
    cloud_stride: int = 2


@dataclass(frozen=True)
class ParallelConfig:
    """The mesh: the names of its data axis (frame pairs, pose-graph edges,
    BoW rows and map slabs) and model axis (SegNet's channels), and their
    sizes."""

    data_axis: str = "data"
    model_axis: str = "model"
    dp: int = 1
    tp: int = 1
    keyframe_shards: int = 1
    map_shards: int = 1


@dataclass(frozen=True)
class SlamConfig:
    """The JAX package's ``SlamConfig``."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    sgbm: SgbmConfig = field(default_factory=SgbmConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    gftt: GfttConfig = field(default_factory=GfttConfig)
    klt: KltConfig = field(default_factory=KltConfig)
    quadmatch: QuadMatchConfig = field(default_factory=QuadMatchConfig)
    vo: VoConfig = field(default_factory=VoConfig)
    uvdisparity: UVDisparityConfig = field(default_factory=UVDisparityConfig)
    pnp: PnpConfig = field(default_factory=PnpConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    looper: LooperConfig = field(default_factory=LooperConfig)
    segnet: SegNetConfig = field(default_factory=SegNetConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kwargs: Any) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


def default_config() -> SlamConfig:
    return SlamConfig()


# ---------------------------------------------------------------------------
# parameters.txt
# ---------------------------------------------------------------------------

# reference parameters.txt key -> (section, field, type)
_KEY_MAP: Dict[str, Tuple[str, str, type]] = {
    "start_index": ("dataset", "start_index", int),
    "end_index": ("dataset", "end_index", int),
    "data_source": ("dataset", "data_source", str),
    "gtpose_source": ("dataset", "gtpose_source", str),
    "rgb_dir": ("dataset", "rgb_dir", str),
    "rgb_extension": ("dataset", "rgb_extension", str),
    "depth_dir": ("dataset", "depth_dir", str),
    "depth_extension": ("dataset", "depth_extension", str),
    "camera.fx": ("camera", "fx", float),
    "camera.fy": ("camera", "fy", float),
    "camera.cx": ("camera", "cx", float),
    "camera.cy": ("camera", "cy", float),
    "camera.baseline": ("camera", "baseline", float),
    "camera.scale": ("camera", "scale", float),
    "camera.roix": ("camera", "roix", float),
    "camera.roiy": ("camera", "roiy", float),
    "camera.roiz": ("camera", "roiz", float),
    "orb_features": ("orb", "n_features", int),
    "orb_scale": ("orb", "scale_factor", float),
    "orb_levels": ("orb", "n_levels", int),
    "orb_iniThFAST": ("orb", "ini_th_fast", int),
    "orb_minThFAST": ("orb", "min_th_fast", int),
    "knn_match_ratio": ("orb", "knn_match_ratio", float),
    "pnp_min_inliers": ("pnp", "min_inliers", int),
    "pnp_min_matches": ("pnp", "min_matches", int),
    "inlier_threshold": ("tracker", "inlier_threshold", float),
    "tracker_max_lost_frame": ("tracker", "max_lost_frames", int),
    "tracker_ref_frames": ("tracker", "ref_frames", int),
    "nearby_keyframes": ("pose_graph", "nearby_keyframes", int),
    "keyframe_min_translation": ("pose_graph", "keyframe_min_translation",
                                 float),
    "keyframe_min_rotation": ("pose_graph", "keyframe_min_rotation", float),
    "loop_accumulate_error": ("pose_graph", "loop_accumulate_error", float),
    "local_accumulate_error": ("pose_graph", "local_accumulate_error",
                               float),
    "looper_vocab_file": ("looper", "vocab_file", str),
    "looper_min_sim_score": ("looper", "min_sim_score", float),
    "looper_min_interval": ("looper", "min_interval", int),
    "mapper_resolution": ("mapper", "resolution", float),
    "mapper_max_distance": ("mapper", "max_distance", float),
    "motion_area_thres": ("mapper", "motion_area_threshold", int),
    "motion_overlay_portion_thres": ("mapper",
                                     "motion_overlay_portion_threshold",
                                     float),
}

# camera.d0 .. camera.d4: the entries of the distortion tuple
_DIST_KEYS = {f"camera.d{i}": i for i in range(5)}


def parse_parameters_text(text: str) -> Dict[str, str]:
    """``key=value`` lines, split at the first '='; blank lines, lines
    starting with '#' and lines without '=' are skipped."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        out[key.strip()] = value.strip()
    return out


def load_parameters_file(path: str | Path,
                         base: Optional[SlamConfig] = None) -> SlamConfig:
    """A reference-format parameters.txt over ``base`` (the defaults)."""
    cfg = base if base is not None else default_config()
    raw = parse_parameters_text(Path(path).read_text())
    sections: Dict[str, Dict[str, Any]] = {}
    dist = list(cfg.camera.d)
    for key, value in raw.items():
        if key in _DIST_KEYS:
            dist[_DIST_KEYS[key]] = float(value)
            continue
        if key not in _KEY_MAP:
            print(f"[config] warning: unknown parameter '{key}'",
                  file=sys.stderr)
            continue
        section, attr, typ = _KEY_MAP[key]
        sections.setdefault(section, {})[attr] = typ(value)
    sections.setdefault("camera", {})["d"] = tuple(dist)
    return dataclasses.replace(cfg, **{
        section: dataclasses.replace(getattr(cfg, section), **fields)
        for section, fields in sections.items()})
