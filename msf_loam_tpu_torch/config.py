"""Configuration of the PyTorch port: features, odometry, mapping, IMU, the
pose graph, the lidar-IMU extrinsic and the host runtime.

Field names, defaults and validation follow the JAX package's config so one
set of values describes both implementations, and ``MsfLoamConfig.from_json``
/ ``from_dict`` read the same files (the native nested layout and the
reference's proto-JSON). The tri-state kernel switches
(``fused_picks``, ``fused_corr``, ``fused_select``) are kept for field
parity but IGNORED here: the port always runs its kernels (hand-written
CUDA on a CUDA tensor, the plain PyTorch version on a CPU tensor). The
dataclasses are frozen and hashable so they can key caches.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Scan registration / feature extraction."""

    max_scan_lines: int = 128
    scan_period: float = 0.1
    min_range: float = 0.3
    num_sectors: int = 6
    sharp_per_sector: int = 2
    less_sharp_per_sector: int = 20
    flat_per_sector: int = 4
    curvature_threshold: float = 0.1
    neighbor_suppress: int = 5
    neighbor_gap_sq: float = 0.05
    edge_margin: int = 5
    less_flat_leaf: float = 0.2
    less_flat_per_ring: bool = False
    occlusion_gap: float = 0.3
    parallel_frac: float = 0.02
    corner_gate_factor: float = 10.0
    max_points_per_ring: int = 2048
    max_less_flat: int = 8192
    fused_picks: str = "auto"          # ignored: the port always uses its kernel


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan matching."""

    dist_sq_threshold: float = 25.0
    nearby_scan: float = 2.5
    fused_corr: str = "auto"           # ignored: the port always uses its kernel
    outer_rounds: int = 2
    gn_iterations: int = 6
    huber_delta: float = 0.1
    min_correspondences: int = 10
    plane_corr: str = "fit"            # "fit" (5-point TLS fit), else the
                                       # reference's three-point plane
    plane_fit_tol: float = 0.2
    plane_support_extra: int = 4
    corr_max_resid: float = 0.75
    corr_gate_relax: float = 2.0
    # reproject the mapping / insert clouds to scan start with the
    # in-frame odometry step (constant velocity); translation only on the
    # pre-initialisation LIO frames; the first frame is not inserted
    motion_deskew: bool = False
    # in-matcher deskew: the reference clouds reproject once with the warm
    # start, the query clouds every round with the live estimate
    deskew: bool = False
    scan_period: float = 0.1           # must equal FeatureConfig.scan_period


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map matching and map maintenance."""

    line_resolution: float = 0.2
    plane_resolution: float = 0.4
    knn: int = 5
    knn_dist_sq_max: float = 1.0
    plane_fallback: bool = True
    knn_wide: int = 16
    reuse_candidates: bool = True      # False: query the maps every round
    fused_select: str = "auto"         # ignored: the port always uses its kernel
    gather_two_level: str = "off"
    gather_u_max: int = 4096
    gather_grouped: str = "auto"       # the port always uses the grouped gather
    gather_groups: int = 1024
    line_eig_ratio: float = 3.0
    plane_fit_tol: float = 0.2
    outer_rounds: int = 2
    gn_iterations: int = 6
    huber_delta: float = 0.1
    min_map_corner: int = 10
    min_map_surf: int = 50
    query_radius: float = 60.0
    map_cell_size: float = 2.0
    map_table_size: int = 1 << 15
    map_cell_capacity: int = 32
    max_query_points: int = 4096
    max_corner_query_points: int = 0
    map_evict_radius: float = 100.0
    map_evict_period: int = 10

    @property
    def corner_query_points(self) -> int:
        """Effective corner query budget (0 shares max_query_points)."""
        return self.max_corner_query_points or self.max_query_points


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """IMU noise, preintegration, estimator and tight coupling."""

    acc_n: float = 0.017
    acc_w: float = 0.007
    gyr_n: float = 0.0033
    gyr_w: float = 0.0012
    update_rate: float = 400.0
    preint_mode: str = "assoc"         # "assoc" (log-depth scans) or "scan"
    gravity: Tuple[float, float, float] = (0.0, 0.0, 9.81)
    warmup_msgs: int = 100             # IMU samples before the IMU is used
    init_frames: int = 50              # mapped frames of the gravity init
    init_reject_frac: float = 0.15     # worst residual blocks dropped
    max_lidar_imu_offset: float = 0.01
    sqrt_info_scale: float = 0.001
    max_imu_samples: int = 64          # static preintegration window length
    imu_factor_weight: float = 10.0    # IMU factor weight in the tight GN
    tight_coupling: bool = False       # IMU factor in the GN, velocity free
    grav_refine_period: int = 10       # 0 = gravity frozen after init
    bias_period: int = 10              # frames between bias solves (0 = off)
    bias_window: int = 10              # pairs per bias solve
    bias_prior_acc_sigma: float = 0.1
    bias_prior_gyr_sigma: float = 0.05
    bias_vel_prior_sigma: float = 0.5
    bias_max_acc: float = 0.5
    bias_max_gyr: float = 0.05
    bias_ema: float = 0.5


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """GPS / loop-closure pose graph (gps_fusion.cc)."""

    gps_sigma_t: float = 0.01          # GpsFactor st
    rel_sigma_r: float = 0.01          # RelativePoseFactor sr
    rel_sigma_t: float = 0.1           # RelativePoseFactor st
    huber_delta: float = 1.0           # HuberLoss(1.0)
    iterations: int = 10               # max_num_iterations
    sim_gps_period: int = 10           # every 10th ground-truth pose -> 1 Hz
    sim_gps_noise: float = 0.05        # U(-5, 5) cm
    loop_max_dist: float = 3.0         # proximity radius for candidates (m)
    loop_min_index_gap: int = 20       # frames between revisit candidates
    loop_max_count: int = 8            # static padding for LoopFactors
    loop_keyframe_stride: int = 5      # keep features every K frames
    loop_sc_max_dist: float = 0.25     # scan-context cosine-distance gate


@dataclasses.dataclass(frozen=True)
class ExtrinsicConfig:
    """Lidar-to-IMU extrinsic and hand-eye calibration."""

    lidar2imu_t: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lidar2imu_q: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    calib_window: int = 10
    calib_sigma_gate: float = 0.25
    calib_huber_deg: float = 5.0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host pipeline and execution knobs."""

    offline_mode: bool = True
    drop_backlog: bool = False
    save_map: bool = True
    map_output: str = "msf_loam_cloud.ply"
    trajectory_output: str = "trajectory.npz"
    dtype: str = "float32"
    profile: bool = False


def _field(raw: dict, camel: str, snake: str, default):
    """A proto-JSON field under its camelCase or snake_case name."""
    return raw.get(camel, raw.get(snake, default))


@dataclasses.dataclass(frozen=True)
class MsfLoamConfig:
    """Top-level config of the port."""

    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    posegraph: PoseGraphConfig = dataclasses.field(
        default_factory=PoseGraphConfig)
    extrinsic: ExtrinsicConfig = dataclasses.field(
        default_factory=ExtrinsicConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Reject configs that would silently produce wrong answers."""
        mc = self.mapping
        r_complete_sq = (mc.map_cell_size / 2.0) ** 2
        if mc.knn_dist_sq_max > r_complete_sq + 1e-9:
            raise ValueError(
                f"mapping.knn_dist_sq_max={mc.knn_dist_sq_max} exceeds the "
                f"8-cell query completeness bound (map_cell_size/2)^2="
                f"{r_complete_sq}: queries would silently return incomplete "
                f"neighbor sets. Raise map_cell_size or lower the gate.")
        if mc.map_table_size <= 0 or mc.map_cell_capacity <= 0:
            raise ValueError("mapping.map_table_size and map_cell_capacity "
                             "must be positive")
        if mc.max_query_points < mc.knn:
            raise ValueError(
                f"mapping.max_query_points={mc.max_query_points} is below "
                f"knn={mc.knn}; the static query budget cannot hold one "
                f"correspondence set")
        if mc.max_corner_query_points < 0 or \
                0 < mc.max_corner_query_points < mc.knn:
            raise ValueError(
                f"mapping.max_corner_query_points="
                f"{mc.max_corner_query_points} must be 0 (share "
                f"max_query_points) or >= knn={mc.knn}")
        if mc.knn < 2:
            raise ValueError("mapping.knn must be >= 2 (line/plane fits "
                             "need multiple neighbors)")
        fc = self.features
        if fc.sharp_per_sector > fc.less_sharp_per_sector:
            raise ValueError("features.sharp_per_sector cannot exceed "
                             "less_sharp_per_sector (sharp picks are a "
                             "prefix of the less-sharp set)")
        oc = self.odometry
        if oc.deskew and abs(oc.scan_period - fc.scan_period) > 1e-9:
            raise ValueError(
                f"odometry.scan_period={oc.scan_period} != "
                f"features.scan_period={fc.scan_period}: the in-matcher "
                f"deskew would mis-scale every point's rel_time fraction")
        if self.imu.preint_mode not in ("assoc", "scan"):
            raise ValueError(f"imu.preint_mode={self.imu.preint_mode!r} must "
                             f"be 'assoc' or 'scan'")

    @staticmethod
    def from_json(path: str) -> "MsfLoamConfig":
        """A config from a JSON file in the native nested layout or the
        reference's proto-JSON schema."""
        with open(path) as f:
            return MsfLoamConfig.from_dict(json.load(f))

    @staticmethod
    def from_dict(raw: dict) -> "MsfLoamConfig":
        """A config from a dict: the reference's proto-JSON (IMU intrinsics,
        gravity, lidar-to-IMU extrinsic, ``savePointcloudMap``; camelCase or
        snake_case) when it holds ``imuIntrinsicParameters``, else the native
        layout ``{"features": {...}, "odometry": {...}, ...}`` (lists become
        tuples; absent sections and fields keep their defaults)."""
        cfg = MsfLoamConfig()
        if "imuIntrinsicParameters" in raw or \
                "imu_intrinsic_parameters" in raw:
            imu_raw = _field(raw, "imuIntrinsicParameters",
                             "imu_intrinsic_parameters", {})
            g_raw = _field(raw, "gravityVector", "gravity_vector", {})
            ext_raw = _field(raw, "lidar2imuExtrinsicParameters",
                             "lidar2imu_extrinsic_parameters", {})
            ic = cfg.imu
            imu = dataclasses.replace(
                ic,
                acc_n=float(_field(imu_raw, "accelerometerNoiseDensity",
                                   "accelerometer_noise_density", ic.acc_n)),
                acc_w=float(_field(imu_raw, "accelerometerRandomWalk",
                                   "accelerometer_random_walk", ic.acc_w)),
                gyr_n=float(_field(imu_raw, "gyroscopeNoiseDensity",
                                   "gyroscope_noise_density", ic.gyr_n)),
                gyr_w=float(_field(imu_raw, "gyroscopeRandomWalk",
                                   "gyroscope_random_walk", ic.gyr_w)),
                update_rate=float(_field(imu_raw, "updateRate", "update_rate",
                                         ic.update_rate)),
                gravity=(float(g_raw.get("x", 0.0)),
                         float(g_raw.get("y", 0.0)),
                         float(g_raw.get("z", 9.81))))
            t_raw = ext_raw.get("translation", {})
            q_raw = ext_raw.get("rotation", {})
            ext = dataclasses.replace(
                cfg.extrinsic,
                lidar2imu_t=tuple(float(t_raw.get(k, 0.0)) for k in "xyz"),
                lidar2imu_q=(float(q_raw.get("w", 1.0)),) + tuple(
                    float(q_raw.get(k, 0.0)) for k in "xyz"))
            runtime = dataclasses.replace(
                cfg.runtime, save_map=bool(_field(
                    raw, "savePointcloudMap", "save_pointcloud_map",
                    cfg.runtime.save_map)))
            return dataclasses.replace(cfg, imu=imu, extrinsic=ext,
                                       runtime=runtime)

        sections = {}
        for field in dataclasses.fields(MsfLoamConfig):
            if field.name in raw:
                sub = {k: tuple(v) if isinstance(v, list) else v
                       for k, v in raw[field.name].items()}
                sections[field.name] = dataclasses.replace(
                    field.default_factory(), **sub)
        return dataclasses.replace(cfg, **sections)
