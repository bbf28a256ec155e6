"""The frame's settings: a frozen copy of the feature, odometry and
mapping sections of the port's ``config.py`` (names and defaults), read
from a configuration's ``slam`` object in the native nested layout."""

from __future__ import annotations

import dataclasses
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
class FrameConfig:
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(
        default_factory=OdometryConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)

    @staticmethod
    def from_dict(raw: dict) -> "FrameConfig":
        """Sections and fields that are absent keep their defaults; a
        section this copy does not hold is refused."""
        sections = {}
        for name, sub in raw.items():
            field = {f.name: f for f in dataclasses.fields(FrameConfig)}.get(
                name)
            if field is None:
                raise ValueError(f"the reference frame has no {name!r} "
                                 f"settings")
            sections[name] = dataclasses.replace(
                field.default_factory(),
                **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in sub.items()})
        return dataclasses.replace(FrameConfig(), **sections)
