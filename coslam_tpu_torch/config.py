"""Typed configuration for the whole engine.

Replaces the reference's three scattered cv::FileStorage YAML reads
(reference: ORB_SLAM2/src/Tracking.cc:60-150, MapDrawer.cc:31-42,
Viewer.cc:29-52) with one frozen dataclass tree.  Defaults reproduce the
canonical config shipped with the reference (`ORB_SLAM2/my.yaml`): fx=715.09,
1000 features, 8 pyramid levels x1.2, FAST thresholds 20/7.

A field-for-field copy of `coslam_tpu/config.py`, so that one config value
describes the same system to both packages (tests/test_torch_config.py holds
the two equal).  Everything is a frozen, hashable value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics + radial-tangential distortion.

    Mirrors the `Camera.*` YAML block parsed at reference Tracking.cc:60-104.
    """

    fx: float = 715.0907
    fy: float = 713.1426
    cx: float = 606.8999
    cy: float = 370.3716
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 1226
    height: int = 740
    fps: float = 30.0
    # Stereo baseline times fx ("Camera.bf"), and depth threshold factor
    # (reference Tracking.cc:105-117).
    bf: float = 0.0
    depth_th_factor: float = 35.0  # mThDepth = bf * f / fx ratio gate
    rgb_order: bool = True

    @property
    def K(self) -> Tuple[Tuple[float, ...], ...]:
        return ((self.fx, 0.0, self.cx), (0.0, self.fy, self.cy), (0.0, 0.0, 1.0))

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclass(frozen=True)
class ExtractorConfig:
    """ORB extractor settings (reference ORBextractor.cc:410-470, my.yaml:29-42).

    `max_keypoints` is the fixed output capacity per frame: the TPU build uses
    static shapes with validity masks instead of variable-length vectors.
    """

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: int = 20       # iniThFAST (my.yaml:40)
    fast_min_threshold: int = 7    # minThFAST (my.yaml:42)
    cell_size: int = 32            # detection cell (reference uses 30-px cells,
                                   # ORBextractor.cc:769; 32 aligns to TPU lanes)
    max_keypoints: int = 1024      # static capacity (>= n_features)
    patch_size: int = 31           # IC-angle / BRIEF patch (ORBextractor.cc:72)
    edge_threshold: int = 19       # border margin (ORBextractor.cc:74)

    @property
    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    @property
    def level_sigma2(self) -> Tuple[float, ...]:
        return tuple(s * s for s in self.scale_factors)


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor-matching thresholds (reference ORBmatcher.cc:37-39)."""

    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30
    nn_ratio: float = 0.9
    check_orientation: bool = True
    search_radius_motion: float = 15.0  # ORBmatcher.cc SearchByProjection r
    max_matches: int = 1024             # static match capacity


@dataclass(frozen=True)
class TrackerConfig:
    """Tracking front-end policy (reference Tracking.cc)."""

    # Monocular initialization (Tracking.cc:565-637)
    init_min_keypoints: int = 100
    init_min_matches: int = 100
    init_min_good: int = 50        # floor on triangulated inliers (Initializer.cc)
    ransac_iters: int = 200            # Initializer.cc:33
    ransac_sigma: float = 1.0
    # Keyframe policy (Tracking.cc:979-1063)
    min_frames: int = 0
    max_frames: int = 30               # = fps (Tracking.cc:87)
    ref_ratio_mono: float = 0.9
    # Monocular insertion in the reference happens ONLY when LocalMapping
    # is idle (Tracking.cc:1041-1059: busy mapper -> InterruptBA + refuse
    # for mono) — its real keyframe throttle is the mapper's cycle time
    # (~2-4 frames at a real camera's 20-30 fps).  The TPU backend is
    # dispatch-synchronous (always "idle"), so the throttle is modeled
    # explicitly: a mono keyframe may only be flagged >= this many frames
    # after the last one.  0 = no throttle (synthetic test scenes compress
    # whole sweeps into tens of frames, where per-frame motion is many real
    # frames' worth and a fixed gap would starve the map); -1 = AUTO — the
    # System MEASURES its backend_insert wall cost and converts it to
    # frames at the camera rate (System._mapper_latency), which is the
    # reference's actual insert-when-idle semantics.  Positive values are
    # explicit overrides.
    mapper_latency_frames: int = 0
    min_inliers_track: int = 30        # TrackLocalMap gate (Tracking.cc:969-973)
    min_inliers_reloc: int = 50
    min_matches_motion: int = 20       # TrackWithMotionModel gate
    min_matches_ref: int = 15          # TrackReferenceKeyFrame gate
    # Pose optimization (Optimizer.cc:239-451): 4 rounds x 10 LM iterations
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    # Steady-state chunk size: frames tracked per device dispatch by
    # System.run_sequence / tracking.track_chunk (the TPU analogue of the
    # reference's tracker/mapper thread asynchrony — the mapper may lag the
    # tracker by up to this many frames)
    chunk_frames: int = 8
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815


@dataclass(frozen=True)
class MapperConfig:
    """Local-mapping policy (reference LocalMapping.cc)."""

    triangulation_neighbors: int = 20   # nn for mono (LocalMapping.cc:210-212)
    min_parallax_cos: float = 0.9998    # LocalMapping.cc:319
    culling_found_ratio: float = 0.25   # MapPointCulling (LocalMapping.cc:170)
    culling_min_obs: int = 3
    kf_culling_redundancy: float = 0.9  # KeyFrameCulling (LocalMapping.cc:693)
    local_ba_iters1: int = 5            # Optimizer.cc:453 (5 then 10)
    local_ba_iters2: int = 10
    covis_edge_threshold: int = 15      # KeyFrame.cc:330
    ba_window: int = 24                 # gathered local-BA window size (free
                                        # covisible KFs + fixed anchors) —
                                        # keeps local BA problem-shaped
    ba_local_points: int = 4096         # compact point capacity of the
                                        # windowed local BA (solve_dense_
                                        # compact) — per-iteration tensors
                                        # scale with this, not map capacity
    # Static capacities of the SoA map
    max_keyframes: int = 256
    max_points: int = 32768
    max_obs_per_point: int = 16
    covis_top_k: int = 32


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing policy (reference LoopClosing.cc)."""

    min_kfs_between_loops: int = 10    # LoopClosing.cc:114
    covis_consistency_th: int = 3      # LoopClosing.cc:43
    sim3_min_bow_matches: int = 20     # LoopClosing.cc:267
    sim3_ransac_iters: int = 300       # LoopClosing.cc:275 (0.99, 20, 300)
    sim3_min_inliers: int = 20
    sim3_min_total_matches: int = 40
    sim3_max_scale: float = 4.0        # sanity bound on an accepted loop
                                       # Sim3's scale (mono drift is a few
                                       # percent per loop; a degenerate
                                       # RANSAC fit can "verify" with an
                                       # absurd scale and destroy the map)
    essential_graph_iters: int = 20    # Optimizer.cc:781 (20 its)
    essential_graph_covis_w: int = 100 # Optimizer.cc edge weight gate
    # sparse essential graph (the reference's edge set is O(K): spanning
    # tree + strong covisibility + loop edges, Optimizer.cc:869-980; the
    # dense all-pairs formulation walls at K ~ 2000)
    sparse_essential_graph: bool = True
    essential_graph_top_k: int = 12    # strong-covis neighbors kept per KF
    essential_graph_pcg_iters: int = 64
    global_ba_iters: int = 10          # LoopClosing.cc:650
    vocab_branching: int = 10          # DBoW2-style tree: k
    vocab_depth: int = 3               # levels (k^d words); small tree, dense arrays
    vocab_words: int = 2048            # flat vocabulary size (overrides k^d;
                                       # reference ships 1M tree words,
                                       # ORBvoc.txt — flat 4k trained on the
                                       # deployment domain is the TPU analog)
    vocab_pretrained: bool = True      # load assets/vocab.npz at startup
                                       # (the reference's ORBvoc.txt load,
                                       # System.cc:61-72); falls back to the
                                       # online-trained path when absent
    vocab_retrain_at: Tuple[int, ...] = (4, 16, 64)  # online re-train points
                                       # (only without a pretrained vocab)
    max_loop_edges: int = 16           # accumulated loop-edge capacity fed to
                                       # every essential-graph solve
    brute_force_shortlist: bool = False  # fall back to all-pairs landmark
                                         # match counts (O(K N^2)) instead of
                                         # BoW-gated candidates
    db_min_score_ratio: float = 0.75   # KeyFrameDatabase.cc group gate
    db_min_words_ratio: float = 0.8


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for distributed stages.

    axes: 'agent' shards cooperative agents (reference: 2 LCM-linked
    processes, SURVEY 2.5 P5); 'ba' shards BA point blocks / reduced camera
    system (SURVEY 2.5 P4).
    """

    n_agents: int = 1
    ba_shards: int = 1


@dataclass(frozen=True)
class SystemConfig:
    """Top-level config — the analogue of (vocabulary, settings, sensor)
    passed to reference System ctor (System.cc:32)."""

    camera: CameraConfig = CameraConfig()
    extractor: ExtractorConfig = ExtractorConfig()
    matcher: MatcherConfig = MatcherConfig()
    tracker: TrackerConfig = TrackerConfig()
    mapper: MapperConfig = MapperConfig()
    loop: LoopConfig = LoopConfig()
    mesh: MeshConfig = MeshConfig()
    sensor: str = "mono"  # mono | stereo | rgbd

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def tum_fr1_config(**overrides) -> SystemConfig:
    """TUM fr1 camera (freiburg1 intrinsics, 640x480)."""
    cam = CameraConfig(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=640, height=480, fps=30.0,
    )
    return SystemConfig(camera=cam,
                        tracker=TrackerConfig(mapper_latency_frames=-1)
                        ).replace(**overrides)


def euroc_config(**overrides) -> SystemConfig:
    """EuRoC MAV cam0 (752x480)."""
    cam = CameraConfig(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
        width=752, height=480, fps=20.0,
    )
    return SystemConfig(camera=cam,
                        tracker=TrackerConfig(mapper_latency_frames=-1)
                        ).replace(**overrides)


def kitti_config(**overrides) -> SystemConfig:
    """KITTI odometry sequence 00-02 (1241x376, stereo bf=386.1448)."""
    cam = CameraConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        width=1241, height=376, fps=10.0, bf=386.1448,
    )
    return SystemConfig(camera=cam, sensor="stereo").replace(**overrides)
