"""Fixed-capacity SoA map state (port of coslam_tpu/models/map_state.py:
`MapState`, `empty_map`, `point_obs_count`).

The whole map is a NamedTuple of tensors with validity masks; descriptors
are int32 tensors holding the reference's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.config import SystemConfig


class MapState(NamedTuple):
    # --- keyframes (capacity K, keypoint capacity N) ---
    kf_pose: torch.Tensor      # (K, 4, 4) f32, Tcw
    kf_valid: torch.Tensor     # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) i32
    kf_uv: torch.Tensor        # (K, N, 2) f32 undistorted keypoint coords
    kf_level: torch.Tensor     # (K, N) i32
    kf_angle: torch.Tensor     # (K, N) f32
    kf_desc: torch.Tensor      # (K, N, 8) i32 (uint32 bits)
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_obs_pt: torch.Tensor    # (K, N) i32 — map-point id per keypoint, -1 none
    # --- map points (capacity P) ---
    pt_pos: torch.Tensor       # (P, 3) f32 world
    pt_valid: torch.Tensor     # (P,) bool
    pt_desc: torch.Tensor      # (P, 8) i32 (uint32 bits)
    pt_normal: torch.Tensor    # (P, 3) f32 mean viewing direction
    pt_max_dist: torch.Tensor  # (P,) f32 scale-invariance range
    pt_ref_kf: torch.Tensor    # (P,) i32 creating keyframe
    pt_first_kf: torch.Tensor  # (P,) i32
    pt_visible: torch.Tensor   # (P,) i32 frustum-visible count
    pt_found: torch.Tensor     # (P,) i32 matched-by-tracking count
    # --- counters ---
    n_kf: torch.Tensor         # () i32 next free keyframe slot
    n_pt: torch.Tensor         # () i32 next free point slot


def empty_map(cfg: SystemConfig, device="cpu") -> MapState:
    K = cfg.mapper.max_keyframes
    N = cfg.extractor.max_keypoints
    P = cfg.mapper.max_points
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device)
    return MapState(
        kf_pose=torch.eye(4, dtype=f32, **kw).repeat(K, 1, 1),
        kf_valid=torch.zeros(K, dtype=torch.bool, **kw),
        kf_frame_id=torch.full((K,), -1, dtype=i32, **kw),
        kf_uv=torch.zeros((K, N, 2), dtype=f32, **kw),
        kf_level=torch.zeros((K, N), dtype=i32, **kw),
        kf_angle=torch.zeros((K, N), dtype=f32, **kw),
        kf_desc=torch.zeros((K, N, 8), dtype=i32, **kw),
        kf_kp_valid=torch.zeros((K, N), dtype=torch.bool, **kw),
        kf_obs_pt=torch.full((K, N), -1, dtype=i32, **kw),
        pt_pos=torch.zeros((P, 3), dtype=f32, **kw),
        pt_valid=torch.zeros(P, dtype=torch.bool, **kw),
        pt_desc=torch.zeros((P, 8), dtype=i32, **kw),
        pt_normal=torch.zeros((P, 3), dtype=f32, **kw),
        pt_max_dist=torch.zeros(P, dtype=f32, **kw),
        pt_ref_kf=torch.full((P,), -1, dtype=i32, **kw),
        pt_first_kf=torch.full((P,), -1, dtype=i32, **kw),
        pt_visible=torch.zeros(P, dtype=i32, **kw),
        pt_found=torch.zeros(P, dtype=i32, **kw),
        n_kf=torch.tensor(0, dtype=i32, **kw),
        n_pt=torch.tensor(0, dtype=i32, **kw),
    )


def point_obs_count(m: MapState) -> torch.Tensor:
    """(P,) number of keyframes observing each point."""
    P = m.pt_pos.shape[0]
    ok = m.kf_kp_valid & (m.kf_obs_pt >= 0) & m.kf_valid[:, None]
    pt = torch.clamp(m.kf_obs_pt, min=0).reshape(-1).long()
    out = torch.zeros(P, dtype=torch.int32, device=m.pt_pos.device)
    return out.index_add_(0, pt, ok.reshape(-1).to(torch.int32))
