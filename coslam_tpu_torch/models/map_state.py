"""Fixed-capacity SoA map state (port of coslam_tpu/models/map_state.py,
whole: `MapState`, `empty_map`, `kf_centers`, `observation_coo`, the
covisibility functions and `point_obs_count`).

The whole map is a NamedTuple of tensors with validity masks; descriptors
are int32 tensors holding the reference's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


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


def empty_map(cfg: SystemConfig, device=DEFAULT_DEVICE) -> MapState:
    K = cfg.mapper.max_keyframes
    N = cfg.extractor.max_keypoints
    P = cfg.mapper.max_points
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=resolve_device(device))
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


def kf_centers(m: MapState) -> torch.Tensor:
    """(K, 3) camera centers C = -R^T t."""
    R = m.kf_pose[:, :3, :3]
    t = m.kf_pose[:, :3, 3]
    return -torch.einsum("kji,kj->ki", R, t)


def observation_coo(m: MapState):
    """Flatten the (K, N) association table into BA-ready COO arrays.

    Returns (obs_kf, obs_pt, obs_uv, obs_level, obs_valid) with O = K*N;
    obs_pt is clamped to a valid slot (masked by obs_valid)."""
    K, N = m.kf_obs_pt.shape
    obs_kf = torch.arange(K, dtype=torch.int32,
                          device=m.kf_obs_pt.device).repeat_interleave(N)
    obs_pt = m.kf_obs_pt.reshape(-1)
    obs_valid = (m.kf_valid[:, None] & m.kf_kp_valid
                 & (m.kf_obs_pt >= 0)).reshape(-1)
    safe_pt = torch.clamp(obs_pt, min=0)
    obs_valid = obs_valid & m.pt_valid[safe_pt.long()]
    return (obs_kf, safe_pt, m.kf_uv.reshape(-1, 2), m.kf_level.reshape(-1),
            obs_valid)


def _obs_indicator(m: MapState) -> torch.Tensor:
    """(K, P) f32 0/1: keyframe k observes valid point p."""
    K, N = m.kf_obs_pt.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    pt = torch.clamp(m.kf_obs_pt, min=0).long()
    ok = (m.kf_kp_valid & (m.kf_obs_pt >= 0) & m.kf_valid[:, None]
          & m.pt_valid[pt])
    flat = (torch.arange(K, device=dev)[:, None] * P + pt).reshape(-1)
    ind = torch.zeros(K * P, dtype=torch.float32, device=dev)
    ind.scatter_reduce_(0, flat, ok.reshape(-1).to(torch.float32), "amax",
                        include_self=True)
    return ind.reshape(K, P)


def covisibility(m: MapState) -> torch.Tensor:
    """(K, K) shared-map-point counts (reference KeyFrame::UpdateConnections,
    KeyFrame.cc:289-340) as one matmul of the (K, P) observation indicator;
    diagonal zeroed."""
    ind = _obs_indicator(m)
    w = ind @ ind.T
    return (w - torch.diag(torch.diag(w))).to(torch.int32)


def covisibility_row(m: MapState, k) -> torch.Tensor:
    """(K,) shared-point counts of keyframe `k` (an int or a 0-d device
    tensor) against every keyframe: one (K, P) x (P,) matvec."""
    ind = _obs_indicator(m)
    K = ind.shape[0]
    kk = torch.as_tensor(k, device=ind.device).reshape(1).long()
    w = ind @ ind.index_select(0, kk)[0]
    own = torch.arange(K, device=ind.device) == kk
    return torch.where(own, 0.0, w).to(torch.int32)


def covisibility_rows(m: MapState, ks: torch.Tensor) -> torch.Tensor:
    """(C, K) shared-point counts for a subset `ks` of keyframes."""
    ind = _obs_indicator(m)
    K = ind.shape[0]
    ks = ks.long()
    w = ind.index_select(0, ks) @ ind.T
    own = ks[:, None] == torch.arange(K, device=ind.device)[None, :]
    return torch.where(own, 0.0, w).to(torch.int32)


def scatter_set(base: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """base.at[idx].set(vals) with the reference's rule for duplicate
    targets: the LAST source wins (XLA's scatter applies updates in order).
    `index_put_` on CUDA keeps an arbitrary one, so the winner is chosen
    first — the highest source index per target, by scatter_reduce("amax")
    — and gathered.  idx may hold len(base) for "drop"."""
    L = base.shape[0]
    idx = idx.long()
    src = torch.arange(idx.shape[0], device=idx.device)
    win = torch.full((L + 1,), -1, dtype=torch.int64, device=idx.device)
    win = win.scatter_reduce(0, idx, src, "amax", include_self=True)[:L]
    has = win >= 0
    picked = vals[torch.clamp(win, min=0)]
    return torch.where(has.reshape((L,) + (1,) * (base.dim() - 1)), picked,
                       base)
