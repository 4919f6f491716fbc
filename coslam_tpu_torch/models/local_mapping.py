"""Local mapping stages: keyframe insertion, new-point triangulation,
fusion, point-geometry refresh, culling, windowed local BA (port of
coslam_tpu/models/local_mapping.py up to `backend_insert`).

The reference LocalMapping thread (ORB_SLAM2/src/LocalMapping.cc):
ProcessNewKeyFrame (:128), CreateNewMapPoints (:207), SearchInNeighbors
(:454), MapPointCulling (:170), local BA (Optimizer.cc:453) and
KeyFrameCulling (:632), each a pure MapState -> MapState function on
tensors.  Keyframe slots and neighbour indices stay on the device (0-d
tensors), so the backend never reads a value back to the host.

Where the reference's scatters can receive two sources for one slot, the
later source wins, as in XLA (`map_state.scatter_set`); the neighbour
fuse's `lax.scan` is a Python loop in which each neighbour sees the map the
previous one left.  Stereo / RGB-D keyframes add landmarks straight from
sensor depth (`add_depth_points`).  `backend_post_insert` waits for
cooperative mapping (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from typing import Tuple

import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import loop_closing as lc
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.models.frame import Frame
from coslam_tpu_torch.models.tracking import _const
from coslam_tpu_torch.ops import bow, hamming, matching
from coslam_tpu_torch.optim import ba
from coslam_tpu_torch.utils import camera as cam_mod
from coslam_tpu_torch.utils import geometry as geo

INF = matching.INF


def _n_neighbors(cfg: SystemConfig) -> int:
    """Covisible neighbor pairs per insertion — the reference's nn=20 mono
    (LocalMapping.cc:210-212), clamped to the keyframe capacity."""
    return max(1, min(cfg.mapper.triangulation_neighbors,
                      cfg.mapper.max_keyframes - 1))


def _table(values, device: torch.device) -> torch.Tensor:
    """A float32 constant (per-octave table, camera matrix) on `device`,
    built once (tracking._const)."""
    return _const(values, torch.float32, device)


def _row(table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """table[k] for a 0-d device index, without a host sync."""
    return table.index_select(0, k.reshape(1).long())[0]


def _set_row(table: torch.Tensor, k: torch.Tensor, value) -> torch.Tensor:
    """table.at[k].set(value) for a 0-d device index (out of place).  A
    Python value is filled on the device (a host tensor would be a blocking
    copy)."""
    row = (1,) + table.shape[1:]
    if isinstance(value, torch.Tensor):
        value = value.to(table.dtype).expand(row[1:])[None]
    else:
        value = torch.full(row, value, dtype=table.dtype, device=table.device)
    return table.index_copy(0, k.reshape(1).long(), value)


def _centers(T: torch.Tensor) -> torch.Tensor:
    """Camera centre(s) C = -R^T t of (..., 4, 4) poses."""
    return -torch.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, with jnp.nanmedian's
    definition: the mean of the two middle values when the count is even
    (torch.nanmedian returns the lower one), NaN when all are NaN."""
    srt = torch.sort(torch.where(torch.isnan(x), float("inf"), x),
                     dim=-1).values
    cnt = (~torch.isnan(x)).sum(-1, keepdim=True)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0, max=x.shape[-1] - 1)
    lo = torch.clamp(lo, max=x.shape[-1] - 1)
    med = (srt.gather(-1, lo) + srt.gather(-1, hi)) * 0.5
    return torch.where(cnt > 0, med, float("nan"))[..., 0]


# ---------------------------------------------------------------------------
# Insertion and triangulation
# ---------------------------------------------------------------------------

def insert_keyframe(cfg: SystemConfig, m: ms.MapState, frame: Frame,
                    T, frame_id, kp_pt) -> Tuple[ms.MapState, torch.Tensor]:
    """Write the frame into the next keyframe slot with its tracked
    associations (reference Tracking::CreateNewKeyFrame, Tracking.cc:1065 +
    LocalMapping::ProcessNewKeyFrame, LocalMapping.cc:128).  Returns
    (map, k) with k the slot as a 0-d device tensor."""
    k = m.n_kf
    safe_pt = torch.clamp(kp_pt, min=0).long()
    assoc = (kp_pt >= 0) & frame.valid & m.pt_valid[safe_pt]
    m = m._replace(
        kf_pose=_set_row(m.kf_pose, k, T),
        kf_valid=_set_row(m.kf_valid, k, True),
        kf_frame_id=_set_row(m.kf_frame_id, k, frame_id),
        kf_uv=_set_row(m.kf_uv, k, frame.uv),
        kf_level=_set_row(m.kf_level, k, frame.level),
        kf_angle=_set_row(m.kf_angle, k, frame.angle),
        kf_desc=_set_row(m.kf_desc, k, frame.desc),
        kf_kp_valid=_set_row(m.kf_kp_valid, k, frame.valid),
        kf_obs_pt=_set_row(m.kf_obs_pt, k, torch.where(assoc, kp_pt, -1)),
        n_kf=m.n_kf + 1,
    )
    return m, k


def _fundamental_12(cam, T1, T2):
    """F12 with x2^T F12 x1 = 0 for pixel coords (reference
    LocalMapping::ComputeF12, LocalMapping.cc:536); T2 may be batched."""
    K = _table(cam.K, T1.device)
    T21 = T2 @ geo.se3_inverse(T1)
    R, t = T21[..., :3, :3], T21[..., :3, 3]
    E = geo.hat(t) @ R
    Kinv = torch.linalg.inv(K)
    return Kinv.T @ E @ Kinv


def _triangulate_pair(cam, T1, T2, uv1, uv2):
    """Two-view DLT (reference LocalMapping.cc:339-345) solved
    inhomogeneously: A[:, :3] X = -A[:, 3] through its 3x3 normal
    equations.  T2 / uv2 may carry a leading batch dimension."""
    K = _table(cam.K, T1.device)
    P1 = K @ T1[:3, :]
    P2 = K @ T2[..., :3, :]

    def rows(P, uv):
        return torch.stack([uv[..., 0, None] * P[..., None, 2, :]
                            - P[..., None, 0, :],
                            uv[..., 1, None] * P[..., None, 2, :]
                            - P[..., None, 1, :]], -2)

    r1 = rows(P1, uv1)                                # (N, 2, 4)
    r2 = rows(P2, uv2)                                # (..., N, 2, 4)
    A = torch.cat([r1.expand(r2.shape), r2], -2)      # (..., N, 4, 4)
    A3 = A[..., :3]
    a4 = A[..., 3]
    AtA = torch.einsum("...mi,...mj->...ij", A3, A3)
    Atb = -torch.einsum("...mi,...m->...i", A3, a4)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.einsum("...ij,...j->...i", ba._inv3(AtA + 1e-10 * eye), Atb)


def _pad_set(arr: torch.Tensor, slot: torch.Tensor, can: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """arr.at[slot].set(where(can, vals, arr[slot])) with slot == len(arr)
    for the rows that write nothing (the reference's padded scatter)."""
    pad = torch.zeros((1,) + arr.shape[1:], dtype=arr.dtype, device=arr.device)
    big = torch.cat([arr, pad])
    vals = vals.to(arr.dtype)
    upd = torch.where(can.reshape((-1,) + (1,) * (vals.dim() - 1)), vals,
                      big[slot])
    return ms.scatter_set(big, slot, upd)[:-1]


def add_depth_points(cfg: SystemConfig, m: ms.MapState, kf_id, kp_depth,
                     close_only: bool = True) -> ms.MapState:
    """Create landmarks straight from sensor depth for a keyframe's
    unassociated keypoints (reference stereo / RGB-D CreateNewKeyFrame,
    Tracking.cc:1065-1140, and StereoInitialization): backproject and bind
    them to the keyframe.  Initialisation takes every positive depth
    (close_only=False); later keyframes only "close" points below
    mThDepth = bf * ThDepth / fx (Tracking.cc:105-117)."""
    cam = cfg.camera
    dev = m.pt_pos.device
    scales = _table(cfg.extractor.scale_factors, dev)
    if close_only:
        depth_th = (cam.bf / cam.fx) * cam.depth_th_factor if cam.bf > 0 \
            else 8.0
    else:
        depth_th = 1e9
    kf_id = torch.as_tensor(kf_id, device=dev)
    row = _row(m.kf_obs_pt, kf_id)
    need = _row(m.kf_kp_valid, kf_id) & (row < 0) \
        & (kp_depth > 0.05) & (kp_depth < depth_th)
    T = _row(m.kf_pose, kf_id)
    Xc = cam_mod.backproject(cam, _row(m.kf_uv, kf_id), kp_depth)
    Xw = geo.transform_points(geo.se3_inverse(T), Xc)

    P = m.pt_pos.shape[0]
    cum = torch.cumsum(need.to(torch.int32), 0) - 1
    slot = m.n_pt + cum
    can = need & (slot < P)
    slot_safe = torch.where(can, slot, P).long()
    rays = Xw - _centers(T)
    d = torch.linalg.vector_norm(rays, dim=1) + 1e-9
    n = Xw.shape[0]
    ones_i = torch.ones(n, dtype=torch.int32, device=dev)
    m = m._replace(
        pt_pos=_pad_set(m.pt_pos, slot_safe, can, Xw),
        pt_valid=_pad_set(m.pt_valid, slot_safe, can, can),
        pt_desc=_pad_set(m.pt_desc, slot_safe, can, _row(m.kf_desc, kf_id)),
        pt_normal=_pad_set(m.pt_normal, slot_safe, can, rays / d[:, None]),
        pt_max_dist=_pad_set(m.pt_max_dist, slot_safe, can,
                             d * scales[_row(m.kf_level, kf_id).long()]),
        pt_ref_kf=_pad_set(m.pt_ref_kf, slot_safe, can, ones_i * kf_id),
        pt_first_kf=_pad_set(m.pt_first_kf, slot_safe, can,
                             ones_i * (m.n_kf - 1)),
        pt_visible=_pad_set(m.pt_visible, slot_safe, can, ones_i),
        pt_found=_pad_set(m.pt_found, slot_safe, can, ones_i),
        n_pt=torch.clamp(m.n_pt + can.sum(), max=P).to(torch.int32),
    )
    new_id = torch.where(can, slot.to(torch.int32), row)
    return m._replace(kf_obs_pt=_set_row(m.kf_obs_pt, kf_id, new_id))


def create_map_points(cfg: SystemConfig, m: ms.MapState,
                      kf_id) -> ms.MapState:
    """Triangulate new landmarks between the new keyframe and its best
    covisible neighbors (reference LocalMapping::CreateNewMapPoints,
    LocalMapping.cc:207-453): epipolar-gated descriptor matching, DLT
    triangulation, parallax/cheirality/reprojection/scale checks.

    All neighbour pairs are matched, triangulated and checked in one
    batch; a keypoint matched by several neighbours keeps its first (most
    covisible) neighbour's triangulation."""
    cam = cfg.camera
    dev = m.pt_pos.device
    scales = _table(cfg.extractor.scale_factors, dev)
    sigma2 = _table(cfg.extractor.level_sigma2, dev)
    covis = ms.covisibility_row(m, kf_id)             # (K,)
    _, neighbors = matching._top_k_stable(covis, _n_neighbors(cfg))
    nb_ok = covis[neighbors] >= cfg.mapper.covis_edge_threshold

    T1 = _row(m.kf_pose, kf_id)
    uv1 = _row(m.kf_uv, kf_id)
    lvl1 = _row(m.kf_level, kf_id).long()
    C1 = _centers(T1)
    free1 = _row(m.kf_kp_valid, kf_id) & (_row(m.kf_obs_pt, kf_id) < 0)

    # --- per neighbour, batched over the Nn neighbours ---
    pair_ok = nb_ok & m.kf_valid[neighbors]
    T2 = m.kf_pose[neighbors]                         # (Nn, 4, 4)
    uv2 = m.kf_uv[neighbors]                          # (Nn, N, 2)
    lvl2 = m.kf_level[neighbors].long()               # (Nn, N)
    free2 = m.kf_kp_valid[neighbors] & (m.kf_obs_pt[neighbors] < 0)
    C2 = _centers(T2)                                 # (Nn, 3)
    baseline = torch.linalg.vector_norm(C2 - C1, dim=-1)

    # median scene depth of the neighbour (baseline check,
    # LocalMapping.cc:237)
    pc2_all = geo.transform_points(T2, m.pt_pos)      # (Nn, P, 3)
    z2v = torch.where(m.pt_valid, pc2_all[..., 2], float("nan"))
    med_depth = nanmedian(z2v)
    pair_ok = pair_ok & (baseline / torch.clamp(med_depth, min=1e-6) > 0.01)

    # epipolar gate: distance of kp2 from line F12 x1
    F12 = _fundamental_12(cam, T1, T2)                # (Nn, 3, 3)
    ones = torch.ones((uv1.shape[0], 1), dtype=torch.float32, device=dev)
    l2 = torch.cat([uv1, ones], 1) @ F12.transpose(-1, -2)     # (Nn, N, 3)
    p2h = torch.cat([uv2, ones.expand(uv2.shape[:-1] + (1,))], -1)
    num = (l2 @ p2h.transpose(-1, -2)) ** 2                    # (Nn, N, N)
    den = (l2[..., 0] ** 2 + l2[..., 1] ** 2)[..., None] + 1e-12
    epi_ok = num / den < 3.84 * sigma2[lvl2][:, None, :]

    mm = matching.match(
        _row(m.kf_desc, kf_id), free1, m.kf_desc[neighbors], free2,
        cfg.matcher, mask=epi_ok, max_dist=cfg.matcher.th_low, mutual=True,
        angle_q=_row(m.kf_angle, kf_id), angle_t=m.kf_angle[neighbors])

    idx2 = torch.clamp(mm.idx, min=0).long()                   # (Nn, N)
    uv2m = torch.gather(uv2, 1, idx2[..., None].expand(-1, -1, 2))
    lvl2m = torch.gather(lvl2, 1, idx2)
    X = _triangulate_pair(cam, T1, T2, uv1, uv2m)              # (Nn, N, 3)
    pc1 = geo.transform_points(T1, X)
    pc2 = geo.transform_points(T2, X)
    z1, z2 = pc1[..., 2], pc2[..., 2]

    def reproj_err(pc, uv_obs):
        zz = torch.where(pc[..., 2].abs() < 1e-6, 1e-6, pc[..., 2])
        u = pc[..., 0] / zz * cam.fx + cam.cx
        v = pc[..., 1] / zz * cam.fy + cam.cy
        return (u - uv_obs[..., 0]) ** 2 + (v - uv_obs[..., 1]) ** 2

    e1 = reproj_err(pc1, uv1)
    e2 = reproj_err(pc2, uv2m)
    r1 = X - C1
    r2 = X - C2[:, None, :]
    d1 = torch.linalg.vector_norm(r1, dim=-1) + 1e-9
    d2 = torch.linalg.vector_norm(r2, dim=-1) + 1e-9
    cos_par = (r1 * r2).sum(-1) / (d1 * d2)
    ratio_dist = d2 / d1
    ratio_octave = scales[lvl1] / scales[lvl2m]
    sf = cfg.extractor.scale_factor
    scale_ok = (ratio_dist < ratio_octave * 1.5 * sf) \
        & (ratio_dist * 1.5 * sf > ratio_octave)
    good = (pair_ok[:, None] & mm.valid & torch.isfinite(X).all(-1)
            & (z1 > 0) & (z2 > 0)
            & (cos_par < cfg.mapper.min_parallax_cos)
            & (e1 < 5.991 * sigma2[lvl1]) & (e2 < 5.991 * sigma2[lvl2m])
            & scale_ok)
    normal = r1 / d1[..., None] + r2 / d2[..., None]
    normal = normal / (torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
                       + 1e-9)
    maxd = d1 * scales[lvl1]

    # first (most covisible) neighbour with a good triangulation wins
    Nn, N = good.shape
    rank = torch.arange(Nn, device=dev)[:, None].expand(Nn, N)
    win = torch.argmin(torch.where(good, rank, Nn), dim=0)     # (N,)
    pick = win[None]
    chosen = torch.gather(good, 0, pick)[0]
    X = torch.gather(X, 0, pick[..., None].expand(1, N, 3))[0]
    normal = torch.gather(normal, 0, pick[..., None].expand(1, N, 3))[0]
    max_dist = torch.gather(maxd, 0, pick)[0]
    idx2 = torch.gather(idx2, 0, pick)[0]
    k2_win = neighbors[win]                                    # (N,)

    # single slot allocation for every chosen keypoint
    P = m.pt_pos.shape[0]
    pos = torch.cumsum(chosen.to(torch.int32), 0) - 1
    slot = m.n_pt + pos
    can = chosen & (slot < P)
    slot_safe = torch.where(can, slot, P).long()
    ones_i = torch.ones(N, dtype=torch.int32, device=dev)
    m = m._replace(
        pt_pos=_pad_set(m.pt_pos, slot_safe, can, X),
        pt_valid=_pad_set(m.pt_valid, slot_safe, can, can),
        pt_desc=_pad_set(m.pt_desc, slot_safe, can, _row(m.kf_desc, kf_id)),
        pt_normal=_pad_set(m.pt_normal, slot_safe, can, normal),
        pt_max_dist=_pad_set(m.pt_max_dist, slot_safe, can, max_dist),
        pt_ref_kf=_pad_set(m.pt_ref_kf, slot_safe, can, ones_i * kf_id),
        pt_first_kf=_pad_set(m.pt_first_kf, slot_safe, can, ones_i * m.n_kf),
        pt_visible=_pad_set(m.pt_visible, slot_safe, can, ones_i),
        pt_found=_pad_set(m.pt_found, slot_safe, can, ones_i),
        n_pt=torch.clamp(m.n_pt + can.sum(), max=P).to(torch.int32),
    )
    new_id = torch.where(can, slot, -1).to(torch.int32)
    row1 = torch.where(can, new_id, _row(m.kf_obs_pt, kf_id))
    m = m._replace(kf_obs_pt=_set_row(m.kf_obs_pt, kf_id, row1))
    # neighbour associations: scatter (winning neighbour row, matched kp2),
    # binding the neighbour keypoint only if it is still free
    K2, N2 = m.kf_obs_pt.shape
    flat = torch.cat([m.kf_obs_pt.reshape(-1),
                      torch.full((1,), -1, dtype=torch.int32, device=dev)])
    tgt = torch.where(can, k2_win * N2 + idx2, K2 * N2)
    cur = flat[torch.clamp(tgt, max=K2 * N2)]
    write = can & (cur < 0)
    flat = ms.scatter_set(flat, torch.where(write, tgt, K2 * N2),
                          torch.where(write, new_id, -1))[:-1]
    return m._replace(kf_obs_pt=flat.reshape(K2, N2))


# ---------------------------------------------------------------------------
# Culling and point geometry
# ---------------------------------------------------------------------------

def cull_points(cfg: SystemConfig, m: ms.MapState) -> ms.MapState:
    """Recent-point culling (reference LocalMapping::MapPointCulling,
    LocalMapping.cc:170-206): drop RECENT points with found/visible ratio
    < 0.25, or too few observations within 2 keyframes of creation; at any
    age, drop points observed by <= 1 keyframe (MapPoint::EraseObservation
    -> SetBadFlag, MapPoint.cc:118-143)."""
    ratio = m.pt_found.to(torch.float32) / torch.clamp(
        m.pt_visible.to(torch.float32), min=1.0)
    obs = ms.point_obs_count(m)
    age = m.n_kf - m.pt_first_kf
    recent = age <= 3
    bad = recent & ((ratio < cfg.mapper.culling_found_ratio)
                    | ((age >= 2) & (obs <= 2)))
    bad = bad | (~recent & (obs <= 1))
    return m._replace(pt_valid=m.pt_valid & ~bad)


MEDOID_OBS = 8  # observations per landmark entering the medoid computation


def _medoid_descriptors(m: ms.MapState, obs_pt, obs_valid):
    """Per-landmark representative descriptor: the observation descriptor
    with the smallest MEDIAN Hamming distance to the landmark's other
    observations (reference MapPoint::ComputeDistinctiveDescriptors,
    MapPoint.cc:242-296), over each landmark's first MEDOID_OBS
    observations in (keyframe, keypoint) order.  Returns (desc (P, 8),
    has (P,) bool)."""
    K, N = m.kf_obs_pt.shape
    P = m.pt_pos.shape[0]
    M = MEDOID_OBS
    dev = m.pt_pos.device
    pt_key = torch.where(obs_valid, obs_pt.long(), P)
    order = torch.argsort(pt_key, stable=True)
    sorted_pt = pt_key[order]
    ids = torch.arange(P, device=dev)
    start = torch.searchsorted(sorted_pt, ids)
    end = torch.searchsorted(sorted_pt, ids, right=True)
    idx = start[:, None] + torch.arange(M, device=dev)[None, :]    # (P, M)
    within = idx < end[:, None]
    flat = order[torch.clamp(idx, 0, K * N - 1)]
    descs = m.kf_desc.reshape(K * N, -1)[flat]                     # (P, M, 8)
    x = descs[:, :, None, :] ^ descs[:, None, :, :]
    pop = hamming.popcount_u32(x).sum(-1, dtype=torch.int32)       # (P, M, M)
    pair_ok = within[:, :, None] & within[:, None, :]
    BIG = 1 << 15
    pop = torch.where(pair_ok, pop, BIG)
    # median over each row's valid entries: sort ascending, pick (cnt-1)//2
    cnt = within.sum(1)                                            # (P,)
    srt = torch.sort(pop, dim=2).values
    med_idx = torch.clamp((cnt - 1) // 2, 0, M - 1)
    med = torch.gather(srt, 2, med_idx[:, None, None].expand(P, M, 1))[..., 0]
    med = torch.where(within, med, BIG)
    best_row = torch.argmin(med, dim=1)                            # (P,)
    desc = torch.gather(descs, 1, best_row[:, None, None].expand(
        P, 1, descs.shape[-1]))[:, 0, :]
    return desc, cnt > 0


def refresh_point_geometry(cfg: SystemConfig, m: ms.MapState) -> ms.MapState:
    """Recompute representative descriptor / normal / scale range /
    reference keyframe from the current observation table (reference
    MapPoint::ComputeDistinctiveDescriptors :242 + UpdateNormalAndDepth
    :330, in batch)."""
    K, N = m.kf_obs_pt.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    scales = _table(cfg.extractor.scale_factors, dev)
    obs_kf, obs_pt, _, _, obs_valid = ms.observation_coo(m)
    obs_pt_l = obs_pt.long()

    centers = ms.kf_centers(m)                    # (K, 3)
    rays = m.pt_pos[obs_pt_l] - centers[obs_kf.long()]
    d = torch.linalg.vector_norm(rays, dim=1) + 1e-9
    rays_n = rays / d[:, None]
    w = obs_valid.to(torch.float32)
    nsum = torch.zeros((P, 3), dtype=torch.float32, device=dev).index_add(
        0, obs_pt_l, rays_n * w[:, None])
    cnt = torch.zeros(P, dtype=torch.float32, device=dev).index_add(
        0, obs_pt_l, w)
    normal = nsum / torch.clamp(cnt[:, None], min=1.0)
    normal = normal / (torch.linalg.vector_norm(normal, dim=1, keepdim=True)
                       + 1e-9)

    # latest observation -> reference keyframe + scale range; medoid over
    # the observation window -> representative descriptor
    code = torch.where(obs_valid,
                       obs_kf * N + torch.arange(K * N, device=dev,
                                                 dtype=torch.int32) % N, -1)
    best_code = torch.full((P,), -1, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, obs_pt_l, code, "amax", include_self=True)
    has = best_code >= 0
    bk = torch.clamp(best_code, min=0) // N
    bn = torch.clamp(best_code, min=0) % N
    desc, _ = _medoid_descriptors(m, obs_pt, obs_valid)
    dist_ref = torch.linalg.vector_norm(m.pt_pos - centers[bk.long()], dim=1)
    max_dist = dist_ref * scales[m.kf_level[bk.long(), bn.long()].long()]

    return m._replace(
        pt_normal=torch.where(has[:, None], normal, m.pt_normal),
        pt_desc=torch.where(has[:, None], desc, m.pt_desc),
        pt_max_dist=torch.where(has, max_dist, m.pt_max_dist),
        pt_ref_kf=torch.where(has, bk, m.pt_ref_kf),
    )


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------

def fuse_into_neighbors(cfg: SystemConfig, m: ms.MapState,
                        kf_id) -> ms.MapState:
    """Project the new keyframe's landmarks into its covisible neighbours
    and reconcile duplicates (reference LocalMapping::SearchInNeighbors,
    LocalMapping.cc:454 + ORBmatcher::Fuse :825): a matching neighbour
    keypoint that is free gains the observation; one bound to a different
    landmark triggers a fuse keeping the better-observed one."""
    cam = cfg.camera
    dev = m.pt_pos.device
    scales = _table(cfg.extractor.scale_factors, dev)
    covis = ms.covisibility_row(m, kf_id)
    _, neighbors = matching._top_k_stable(covis, _n_neighbors(cfg))
    nb_ok = covis[neighbors] >= cfg.mapper.covis_edge_threshold
    obs_count = ms.point_obs_count(m)
    N2 = m.kf_obs_pt.shape[1]

    for i in range(neighbors.shape[0]):
        k2 = neighbors[i]
        src_pt = _row(m.kf_obs_pt, kf_id)              # (N,)
        src_ok = src_pt >= 0
        src_pt_safe = torch.clamp(src_pt, min=0).long()
        X = m.pt_pos[src_pt_safe]
        desc = m.pt_desc[src_pt_safe]
        pair_ok = nb_ok[i] & _row(m.kf_valid, k2)
        T2 = _row(m.kf_pose, k2)
        pc = geo.transform_points(T2, X)
        z = pc[:, 2]
        zs = torch.where(z.abs() < 1e-6, 1e-6, z)
        uv_pred = torch.stack([pc[:, 0] / zs * cam.fx + cam.cx,
                               pc[:, 1] / zs * cam.fy + cam.cy], 1)
        ok_q = src_ok & pair_ok & (z > 0.1) & m.pt_valid[src_pt_safe]

        lvl2 = _row(m.kf_level, k2).long()
        r = 3.0 * scales[lvl2]                         # per-target radius
        uv2 = _row(m.kf_uv, k2)
        d2 = ((uv_pred[:, None, :] - uv2[None, :, :]) ** 2).sum(-1)
        window = d2 <= (r * r)[None, :]
        dmat = hamming.pairwise_hamming_pm1(desc, _row(m.kf_desc, k2))
        valid_t = _row(m.kf_kp_valid, k2)
        dmat = torch.where(window & ok_q[:, None] & valid_t[None, :],
                           dmat, INF)
        best, bidx = dmat.min(1)
        good = ok_q & (best < cfg.matcher.th_low)

        row = _row(m.kf_obs_pt, k2)
        tgt_pt = row[bidx]                             # existing binding
        # free keypoint -> gain observation of src point
        add = good & (tgt_pt < 0)
        tgt_idx = torch.where(add, bidx, N2)
        row_ext = torch.cat([row, torch.full((1,), -1, dtype=torch.int32,
                                             device=dev)])
        row_ext = ms.scatter_set(row_ext, tgt_idx,
                                 torch.where(add, src_pt, -1))
        m = m._replace(kf_obs_pt=_set_row(m.kf_obs_pt, k2, row_ext[:N2]))
        # bound to a different landmark -> fuse, keeping better-observed
        dup = good & (tgt_pt >= 0) & (tgt_pt != src_pt)
        tgt_safe = torch.clamp(tgt_pt, min=0).long()
        keep_tgt = obs_count[tgt_safe] >= obs_count[src_pt_safe]
        pt_from = torch.where(keep_tgt, src_pt_safe, tgt_safe)
        pt_to = torch.where(keep_tgt, tgt_safe, src_pt_safe)
        m = lc.fuse_landmarks(cfg, m, pt_from, pt_to, dup)
    return m


def fuse_map_into_keyframe(cfg: SystemConfig, m: ms.MapState,
                           kf_id) -> ms.MapState:
    """REVERSE fuse: project the map's landmarks into the new keyframe and
    bind its free keypoints to them (the second half of the reference's
    LocalMapping::SearchInNeighbors, LocalMapping.cc:488-502), through the
    whole-map frustum/scale-gated projection search of TrackLocalMap —
    kernel K2 (`matching.match_windowed`), P x N forward and N x P
    reverse."""
    cam = cfg.camera
    dev = m.pt_pos.device
    scale_f = cfg.extractor.scale_factor
    n_levels = cfg.extractor.n_levels
    scales = _table(cfg.extractor.scale_factors, dev)
    T = _row(m.kf_pose, kf_id)

    pc = geo.transform_points(T, m.pt_pos)
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    uv_pred = torch.stack([pc[:, 0] / zs * cam.fx + cam.cx,
                           pc[:, 1] / zs * cam.fy + cam.cy], 1)
    C = _centers(T)
    rays = m.pt_pos - C
    dist = torch.linalg.vector_norm(rays, dim=1) + 1e-9
    min_dist = m.pt_max_dist / (scale_f ** (n_levels - 1))
    view_cos = (rays * m.pt_normal).sum(1) / dist
    visible = (m.pt_valid & (z > 0.1)
               & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cam.width)
               & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cam.height)
               & (dist >= 0.8 * min_dist)
               & (dist <= 1.2 * m.pt_max_dist * 1.25)
               & (view_cos > 0.5))
    ratio = torch.clamp(m.pt_max_dist / dist, min=1e-6)
    log_s = torch.log(_table((scale_f,), dev))[0]
    pred_level = torch.clamp(torch.ceil(torch.log(ratio) / log_s),
                             0, n_levels - 1).to(torch.int32)
    r = 3.0 * scales[pred_level.long()]    # Fuse radius (ORBmatcher.cc:838)

    row = _row(m.kf_obs_pt, kf_id)
    free_kp = _row(m.kf_kp_valid, kf_id) & (row < 0)
    # landmarks already observed by this keyframe must not match a second
    # (free) keypoint (the reference's Fuse skips pMP->IsInKeyFrame(pKF),
    # ORBmatcher.cc:859)
    P = m.pt_pos.shape[0]
    in_row = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    in_row[torch.where(row >= 0, row, P).long()] = True
    visible = visible & ~in_row[:P]
    mm = matching.match_windowed(
        m.pt_desc, uv_pred, r, visible, _row(m.kf_desc, kf_id),
        _row(m.kf_uv, kf_id), free_kp, cfg.matcher, level_q=pred_level,
        level_t=_row(m.kf_level, kf_id), level_lo=-1, level_hi=1,
        max_dist=cfg.matcher.th_low, mutual=True)
    N = row.shape[0]
    add = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    tgt = torch.where(mm.valid, mm.idx, N)
    add = ms.scatter_set(add, tgt, torch.where(
        mm.valid, torch.arange(P, dtype=torch.int32, device=dev), -1))[:N]
    new_row = torch.where(row >= 0, row, add)
    return m._replace(kf_obs_pt=_set_row(m.kf_obs_pt, kf_id, new_row))


def cull_keyframes(cfg: SystemConfig, m: ms.MapState, center) -> ms.MapState:
    """Redundant-keyframe culling (reference LocalMapping::KeyFrameCulling,
    LocalMapping.cc:632-700): a covisible keyframe whose landmarks are
    >= 90% observed by >= 3 other keyframes at the same or finer octave is
    retired.  The first two keyframes (map origin) are immune."""
    K, N = m.kf_obs_pt.shape
    P = m.pt_pos.shape[0]
    L = cfg.extractor.n_levels
    dev = m.pt_pos.device
    ok = m.kf_kp_valid & (m.kf_obs_pt >= 0) & m.kf_valid[:, None]
    pt = torch.clamp(m.kf_obs_pt, min=0).long()
    ok = ok & m.pt_valid[pt]
    lv = torch.clamp(m.kf_level, 0, L - 1).long()
    # per-point per-level observation histogram
    hist = torch.zeros(P * L, dtype=torch.int32, device=dev).index_add(
        0, (pt * L + lv).reshape(-1), ok.reshape(-1).to(torch.int32))
    cum = torch.cumsum(hist.reshape(P, L), dim=1).to(torch.int32)
    lv1 = torch.clamp(lv + 1, 0, L - 1)
    n_at_finer = cum.reshape(-1)[pt * L + lv1]        # includes own obs
    redundant = ok & ((n_at_finer - 1) >= 3)
    n_obs = ok.sum(1)
    frac = redundant.sum(1) / torch.clamp(n_obs, min=1)

    covis = ms.covisibility_row(m, center)
    ar = torch.arange(K, device=dev)
    candidate = (covis >= cfg.mapper.covis_edge_threshold) & m.kf_valid
    candidate = candidate & (ar >= 2) & (ar != center)
    cull = candidate & (frac > cfg.mapper.kf_culling_redundancy) & (n_obs > 20)
    return m._replace(
        kf_valid=m.kf_valid & ~cull,
        kf_obs_pt=torch.where(cull[:, None], -1, m.kf_obs_pt),
    )


# ---------------------------------------------------------------------------
# Local BA and the fused backend
# ---------------------------------------------------------------------------

def local_ba_body(cfg: SystemConfig, m: ms.MapState, center,
                  iters: int = 6) -> ms.MapState:
    """Windowed local bundle adjustment (reference
    Optimizer::LocalBundleAdjustment, Optimizer.cc:453): the W most
    covisible keyframes of `center` are gathered into a dense
    (W, N)-observation subproblem — those above the covisibility threshold
    free, the rest fixed anchors — and solved by `ba.solve_dense_compact`.
    Outlier observations are detached afterwards."""
    K, N = m.kf_obs_pt.shape
    dev = m.pt_pos.device
    W = min(cfg.mapper.ba_window, K)
    center = torch.as_tensor(center, device=dev)
    covis = ms.covisibility_row(m, center)
    row = torch.where(m.kf_valid, covis, -1)
    row = torch.where(torch.arange(K, device=dev) == center, 1 << 20, row)
    w_vals, kf_sel = matching._top_k_stable(row, W)   # center always rank 0
    ar = torch.arange(W, device=dev)
    is_center = ar == 0
    sel_valid = m.kf_valid[kf_sel]
    free = ((w_vals >= cfg.mapper.covis_edge_threshold) | is_center) \
        & sel_valid & (kf_sel != 0)
    # gauge: if the window has no anchor (all selected KFs free), fix the
    # oldest one (the reference's g2o problems always carry fixed vertices)
    no_anchor = (free | ~sel_valid).all()
    oldest = torch.argmin(torch.where(sel_valid & ~is_center, kf_sel,
                                      1 << 20))
    free = torch.where(no_anchor & (ar == oldest) & (W > 1), False, free)

    obs_pt_w = m.kf_obs_pt[kf_sel]                     # (W, N)
    obs_valid = (sel_valid[:, None] & m.kf_kp_valid[kf_sel]
                 & (obs_pt_w >= 0)).reshape(-1)
    obs_pt = torch.clamp(obs_pt_w.reshape(-1), min=0)
    obs_valid = obs_valid & m.pt_valid[obs_pt.long()]
    obs_level = m.kf_level[kf_sel].reshape(-1).long()
    inv_sigma2 = 1.0 / _table(cfg.extractor.level_sigma2, dev)[obs_level]
    prob = ba.BAProblem(
        poses=m.kf_pose[kf_sel], points=m.pt_pos,
        obs_kf=torch.arange(W, device=dev).repeat_interleave(N),
        obs_pt=obs_pt, obs_uv=m.kf_uv[kf_sel].reshape(-1, 2),
        obs_w=inv_sigma2, obs_valid=obs_valid, kf_fixed=~free,
    )
    res = ba.solve_dense_compact(cfg.camera, prob,
                                 min(cfg.mapper.ba_local_points,
                                     m.pt_pos.shape[0]), iters=iters)
    new_pose = torch.where(free[:, None, None], res.poses, m.kf_pose[kf_sel])
    outlier = (obs_valid & ~res.obs_inlier).reshape(W, N)
    new_rows = torch.where(outlier, -1, obs_pt_w)
    return m._replace(
        kf_pose=m.kf_pose.index_copy(0, kf_sel, new_pose),
        pt_pos=res.points,
        kf_obs_pt=m.kf_obs_pt.index_copy(0, kf_sel, new_rows),
    )


def _post_insert_body(cfg: SystemConfig, m: ms.MapState, k,
                      ba_iters: int = 4) -> ms.MapState:
    """The LocalMapping::Run iteration after a keyframe lands in slot k
    (reference LocalMapping.cc:37-94): bind free keypoints to existing
    landmarks, triangulate, fuse into neighbours, local BA, point and
    keyframe culling, then one geometry refresh over the final table."""
    m = fuse_map_into_keyframe(cfg, m, k)
    m = create_map_points(cfg, m, k)
    m = fuse_into_neighbors(cfg, m, k)
    m = local_ba_body(cfg, m, k, iters=ba_iters)
    m = cull_points(cfg, m)
    m = cull_keyframes(cfg, m, k)
    m = refresh_point_geometry(cfg, m)
    return m


def backend_insert(cfg: SystemConfig, m: ms.MapState, frame: Frame,
                   T, frame_id, kp_pt, has_depth: bool = False,
                   kp_depth=None, vocab=None, ba_iters: int = 4):
    """The whole post-insertion backend (reference LocalMapping.cc:37-94)
    for one keyframe.  Returns (map, k, aux): aux holds what the host-side
    bookkeeping reads — the BoW row (Frame::ComputeBoW, Frame.cc:396), the
    new keyframe's covisibility row, its BA-adjusted pose, its observation
    row and the point counter — all still on the device."""
    m, k = insert_keyframe(cfg, m, frame, T, frame_id, kp_pt)
    if has_depth:
        m = add_depth_points(cfg, m, k, kp_depth)
    # `ba_iters` < 4 is the InterruptBA analogue (reference
    # LocalMapping.cc:615-631)
    m = _post_insert_body(cfg, m, k, ba_iters)
    aux = {"pose": _row(m.kf_pose, k),
           "covis_row": ms.covisibility_row(m, k),
           "obs_row": _row(m.kf_obs_pt, k),
           "k": k, "n_pt": m.n_pt}
    if vocab is not None:
        words = bow.assign_words(frame.desc, frame.valid, vocab)
        aux["bow_row"] = bow.bow_vector(words, frame.valid,
                                        int(vocab.shape[0]))
    return m, k, aux
