"""Per-frame tracking stages (port of coslam_tpu/models/tracking.py:
TrackWithMotionModel, TrackReferenceKeyFrame, TrackLocalMap and the chunked
steady-state loop `track_chunk`).

Plain functions on tensors.  The reference's `lax.scan` over the two
motion-model radii is a loop of two (both bodies always run, as in the
reference), its `lax.cond` reference-keyframe fallback is a Python `if` on
a synced scalar, and the C-frame `lax.scan` of `track_chunk` is a Python
loop over frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import map_state as ms_mod
from coslam_tpu_torch.models.frame import Frame, build_frame
from coslam_tpu_torch.models.map_state import MapState
from coslam_tpu_torch.ops import matching
from coslam_tpu_torch.optim import pose_opt
from coslam_tpu_torch.utils import geometry as geo


class TrackResult(NamedTuple):
    T: torch.Tensor              # (4, 4) optimized Tcw
    kp_pt: torch.Tensor          # (N,) i32 map-point id per frame keypoint (-1)
    n_matches: torch.Tensor      # () associations before optimization
    n_inliers: torch.Tensor      # () pose-opt inliers
    ref_kf: torch.Tensor         # () i32 keyframe sharing the most landmarks
    n_ref_matches: torch.Tensor  # () reference-KF landmarks with >= 3 obs


def _select(take: torch.Tensor, new: TrackResult, old: TrackResult):
    """Field-wise torch.where(take, new, old)."""
    return TrackResult(*[torch.where(take, a, b) for a, b in zip(new, old)])


@functools.lru_cache(maxsize=None)
def _const(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A device constant, built once: a fresh torch.tensor from host values
    is a blocking host-to-device copy every frame.  Never written to."""
    return torch.tensor(value, dtype=dtype, device=device)


def _row(table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """table[k] for a 0-d device index without a host sync (indexing with a
    0-d tensor reads it back as a Python int)."""
    return table.index_select(0, k.reshape(1).long())[0]


def _project_points(cam, T, X):
    pc = geo.transform_points(T, X)
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = pc[:, 0] / zs * cam.fx + cam.cx
    v = pc[:, 1] / zs * cam.fy + cam.cy
    return torch.stack([u, v], 1), z


def _scatter_assoc(n_slots: int, m: matching.Matches, pt_ids):
    """Invert query->target matches into target-slot -> point-id.  Invalid
    matches all land in the overflow (dustbin) slot."""
    kp_pt = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                       device=pt_ids.device)
    tgt = torch.where(m.valid, m.idx, n_slots).long()
    kp_pt[tgt] = torch.where(m.valid, pt_ids.to(torch.int32), -1)
    return kp_pt[:n_slots]


def _motion_body(cfg: SystemConfig, m: MapState, frame: Frame,
                 last_kp_pt, last_level, T_pred, radius) -> TrackResult:
    """TrackWithMotionModel (Tracking.cc:869): project the previous frame's
    associated map points with the predicted pose and match them into the
    current frame within a scale-dependent window; then motion-only BA."""
    cam = cfg.camera
    dev = frame.uv.device
    scales = _const(cfg.extractor.scale_factors, torch.float32, dev)
    q_pt = last_kp_pt
    q_pt_safe = torch.clamp(q_pt, min=0).long()
    q_ok = (q_pt >= 0) & m.pt_valid[q_pt_safe]
    X = m.pt_pos[q_pt_safe]
    uv_pred, z = _project_points(cam, T_pred, X)
    q_ok = q_ok & (z > 0.1)

    r = radius * scales[torch.clamp(last_level, 0, scales.shape[0] - 1).long()]
    mm = matching.match_windowed(
        m.pt_desc[q_pt_safe], uv_pred, r, q_ok, frame.desc, frame.uv,
        frame.valid, cfg.matcher, level_q=last_level, level_t=frame.level,
        level_lo=-1, level_hi=1, max_dist=cfg.matcher.th_high, mutual=True)
    kp_pt = _scatter_assoc(frame.uv.shape[0], mm, q_pt)
    n_matches = (kp_pt >= 0).sum()

    ok = kp_pt >= 0
    Xf = m.pt_pos[torch.clamp(kp_pt, min=0).long()]
    res = pose_opt.optimize_pose(cam, T_pred, Xf, frame.uv, ok,
                                 frame.inv_sigma2, cfg.tracker)
    kp_pt = torch.where(res.inliers, kp_pt, -1)
    return TrackResult(T=res.T, kp_pt=kp_pt, n_matches=n_matches,
                       n_inliers=res.n_inliers,
                       ref_kf=_const(-1, torch.int32, dev),
                       n_ref_matches=_const(0, torch.int64, dev))


def _local_map_body(cfg: SystemConfig, m: MapState, frame: Frame,
                    T_init, kp_pt_init):
    """TrackLocalMap (Tracking.cc:932): project *all* valid map points, gate
    by frustum / distance range / viewing angle, match unassociated
    keypoints, then a final motion-only BA over the union of associations.
    Returns (TrackResult, map with updated visible/found counters)."""
    cam = cfg.camera
    dev = frame.uv.device
    scale_f = cfg.extractor.scale_factor
    n_levels = cfg.extractor.n_levels
    scales = _const(cfg.extractor.scale_factors, torch.float32, dev)

    uv_pred, z = _project_points(cam, T_init, m.pt_pos)
    C = -(T_init[:3, :3].T @ T_init[:3, 3])
    rays = m.pt_pos - C
    dist = torch.linalg.vector_norm(rays, dim=1) + 1e-9
    # frustum + scale-range + viewing-direction gates (Frame::isInFrustum,
    # Frame.cc:270-327: 0.8/1.2 distance band, cos > 0.5)
    min_dist = m.pt_max_dist / (scale_f ** (n_levels - 1))
    view_cos = (rays * m.pt_normal).sum(1) / dist
    visible = (m.pt_valid & (z > 0.1)
               & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cam.width)
               & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cam.height)
               & (dist >= 0.8 * min_dist) & (dist <= 1.2 * m.pt_max_dist * 1.25)
               & (view_cos > 0.5))

    # predicted octave from distance (MapPoint::PredictScale, MapPoint.cc:385)
    ratio = torch.clamp(m.pt_max_dist / dist, min=1e-6)
    log_s = torch.log(_const(scale_f, torch.float32, dev))
    pred_level = torch.clamp(torch.ceil(torch.log(ratio) / log_s),
                             0, n_levels - 1).to(torch.int32)
    r = 4.0 * scales[pred_level.long()]
    free_kp = frame.valid & (kp_pt_init < 0)
    mm = matching.match_windowed(
        m.pt_desc, uv_pred, r, visible, frame.desc, frame.uv, free_kp,
        cfg.matcher, level_q=pred_level, level_t=frame.level,
        level_lo=-1, level_hi=1, max_dist=cfg.matcher.th_high,
        ratio=0.8, mutual=True)
    P = m.pt_pos.shape[0]
    new_assoc = _scatter_assoc(frame.uv.shape[0], mm,
                               torch.arange(P, dtype=torch.int32, device=dev))
    kp_pt = torch.where(kp_pt_init >= 0, kp_pt_init, new_assoc)

    ok = kp_pt >= 0
    kp_safe = torch.clamp(kp_pt, min=0).long()
    res = pose_opt.optimize_pose(cam, T_init, m.pt_pos[kp_safe], frame.uv, ok,
                                 frame.inv_sigma2, cfg.tracker)
    kp_pt = torch.where(res.inliers, kp_pt, -1)
    kp_safe = torch.clamp(kp_pt, min=0).long()
    tracked_pt = kp_pt >= 0

    # visibility / found statistics, committed only when the pose tracked
    tracked_ok = res.n_inliers >= 10
    pt_visible = m.pt_visible + torch.where(tracked_ok,
                                            visible.to(torch.int32), 0)
    found = torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
        0, kp_safe, tracked_pt.to(torch.int32))
    pt_found = m.pt_found + torch.where(tracked_ok, found, 0)
    m = m._replace(pt_visible=pt_visible, pt_found=pt_found)

    # reference keyframe: the KF observing the most of this frame's tracked
    # landmarks (Tracking::UpdateLocalKeyFrames pKFmax, Tracking.cc:1169)
    tracked = torch.zeros(P, dtype=torch.float32, device=dev).index_add_(
        0, kp_safe, tracked_pt.to(torch.float32))
    obs_safe = torch.clamp(m.kf_obs_pt, min=0).long()
    shared = torch.where(m.kf_kp_valid & (m.kf_obs_pt >= 0),
                         tracked[obs_safe], 0.0).sum(1)
    shared = torch.where(m.kf_valid, shared, -1.0)
    ref_kf = torch.argmax(shared).to(torch.int32)

    # nRefMatches = reference KF's landmarks with >= nMinObs observations
    # (Tracking.cc:985-990, nMinObs = 3, or 2 while the map has <= 2 KFs)
    pobs = ms_mod.point_obs_count(m)
    min_obs = torch.where(m.n_kf <= 2, 2, 3)
    row = _row(m.kf_obs_pt, ref_kf)
    row_safe = torch.clamp(row, min=0).long()
    row_ok = (row >= 0) & _row(m.kf_kp_valid, ref_kf) & m.pt_valid[row_safe]
    n_ref = (row_ok & (pobs[row_safe] >= min_obs)).sum()

    return TrackResult(T=res.T, kp_pt=kp_pt, n_matches=tracked_pt.sum(),
                       n_inliers=res.n_inliers, ref_kf=ref_kf,
                       n_ref_matches=n_ref), m


def _ref_kf_body(cfg: SystemConfig, m: MapState, frame: Frame, ref_kf,
                 T_init) -> TrackResult:
    """TrackReferenceKeyFrame (Tracking.cc:759): descriptor-match the frame
    against the reference keyframe's landmark-carrying keypoints (dense
    matcher, 0.7 ratio), then pose-optimize from the predicted pose."""
    cam = cfg.camera
    pt = _row(m.kf_obs_pt, ref_kf)
    pt_safe = torch.clamp(pt, min=0).long()
    ok_t = (pt >= 0) & _row(m.kf_kp_valid, ref_kf) & m.pt_valid[pt_safe]
    mm = matching.match(frame.desc, frame.valid, m.pt_desc[pt_safe], ok_t,
                        cfg.matcher, max_dist=cfg.matcher.th_low,
                        ratio=0.7, mutual=True,
                        angle_q=frame.angle, angle_t=_row(m.kf_angle, ref_kf))
    kp_pt = torch.where(mm.valid,
                        pt_safe[torch.clamp(mm.idx, min=0).long()].to(torch.int32),
                        -1)
    ok = kp_pt >= 0
    X = m.pt_pos[torch.clamp(kp_pt, min=0).long()]
    res = pose_opt.optimize_pose(cam, T_init, X, frame.uv, ok,
                                 frame.inv_sigma2, cfg.tracker)
    kp_pt = torch.where(res.inliers, kp_pt, -1)
    return TrackResult(T=res.T, kp_pt=kp_pt, n_matches=ok.sum(),
                       n_inliers=res.n_inliers,
                       ref_kf=ref_kf.to(torch.int32),
                       n_ref_matches=_const(0, torch.int64, ok.device))


def _track_body(cfg: SystemConfig, m: MapState, frame: Frame,
                last_kp_pt, last_level, T_pred, radius, ref_kf=None):
    """Motion model at radius r and 2r (the second result kept only when
    the first fell below the match gate, Tracking.cc:905), the
    reference-keyframe fallback below 10 inliers (Tracking.cc:354-363), then
    TrackLocalMap.  Returns (motion inliers, TrackResult, map)."""
    N = frame.uv.shape[0]
    dev = frame.uv.device
    res1 = TrackResult(T=T_pred,
                       kp_pt=torch.full((N,), -1, dtype=torch.int32,
                                        device=dev),
                       n_matches=_const(0, torch.int64, dev),
                       n_inliers=_const(-1, torch.int64, dev),
                       ref_kf=_const(-1, torch.int32, dev),
                       n_ref_matches=_const(0, torch.int64, dev))
    for r in (radius, 2.0 * radius):
        res = _motion_body(cfg, m, frame, last_kp_pt, last_level, T_pred, r)
        take = res1.n_inliers < cfg.tracker.min_matches_motion
        res1 = _select(take, res, res1)

    if ref_kf is not None:
        need_fb = (res1.n_inliers < 10) & (ref_kf >= 0)
        if bool(need_fb):
            r = _ref_kf_body(cfg, m, frame, torch.clamp(ref_kf, min=0), T_pred)
            better = r.n_inliers > res1.n_inliers
            res1 = _select(better,
                           r._replace(n_ref_matches=res1.n_ref_matches), res1)

    res2, m = _local_map_body(cfg, m, frame, res1.T, res1.kp_pt)
    return res1.n_inliers, res2, m


class ChunkCarry(NamedTuple):
    """Tracking state carried across the frames of a chunk (mVelocity,
    mLastFrame's pose and map-point bindings, counters)."""
    T: torch.Tensor               # (4, 4) f32 last tracked pose
    vel: torch.Tensor             # (4, 4) f32 constant-velocity model
    has_vel: torch.Tensor         # () bool
    kp_pt: torch.Tensor           # (N,) i32 last frame's landmark bindings
    level: torch.Tensor           # (N,) i32 last frame's keypoint octaves
    frames_since_kf: torch.Tensor  # () i32
    ref_kf: torch.Tensor          # () i32 reference keyframe
    pt_visible: torch.Tensor      # (P,) i32 running visibility stats
    pt_found: torch.Tensor        # (P,) i32


class ChunkStep(NamedTuple):
    """Per-frame outputs of a chunk, stacked over its C frames."""
    T: torch.Tensor               # (C, 4, 4)
    T_rel: torch.Tensor           # (C, 4, 4) T @ kf_pose[ref_kf]^-1
    n_inliers: torch.Tensor       # (C,)
    ref_kf: torch.Tensor          # (C,) i32
    n_ref_matches: torch.Tensor   # (C,)
    need_kf: torch.Tensor         # (C,) bool
    ok: torch.Tensor              # (C,) bool (False = this frame is LOST)


def track_chunk(cfg: SystemConfig, m: MapState, imgs, allow_kf: bool,
                carry: ChunkCarry, aux_imgs=None,
                mapper_latency: Optional[int] = None):
    """Steady-state tracking of a chunk of C frames: ORB extraction,
    motion-model + local-map tracking and the NeedNewKeyFrame gate per
    frame, with the constant-velocity state carried between frames.

    Returns (new carry, ChunkStep, stacked Frames, per-step kp_pt,
    per-step pt_visible / pt_found snapshots, per-step kp_depth)."""
    if cfg.sensor != "mono" or aux_imgs is not None:
        raise NotImplementedError(
            "stereo / RGB-D tracking is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    tr = cfg.tracker
    dev = imgs.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    N = cfg.extractor.max_keypoints
    K = m.kf_pose.shape[0]
    lat = tr.mapper_latency_frames if mapper_latency is None \
        else mapper_latency

    c = carry
    steps, frames, kp_pts, vis_snap, found_snap = [], [], [], [], []
    for img in imgs:
        frame = build_frame(img, cfg)
        T_pred = torch.where(c.has_vel, c.vel @ c.T, c.T)
        radius = torch.where(c.has_vel, _const(15.0, torch.float32, dev),
                             _const(30.0, torch.float32, dev))
        m_c = m._replace(pt_visible=c.pt_visible, pt_found=c.pt_found)
        _n1, res, m2 = _track_body(cfg, m_c, frame, c.kp_pt, c.level,
                                   T_pred, radius, ref_kf=c.ref_kf)
        ok = res.n_inliers >= 10
        T_new = torch.where(ok, res.T, T_pred)
        vel_new = T_new @ geo.se3_inverse(c.T)
        fs = c.frames_since_kf + 1

        # NeedNewKeyFrame (Tracking.cc:979-1063), mono: ratio 0.9, the
        # mapper modeled as always idle, throttled to `lat` frames
        n_ref = res.n_ref_matches
        c1a = fs >= tr.max_frames
        c1b = fs >= tr.min_frames
        c2 = (res.n_inliers < n_ref * tr.ref_ratio_mono) \
            & (res.n_inliers > 15)
        need = ok & (c1a | c1b) & c2 & (fs >= lat) & allow_kf
        fs = torch.where(need, 0, fs)

        kp_ok = torch.where(ok, res.kp_pt, -1)
        c = ChunkCarry(
            T=T_new, vel=torch.where(ok, vel_new, eye), has_vel=ok,
            kp_pt=kp_ok, level=frame.level, frames_since_kf=fs,
            ref_kf=torch.where(ok, res.ref_kf, c.ref_kf).to(torch.int32),
            pt_visible=m2.pt_visible, pt_found=m2.pt_found)
        T_rel = T_new @ geo.se3_inverse(
            _row(m.kf_pose, torch.clamp(res.ref_kf, 0, K - 1)))
        steps.append(ChunkStep(T=T_new, T_rel=T_rel, n_inliers=res.n_inliers,
                               ref_kf=res.ref_kf, n_ref_matches=n_ref,
                               need_kf=need, ok=ok))
        frames.append(frame)
        kp_pts.append(kp_ok)
        vis_snap.append(m2.pt_visible)
        found_snap.append(m2.pt_found)

    stacked = ChunkStep(*[torch.stack(f) for f in zip(*steps)])
    frames_st = Frame(*[torch.stack(f) for f in zip(*frames)])
    kp_depths = torch.zeros((len(frames), N), dtype=torch.float32, device=dev)
    return (c, stacked, frames_st, torch.stack(kp_pts), torch.stack(vis_snap),
            torch.stack(found_snap), kp_depths)


def track_frame_built(cfg: SystemConfig, m: MapState, frame: Frame,
                      last_kp_pt, last_level, T_pred, radius, ref_kf=None):
    """The per-frame tracking pipeline after Frame construction: the motion
    model with its wide-window retry, then TrackLocalMap."""
    return _track_body(cfg, m, frame, last_kp_pt, last_level, T_pred,
                       radius, ref_kf=ref_kf)
