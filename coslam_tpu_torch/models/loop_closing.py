"""Loop detection, Sim3 computation, and loop correction (port of coslam_tpu/
models/loop_closing.py, whole).

The reference LoopClosing thread (ORB_SLAM2/src/LoopClosing.cc): DetectLoop
(:103) lives in models/keyframe_db.py; ComputeSim3 (:231) is one
keyframe-pair descriptor match plus the batched Horn RANSAC of ops/sim3.py,
then the SearchBySim3 expansion — the windowed matcher, kernel K2
(ops/cuda_kernels.masked_match) forward and mutual reverse — and the
OptimizeSim3 polish; CorrectLoop (:402) is a MapState transform — duplicate-
landmark fusion by index remapping, Sim3 propagation to the covisible
window, essential-graph optimization (optim/pose_graph.py) and batched point
correction via each landmark's reference keyframe; the global BA
(:645) is optim/ba.solve over the whole map.

`LoopCloser` is the host-side orchestration.  It reads a few numbers back
per candidate (match counts, inlier counts, the scale), as the reference
does: they are its control flow.  `n_host_syncs` counts those readbacks.
Sim3 RANSAC draws are keyed by (keyframe, candidate): a `torch.Generator`
seeded from the pair, unless `sim3_draws[(keyframe, candidate)]` holds
injected (iters, 3) sample indices.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import keyframe_db as kdb
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.ops import hamming, matching
from coslam_tpu_torch.ops import sim3 as sim3_ops
from coslam_tpu_torch.optim import ba, pose_graph
from coslam_tpu_torch.utils import geometry as geo


def _index(k, device) -> torch.Tensor:
    """A keyframe id (int or 0-d tensor) as a (1,) int64 device tensor."""
    return torch.as_tensor(k, device=device).reshape(1).long()


def _row(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """a[k] for a (1,) index tensor, without reading the index back."""
    return a.index_select(0, k)[0]


def match_pair_points(cfg: SystemConfig, m: ms.MapState, k1, k2):
    """Descriptor-match landmarks seen in keyframes k1 and k2 (the analogue
    of SearchByBoW(KF, KF), reference ORBmatcher.cc:522, feeding ComputeSim3).

    Returns per-k1-keypoint arrays: matched k2 keypoint index, point ids on
    both sides, validity."""
    dev = m.kf_pose.device
    k1, k2 = _index(k1, dev), _index(k2, dev)
    obs1, obs2 = _row(m.kf_obs_pt, k1), _row(m.kf_obs_pt, k2)
    has1 = _row(m.kf_kp_valid, k1) & (obs1 >= 0)
    has2 = _row(m.kf_kp_valid, k2) & (obs2 >= 0)
    # loose pre-filter: geometric verification is the Sim3 RANSAC's job, so
    # the descriptor gate runs at TH_HIGH without a ratio test.  The
    # candidate side matches through its landmarks' MEDOID descriptors
    # (MapPoint::ComputeDistinctiveDescriptors) — the viewpoint-stable
    # appearance model, which recalls revisit pairs the per-frame
    # descriptors miss (the reference's SearchByBoW(KF,KF) also returns
    # MapPoint matches, ORBmatcher.cc:522-655)
    desc2 = m.pt_desc[torch.clamp(obs2, min=0).long()]
    mm = matching.match(_row(m.kf_desc, k1), has1, desc2, has2,
                        cfg.matcher, max_dist=cfg.matcher.th_high,
                        mutual=True, angle_q=_row(m.kf_angle, k1),
                        angle_t=_row(m.kf_angle, k2))
    idx2 = torch.clamp(mm.idx, min=0)
    pt1 = obs1
    pt2 = obs2[idx2.long()]
    ok = mm.valid & (pt1 >= 0) & (pt2 >= 0)
    pt1s, pt2s = torch.clamp(pt1, min=0), torch.clamp(pt2, min=0)
    ok = ok & m.pt_valid[pt1s.long()] & m.pt_valid[pt2s.long()]
    return idx2, pt1s, pt2s, ok


def _mutual_counts(cfg: SystemConfig, desc_q, has_q, desc_t, has_t):
    """(C,) mutual sub-TH_HIGH match counts of one query keyframe against C
    target keyframes (desc_t (C, N, 8), has_t (C, N))."""
    d = hamming.pairwise_hamming_pm1(desc_q, desc_t)          # (C, N, N)
    d = torch.where(has_q[None, :, None] & has_t[:, None, :], d,
                    matching.INF)
    best, bidx = d.min(-1)
    col_best = d.argmin(-2)
    mutual = torch.gather(col_best, -1, bidx) \
        == torch.arange(d.shape[-2], device=d.device)
    return ((best < cfg.matcher.th_high) & mutual).sum(-1)


def match_counts_all(cfg: SystemConfig, m: ms.MapState, kf_id):
    """Landmark-level match counts of `kf_id` against every keyframe: (K,)
    counts of mutual sub-TH_HIGH descriptor matches where both keypoints
    carry map points (16 keyframes per pass, to bound the (N, N) matrices
    held at once).  Used to shortlist loop candidates when BoW
    scores are weakly selective (the geometric verifier still decides)."""
    k = _index(kf_id, m.kf_pose.device)
    has_q = _row(m.kf_kp_valid, k) & (_row(m.kf_obs_pt, k) >= 0)
    desc_q = _row(m.kf_desc, k)
    has_all = m.kf_kp_valid & (m.kf_obs_pt >= 0) & m.kf_valid[:, None]
    K = has_all.shape[0]
    return torch.cat([
        _mutual_counts(cfg, desc_q, has_q, m.kf_desc[a:a + 16],
                       has_all[a:a + 16]) for a in range(0, K, 16)])


def match_counts_subset(cfg: SystemConfig, m: ms.MapState, kf_id, cands):
    """Landmark-level match counts of `kf_id` against a SHORTLIST of
    candidate keyframes (C,) — the geometric pre-verification applied to
    BoW candidates only, so the per-insertion cost is O(C N^2), not
    O(K N^2)."""
    k = _index(kf_id, m.kf_pose.device)
    c = cands.long()
    has_q = _row(m.kf_kp_valid, k) & (_row(m.kf_obs_pt, k) >= 0)
    has_t = m.kf_kp_valid[c] & (m.kf_obs_pt[c] >= 0) & m.kf_valid[c][:, None]
    return _mutual_counts(cfg, _row(m.kf_desc, k), has_q, m.kf_desc[c], has_t)


def sim3_between(cfg: SystemConfig, m: ms.MapState, k1, k2,
                 idx2, pt1, pt2, ok, samples=None,
                 generator: Optional[torch.Generator] = None):
    """RANSAC Sim3 S21 with x_k2cam ~ S21(x_k1cam) from matched landmarks
    (reference LoopClosing::ComputeSim3, LoopClosing.cc:231-300).  `samples`
    are the (iters, 3) minimal sets; without them they come from
    `generator`."""
    dev = m.kf_pose.device
    k1, k2 = _index(k1, dev), _index(k2, dev)
    x1c = geo.transform_points(_row(m.kf_pose, k1), m.pt_pos[pt1.long()])
    x2c = geo.transform_points(_row(m.kf_pose, k2), m.pt_pos[pt2.long()])
    uv1 = _row(m.kf_uv, k1)
    uv2 = _row(m.kf_uv, k2)[idx2.long()]
    return sim3_ops.ransac_sim3(
        cfg.camera, x1c, x2c, uv1, uv2, cfg.loop.sim3_ransac_iters,
        False, valid=ok, samples=samples, generator=generator, chi2_th=9.21)


def expand_sim3_matches(cfg: SystemConfig, m: ms.MapState, k1, k2,
                        s, R, t):
    """Grow the landmark pairing under an ESTIMATED Sim3 (the reference's
    SearchBySim3, ORBmatcher.cc:1102-1216, run between ComputeSim3's RANSAC
    and OptimizeSim3): project k1's bound landmarks into k2's image through
    S21 and window-match descriptors against k2's landmark-bound keypoints
    (kernel K2, forward and mutual reverse).  A marginal RANSAC consensus
    (10-20 pairs) typically grows to 2-4x here, which is what pushes true
    loops over the acceptance gate."""
    cam = cfg.camera
    dev = m.kf_pose.device
    k1, k2 = _index(k1, dev), _index(k2, dev)
    pt1 = _row(m.kf_obs_pt, k1)
    has1 = _row(m.kf_kp_valid, k1) & (pt1 >= 0)
    pt1s = torch.clamp(pt1, min=0)
    has1 = has1 & m.pt_valid[pt1s.long()]
    X1c = geo.transform_points(_row(m.kf_pose, k1), m.pt_pos[pt1s.long()])
    x2 = s * (X1c @ R.T) + t
    z = x2[:, 2]
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    uv_pred = torch.stack([x2[:, 0] / zs * cam.fx + cam.cx,
                           x2[:, 1] / zs * cam.fy + cam.cy], 1)
    has1 = has1 & (z > 0.05)

    pt2_row = _row(m.kf_obs_pt, k2)
    pt2_safe = torch.clamp(pt2_row, min=0).long()
    has2 = _row(m.kf_kp_valid, k2) & (pt2_row >= 0) & m.pt_valid[pt2_safe]
    # radius 7.5 px at the keypoint's octave (SearchBySim3's th=7.5);
    # candidate side matches through landmark medoid descriptors (see
    # match_pair_points)
    desc2 = m.pt_desc[pt2_safe]
    scales = torch.tensor(cfg.extractor.scale_factors, dtype=torch.float32,
                          device=dev)
    r = 7.5 * scales[torch.clamp(_row(m.kf_level, k1), 0,
                                 scales.shape[0] - 1).long()]
    mm = matching.match_windowed(
        _row(m.kf_desc, k1), uv_pred, r, has1, desc2, _row(m.kf_uv, k2),
        has2, cfg.matcher, max_dist=cfg.matcher.th_high, mutual=True)
    idx2 = torch.clamp(mm.idx, min=0)
    pt2 = pt2_row[idx2.long()]
    ok = mm.valid & (pt1 >= 0) & (pt2 >= 0)
    return idx2, pt1s, torch.clamp(pt2, min=0), ok


def sim3_refine_pairs(cfg: SystemConfig, m: ms.MapState, k1, k2,
                      idx2, pt1, pt2, ok, s, R, t) -> sim3_ops.Sim3Result:
    """LM-polish an initial Sim3 over an (expanded) pair set — the
    reference's OptimizeSim3 (Optimizer.cc:1046) applied after
    SearchBySim3.  Returns a Sim3Result over the given pairs."""
    dev = m.kf_pose.device
    k1, k2 = _index(k1, dev), _index(k2, dev)
    x1c = geo.transform_points(_row(m.kf_pose, k1), m.pt_pos[pt1.long()])
    x2c = geo.transform_points(_row(m.kf_pose, k2), m.pt_pos[pt2.long()])
    uv1 = _row(m.kf_uv, k1)
    uv2 = _row(m.kf_uv, k2)[idx2.long()]
    s2, R2, t2, ok2 = sim3_ops.refine_sim3(
        cfg.camera, x1c, x2c, uv1, uv2, s, R, t, ok, chi2_th=9.21)
    return sim3_ops.Sim3Result(s=s2, R=R2, t=t2, inliers=ok2,
                               n_inliers=ok2.sum())


def fuse_landmarks(cfg: SystemConfig, m: ms.MapState, pt_from, pt_to,
                   pair_ok) -> ms.MapState:
    """Merge duplicate landmarks: every observation of pt_from[i] is
    re-pointed at pt_to[i] and pt_from[i] is invalidated (the analogue of
    MapPoint::Replace, reference MapPoint.cc:177, as one index remap over
    the whole observation table).  Where two pairs name one pt_from, the
    later pair wins, as in the reference's scatter."""
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    tgt = torch.where(pair_ok, pt_from, P - 1)
    remap = ms.scatter_set(ids, tgt, torch.where(pair_ok, pt_to.to(torch.int32),
                                                 P - 1))
    remap = torch.where(ids == P - 1, P - 1, remap)
    obs = m.kf_obs_pt
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, min=0).long()], obs)
    fused_away = ms.scatter_set(torch.zeros(P, dtype=torch.bool, device=dev),
                                tgt, pair_ok)
    fused_away = fused_away & (ids != remap)
    return m._replace(kf_obs_pt=obs, pt_valid=m.pt_valid & ~fused_away)


def _all_pair_edges(K: int, device):
    """Upper-triangle pair enumeration (E = K(K-1)/2), row-major."""
    ij = torch.triu_indices(K, K, 1, device=device)
    return ij[0], ij[1]


def correct_loop(cfg: SystemConfig, m: ms.MapState, kf_cur, kf_loop,
                 s21, R21, t21, pt1, pt2, pair_ok,
                 prev_loops=None, prev_loops_valid=None) -> ms.MapState:
    """Apply a verified loop closure (reference LoopClosing::CorrectLoop,
    LoopClosing.cc:402-601).

    S21 maps current-KF camera coords -> loop-KF camera coords; so the
    corrected current pose is  S_cw = S21^-1 o S_loop_w  (the reference's
    mg2oScw = gScm * gSmw with m the loop keyframe).  kf_cur / kf_loop are
    ints or 0-d tensors; nothing is read back to the host.
    """
    K = m.kf_pose.shape[0]
    dev = m.kf_pose.device
    f32 = torch.float32
    kc, kl = _index(kf_cur, dev), _index(kf_loop, dev)
    lcfg = cfg.loop

    # ---- 1. fuse duplicate landmarks: current-side point -> loop-side point
    m = fuse_landmarks(cfg, m, pt1, pt2, pair_ok)

    # ---- 2. corrected Sim3 for the current KF and its covisible window
    S21 = geo.sim3(s21, R21, t21)
    S_loop_w = geo.sim3_from_se3(_row(m.kf_pose, kl))
    S_cw_new = geo.sim3_compose(geo.sim3_inverse(S21), S_loop_w)

    idx = torch.arange(K, device=dev)
    covis_m = ms.covisibility(m)
    covis = _row(covis_m, kc)
    window = ((covis >= cfg.mapper.covis_edge_threshold) | (idx == kc)) \
        & m.kf_valid

    T_c_old = _row(m.kf_pose, kc)
    # S_iw_corrected = S_ic o S_cw_new, with S_ic from old (drifted) poses
    T_ic = m.kf_pose @ geo.se3_inverse(T_c_old)
    S_ic = {"s": torch.ones(K, dtype=f32, device=dev),
            "R": T_ic[:, :3, :3], "t": T_ic[:, :3, 3]}
    S_iw_new = geo.sim3_compose(S_ic, S_cw_new)   # batched over K

    # old vertices (scale 1); windowed KFs get the corrected Sim3
    v_old = pose_graph.vertices_from_se3(m.kf_pose)
    v_init = pose_graph.Sim3Vertices(
        s=torch.where(window, S_iw_new["s"], v_old.s),
        R=torch.where(window[:, None, None], S_iw_new["R"], v_old.R),
        t=torch.where(window[:, None], S_iw_new["t"], v_old.t))

    # ---- 3. essential graph (reference Optimizer::OptimizeEssentialGraph,
    # Optimizer.cc:869-980): spanning-tree edges + sequential neighbors +
    # strong-covisibility edges + ALL past loop edges + the new loop edge.
    # Measurements come from pre-correction relative poses (the drift-
    # consistent odometry); the new loop edge from the verified Sim3.
    # derived spanning tree: each keyframe's parent is its most covisible
    # PREDECESSOR (the reference maintains mpParent incrementally,
    # KeyFrame.cc:342); first index among equal counts
    pred_mask = (idx[None, :] < idx[:, None]) & m.kf_valid[None, :]
    parent = torch.argmax(torch.where(pred_mask, covis_m, -1), dim=1)
    S_loop_meas_ji = geo.sim3_compose(S_cw_new, geo.sim3_inverse(S_loop_w))
    fixed = (idx == kl) | ~m.kf_valid
    if lcfg.sparse_essential_graph:
        # SPARSE edge list, O(K) edges (the reference's structure)
        topk = min(lcfg.essential_graph_top_k, K - 1)
        ei_seq, ej_seq = idx[:-1], idx[1:]
        v_seq = m.kf_valid[ei_seq] & m.kf_valid[ej_seq]
        ei_st, ej_st = parent, idx
        v_st = (idx >= 1) & m.kf_valid[parent] & m.kf_valid[idx] \
            & (parent < idx)
        w_row = torch.where(m.kf_valid[:, None] & m.kf_valid[None, :]
                            & (idx[None, :] != idx[:, None]), covis_m, -1)
        wk, jk = matching._top_k_stable(w_row, topk)            # (K, topk)
        ei_cov = idx.repeat_interleave(topk)
        ej_cov = jk.reshape(-1)
        v_cov = (wk.reshape(-1) >= lcfg.essential_graph_covis_w) \
            & m.kf_valid[ei_cov] & m.kf_valid[ej_cov]
        if prev_loops is not None:
            ei_prev = torch.clamp(prev_loops[:, 0].long(), 0, K - 1)
            ej_prev = torch.clamp(prev_loops[:, 1].long(), 0, K - 1)
            v_prev = prev_loops_valid & m.kf_valid[ei_prev] \
                & m.kf_valid[ej_prev]
        else:
            ei_prev = torch.zeros(0, dtype=torch.int64, device=dev)
            ej_prev = torch.zeros(0, dtype=torch.int64, device=dev)
            v_prev = torch.zeros(0, dtype=torch.bool, device=dev)
        # the NEW loop edge lives in the LAST slot
        ei = torch.cat([ei_seq, ei_st, ei_cov, ei_prev, kl])
        ej = torch.cat([ej_seq, ej_st, ej_cov, ej_prev, kc])
        evalid = torch.cat([v_seq, v_st, v_cov, v_prev,
                            torch.ones(1, dtype=torch.bool, device=dev)])
        # DEDUPLICATE: a pair that is simultaneously sequential, a
        # spanning-tree edge, a (possibly bidirectional) strong-covis
        # neighbor and/or a loop edge would otherwise be counted up to 4x,
        # skewing that constraint's weight vs the reference's unique edge
        # set (Optimizer.cc:869-980).  Canonical key = (min, max) pair;
        # loop edges (prio 0) win over structural duplicates (prio 1) so
        # their corrected measurement survives.  The sort is stable, as
        # the reference's.
        ekey = torch.minimum(ei, ej) * K + torch.maximum(ei, ej)
        E = ekey.shape[0]
        n_loop = ei_prev.shape[0] + 1
        prio = torch.cat([
            torch.ones(E - n_loop, dtype=torch.int64, device=dev),
            torch.zeros(n_loop, dtype=torch.int64, device=dev)])
        BIGK = 2 ** 31 - 1
        sort_key = torch.where(evalid, ekey * 2 + prio, BIGK)
        order = torch.argsort(sort_key, stable=True)
        k_sorted = torch.where(evalid[order], ekey[order], BIGK)
        dup_sorted = torch.cat([
            torch.zeros(1, dtype=torch.bool, device=dev),
            k_sorted[1:] == k_sorted[:-1]])
        dup = torch.zeros(E, dtype=torch.bool, device=dev)
        dup[order] = dup_sorted            # a permutation: no two sources
        evalid = evalid & ~dup
        meas = pose_graph.relative_sim3(v_old, ei, ej)
        # loop-edge measurement S_j S_i^-1 = S_cur_w_new o S_loop_w^-1
        # (edge oriented i=loop, j=cur)
        last = (torch.arange(E, device=dev) == E - 1)
        meas = pose_graph.Sim3Vertices(
            s=torch.where(last, S_loop_meas_ji["s"], meas.s),
            R=torch.where(last[:, None, None], S_loop_meas_ji["R"], meas.R),
            t=torch.where(last[:, None], S_loop_meas_ji["t"], meas.t))
        v_out = pose_graph.optimize_sparse(
            v_init, ei, ej, meas, lcfg.essential_graph_iters,
            edge_valid=evalid, fixed=fixed,
            pcg_iters=lcfg.essential_graph_pcg_iters)
    else:
        ei, ej = _all_pair_edges(K, dev)
        w_pair = covis_m[ei, ej]
        seq = (ej - ei) == 1
        strong = w_pair >= lcfg.essential_graph_covis_w
        is_st = (ej >= 1) & (ei == parent[ej])
        is_loop = (ei == torch.minimum(kc, kl)) & (ej == torch.maximum(kc, kl))
        evalid = (seq | strong | is_st | is_loop) \
            & m.kf_valid[ei] & m.kf_valid[ej]
        if prev_loops is not None:
            # accumulated loop edges from every past closure (the
            # reference's KeyFrame::GetLoopEdges feeding sLoopEdges,
            # Optimizer.cc:898-913), compared componentwise
            pa = torch.minimum(prev_loops[:, 0], prev_loops[:, 1]).long()
            pb = torch.maximum(prev_loops[:, 0], prev_loops[:, 1]).long()
            is_prev = ((ei[:, None] == pa[None, :])
                       & (ej[:, None] == pb[None, :])
                       & prev_loops_valid[None, :]).any(1)
            evalid = evalid | (is_prev & m.kf_valid[ei] & m.kf_valid[ej])

        meas = pose_graph.relative_sim3(v_old, ei, ej)
        # loop edge measurement: S_j S_i^-1 with corrected relation.  For
        # (i=min, j=max): if i is the loop KF, S_cur_w_new S_loop_w^-1,
        # else its inverse.
        cur_is_j = (kc > kl)[0]
        S_inv = geo.sim3_inverse(S_loop_meas_ji)
        lm_s = torch.where(cur_is_j, S_loop_meas_ji["s"], S_inv["s"])
        lm_R = torch.where(cur_is_j, S_loop_meas_ji["R"], S_inv["R"])
        lm_t = torch.where(cur_is_j, S_loop_meas_ji["t"], S_inv["t"])
        meas = pose_graph.Sim3Vertices(
            s=torch.where(is_loop, lm_s, meas.s),
            R=torch.where(is_loop[:, None, None], lm_R, meas.R),
            t=torch.where(is_loop[:, None], lm_t, meas.t))
        v_out = pose_graph.optimize(v_init, ei, ej, meas,
                                    lcfg.essential_graph_iters,
                                    edge_valid=evalid, fixed=fixed)

    # ---- 4. correct landmarks through their reference keyframe's old->new
    # similarity (reference Optimizer.cc:1010-1030 point correction)
    ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
    S_old_ref = {"s": v_old.s[ref], "R": v_old.R[ref], "t": v_old.t[ref]}
    S_new_ref = {"s": v_out.s[ref], "R": v_out.R[ref], "t": v_out.t[ref]}
    x_cam = geo.sim3_apply(S_old_ref, m.pt_pos[:, None, :])
    pt_new = geo.sim3_apply(geo.sim3_inverse(S_new_ref), x_cam)[:, 0, :]
    return m._replace(
        kf_pose=pose_graph.vertices_to_se3(v_out),
        pt_pos=torch.where(m.pt_valid[:, None], pt_new, m.pt_pos))


def global_ba(cfg: SystemConfig, m: ms.MapState,
              iters: int = 8) -> ms.MapState:
    """Full-map BA after loop correction (reference
    LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cc:645, 10 iters)."""
    dev = m.kf_pose.device
    obs_kf, obs_pt, obs_uv, obs_level, obs_valid = ms.observation_coo(m)
    inv_sigma2 = 1.0 / torch.tensor(cfg.extractor.level_sigma2,
                                    dtype=torch.float32,
                                    device=dev)[obs_level.long()]
    K = m.kf_pose.shape[0]
    prob = ba.BAProblem(
        poses=m.kf_pose, points=m.pt_pos, obs_kf=obs_kf, obs_pt=obs_pt,
        obs_uv=obs_uv, obs_w=inv_sigma2, obs_valid=obs_valid,
        kf_fixed=(torch.arange(K, device=dev) < 1) | ~m.kf_valid)
    res = ba.solve(cfg.camera, prob, iters=iters, pcg_iters=30)
    poses, points = res.poses, res.points
    if cfg.sensor == "mono":
        # monocular gauge: fixing ONE camera leaves the global SCALE free
        # and LM can drift it by large factors (invisible to Umeyama ATE
        # but fatal to anything holding map-frame transforms).  Restore the
        # scale POST-HOC: one similarity about slot 0's center so the summed
        # keyframe-center spread matches the pre-BA map.  This fixes exactly
        # the 1 gauge DOF and nothing else.
        c_old = ms.kf_centers(m)
        w = m.kf_valid.to(torch.float32)
        spread_old = (w * torch.linalg.vector_norm(c_old - c_old[0],
                                                   dim=1)).sum()
        R_new = poses[:, :3, :3]
        c_new = -torch.einsum("kji,kj->ki", R_new, poses[:, :3, 3])
        spread_new = (w * torch.linalg.vector_norm(c_new - c_new[0],
                                                   dim=1)).sum()
        s = spread_old / torch.clamp(spread_new, min=1e-9)
        c_scaled = c_new[0] + s * (c_new - c_new[0])
        poses = poses.clone()
        poses[:, :3, 3] = -torch.einsum("kij,kj->ki", R_new, c_scaled)
        points = c_new[0] + s * (points - c_new[0])
    outlier = (obs_valid & ~res.obs_inlier).reshape(m.kf_obs_pt.shape)
    return m._replace(kf_pose=poses, pt_pos=points,
                      kf_obs_pt=torch.where(outlier, -1, m.kf_obs_pt))


class LoopCloser:
    """Host-side orchestration (the reference's LoopClosing::Run loop,
    LoopClosing.cc:57-101, minus the thread)."""

    SEED = 42

    def __init__(self, cfg: SystemConfig, db: kdb.KeyFrameDatabase,
                 verbose: bool = False):
        self.cfg = cfg
        self.db = db
        self.verbose = verbose or bool(os.environ.get("COSLAM_LOOP_VERBOSE"))
        self.last_loop_kf = -10 ** 9
        # accepted loop pairs (cur_kf, loop_kf) — the analogue of the
        # reference's KeyFrame::AddLoopEdge records (LoopClosing.cc:561-562),
        # consumed by the essential-graph edge set
        self.loop_edges: List[Tuple[int, int]] = []
        self.pending_gba: Optional[int] = None
        # injected Sim3 RANSAC draws per (keyframe, candidate)
        self.sim3_draws: Dict[Tuple[int, int], np.ndarray] = {}
        # device -> host readbacks made by on_keyframe (its control flow)
        self.n_host_syncs = 0
        # the verification of the last accepted loop: candidate, expanded
        # inlier count, and the polished Sim3 (device tensors)
        self.last_closure: Optional[dict] = None

    def remap(self, kf_map: np.ndarray, remap_kf):
        """Renumber recorded loop edges / cooldown after map compaction."""
        self.loop_edges = [(remap_kf(a), remap_kf(b))
                           for a, b in self.loop_edges
                           if kf_map[a] >= 0 and kf_map[b] >= 0]
        if self.last_loop_kf >= 0:
            self.last_loop_kf = remap_kf(self.last_loop_kf)

    def _prev_loop_arrays(self, device):
        """Accumulated loop edges as fixed-shape arrays for correct_loop."""
        L = self.cfg.loop.max_loop_edges
        arr = np.zeros((L, 2), np.int64)
        val = np.zeros(L, bool)
        for i, (a, b) in enumerate(self.loop_edges[-L:]):
            arr[i] = (a, b)
            val[i] = True
        return (torch.from_numpy(arr).to(device),
                torch.from_numpy(val).to(device))

    def _read(self, *tensors) -> np.ndarray:
        """One counted readback of a few scalars, as float64."""
        self.n_host_syncs += 1
        return torch.stack([t.to(torch.float64) for t in tensors]) \
            .cpu().numpy()

    def _draws(self, kf_id: int, cand: int, device):
        """(samples, generator) of one Sim3 RANSAC: independent of how many
        attempts preceded it."""
        samples = self.sim3_draws.get((kf_id, cand))
        if samples is not None:
            return torch.as_tensor(np.asarray(samples, np.int64),
                                   device=device), None
        gen = torch.Generator(device=device)
        gen.manual_seed((self.SEED * 1_000_003 + kf_id) * 1_000_003 + cand)
        return None, gen

    def on_keyframe(self, m: ms.MapState, kf_id: int,
                    covis_row: Optional[np.ndarray] = None
                    ) -> Tuple[ms.MapState, bool]:
        lcfg = self.cfg.loop
        dev = m.kf_pose.device
        if kf_id - self.last_loop_kf < lcfg.min_kfs_between_loops:
            return m, False
        if covis_row is None:
            self.n_host_syncs += 1
            covis_row = ms.covisibility_row(m, kf_id).cpu().numpy()
        else:
            covis_row = np.asarray(covis_row)
        K = covis_row.shape[0]
        self.n_host_syncs += 1
        eligible = (np.arange(K) != kf_id) \
            & (covis_row < self.cfg.mapper.covis_edge_threshold) \
            & (np.abs(np.arange(K) - kf_id) > lcfg.min_kfs_between_loops) \
            & m.kf_valid.cpu().numpy()

        # candidate shortlist: BoW scoring + consistency chains (reference
        # LoopClosing::DetectLoop, KeyFrameDatabase.cc:120) is the primary
        # path; the O(K N^2) all-pairs landmark match count is an opt-in
        # fallback for untrained-vocabulary domains
        if lcfg.brute_force_shortlist:
            self.n_host_syncs += 1
            counts = match_counts_all(self.cfg, m, kf_id).cpu().numpy()
            counts = np.where(eligible, counts, -1)
            shortlist = [int(c) for c in np.argsort(-counts)[:3]
                         if counts[c] >= lcfg.sim3_min_bow_matches]
        else:
            reads = self.db.n_device_reads
            bow_cands = [c for c in
                         self.db.detect_loop_candidates(m, kf_id, covis_row)
                         if eligible[c]][:8]
            self.n_host_syncs += self.db.n_device_reads - reads
            if not bow_cands:
                return m, False
            # geometric pre-verification on the shortlist only
            self.n_host_syncs += 1
            counts = match_counts_subset(
                self.cfg, m, kf_id,
                torch.as_tensor(bow_cands, device=dev)).cpu().numpy()
            order = np.argsort(-counts)
            shortlist = [int(bow_cands[i]) for i in order[:3]
                         if counts[i] >= lcfg.sim3_min_bow_matches]
        if self.verbose and shortlist:
            print(f"[loop] kf {kf_id}: shortlist {shortlist}", flush=True)

        for cand in shortlist:
            idx2, pt1, pt2, ok = match_pair_points(self.cfg, m, kf_id, cand)
            n_pair = int(self._read(ok.sum())[0])
            if self.verbose:
                print(f"[loop]   cand {cand}: {n_pair} point pairs",
                      flush=True)
            # half-gate at entry: the Sim3 RANSAC needs only a minimal
            # consensus to seed the SearchBySim3 expansion below, where the
            # FULL sim3_min_inliers gate applies (reference ComputeSim3's
            # >= 20 BoW matches precede a solver whose inliers then grow
            # through SearchBySim3, LoopClosing.cc:267-300)
            if n_pair < max(6, lcfg.sim3_min_bow_matches // 2):
                continue
            samples, gen = self._draws(kf_id, cand, dev)
            res = sim3_between(self.cfg, m, kf_id, cand, idx2, pt1, pt2, ok,
                               samples=samples, generator=gen)
            n_inl, s_hat = self._read(res.n_inliers, res.s)
            if self.verbose:
                print(f"[loop]   cand {cand}: sim3 inliers {int(n_inl)}"
                      f" scale {s_hat:.3f}", flush=True)
            # a marginal RANSAC consensus is enough to ATTEMPT expansion
            # (reference ComputeSim3 proceeds to SearchBySim3 once the
            # solver converges, LoopClosing.cc:275-300)
            if int(n_inl) < max(6, lcfg.sim3_min_inliers // 2):
                continue
            if not (1.0 / lcfg.sim3_max_scale < s_hat
                    < lcfg.sim3_max_scale):
                # degenerate fit: a near-coincident/collinear inlier set can
                # satisfy the reprojection gate at an absurd scale; a real
                # same-map loop's scale drift is a few percent
                if self.verbose:
                    print(f"[loop]   cand {cand}: rejected, scale {s_hat:.3g}",
                          flush=True)
                continue
            # SearchBySim3-style match expansion + OptimizeSim3 polish —
            # the acceptance gate applies to the EXPANDED inlier set
            idx2, pt1, pt2, ok = expand_sim3_matches(
                self.cfg, m, kf_id, cand, res.s, res.R, res.t)
            res = sim3_refine_pairs(self.cfg, m, kf_id, cand, idx2, pt1, pt2,
                                    ok, res.s, res.R, res.t)
            n_inl, s_hat = self._read(res.n_inliers, res.s)
            if self.verbose:
                print(f"[loop]   cand {cand}: expanded inliers "
                      f"{int(n_inl)} scale {s_hat:.3f}", flush=True)
            if int(n_inl) < lcfg.sim3_min_inliers:
                continue
            if not (1.0 / lcfg.sim3_max_scale < s_hat
                    < lcfg.sim3_max_scale):
                continue
            prev, prev_valid = self._prev_loop_arrays(dev)
            m = correct_loop(self.cfg, m, kf_id, cand, res.s, res.R, res.t,
                             pt1, pt2, ok & res.inliers,
                             prev_loops=prev, prev_loops_valid=prev_valid)
            self.last_loop_kf = kf_id
            self.loop_edges.append((kf_id, cand))
            self.last_closure = {"kf": kf_id, "candidate": cand,
                                 "n_inliers": int(n_inl), "s": res.s,
                                 "R": res.R, "t": res.t}
            # deferred global BA (the reference runs GBA on a separate
            # thread with abort-on-new-loop, LoopClosing.cc:579 mbStopGBA;
            # here the essential graph lands immediately and the full BA is
            # deferred to the next quiet keyframe — a newer loop supersedes
            # a pending one, which is the abort semantics)
            self.pending_gba = kf_id
            return m, True
        return m, False

    def maybe_run_gba(self, m: ms.MapState) -> ms.MapState:
        """Run a deferred global BA if one is pending (called by the System
        at the next keyframe, i.e. once the closure has 'settled')."""
        if self.pending_gba is None:
            return m
        self.pending_gba = None
        return global_ba(self.cfg, m)
