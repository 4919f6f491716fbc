"""System facade + per-frame orchestration (port of coslam_tpu/models/
system.py).

Ported: monocular, stereo and RGB-D SLAM from the first frame —
initialisation (`_try_initialize` -> `_init_attempt` -> `_initial_map`;
with a depth sensor `_initialize_with_depth`), tracking, and the
keyframe backend (`local_mapping.backend_insert`) with its BoW row into the
`KeyFrameDatabase` and loop closing on the new keyframe
(`loop_closing.LoopCloser`: detection, Sim3 verification, loop correction,
deferred global BA) — through `track_mono` and the chunked
`run_sequence` (overlapped inserts chained on the device, synchronous batch
inserts at capacity watermarks with compaction / growth), `track_stereo`
and `track_rgbd` (per-keypoint depth from `tracking.sensor_depth`, landmarks
from depth at each keyframe, the close-point keyframe term); the LOST state
with relocalization (`_attempt_relocalization`: place recognition -> EPnP
RANSAC -> recovery rounds, Tracking.cc:1343); localization mode
(System::ActivateLocalizationMode, System.cc:237); checkpoint resume
(utils/checkpoint.py); online vocabulary retraining without a pretrained
vocabulary (`KeyFrameDatabase.maybe_retrain`).

RANSAC draws: the reference derives its initialisation key from the frame
id (`fold_in(PRNGKey(0), frame_id)`) and its relocalization keys from the
count of frames seen and the candidate; here each attempt draws from a
`torch.Generator` seeded with the same numbers, unless
`init_draws[frame_id]` holds injected (iters, 8) sample indices, or
`reloc_draws[(n_frames_tracked, candidate)]` injected (iters, 6) ones
(parity tests inject the reference's draws there).  The loop closer's Sim3
draws are keyed by (keyframe, candidate) in the same way
(`sim3_draws`, handed to `loop_closer.sim3_draws`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import compaction
from coslam_tpu_torch.models import keyframe_db as kdb
from coslam_tpu_torch.models import local_mapping as lm
from coslam_tpu_torch.models import loop_closing as lc
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.models import tracking
from coslam_tpu_torch.models.frame import Frame, build_frame
from coslam_tpu_torch.ops import matching, twoview
from coslam_tpu_torch.utils import geometry as geo
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _match_for_init(cfg: SystemConfig, f0: Frame, f1: Frame):
    """SearchForInitialization (reference ORBmatcher.cc:405): window 100,
    ratio 0.9, mutual, rotation consistency, all octaves."""
    mask = matching.window_mask(f0.uv, f1.uv, 100.0)
    return matching.match(f0.desc, f0.valid, f1.desc, f1.valid, cfg.matcher,
                          mask=mask, max_dist=cfg.matcher.th_low,
                          ratio=0.9, mutual=True,
                          angle_q=f0.angle, angle_t=f1.angle)


def _init_attempt(cfg: SystemConfig, m: ms.MapState, f0: Frame, f1: Frame,
                  fid0: int, fid1: int, samples=None,
                  generator: Optional[torch.Generator] = None):
    """One monocular-initialization attempt (reference
    Tracking::MonocularInitialization, Tracking.cc:565-637): matching, H|F
    RANSAC model selection and, on success, the map bootstrap.  `samples`
    are the RANSAC draws; without them they come from `generator`.
    Returns (map, kp_pt of f1, (success, n_matches, n_pts, n_kp))."""
    tr = cfg.tracker
    mm = _match_for_init(cfg, f0, f1)
    n_matches = mm.valid.sum()
    uv2 = f1.uv[torch.clamp(mm.idx, min=0).long()]
    if samples is None:
        samples = twoview.draw_samples(mm.valid, tr.ransac_iters, generator)
    res = twoview.initialize(cfg.camera, f0.uv, uv2, mm.valid, samples,
                             tr.ransac_sigma, tr.init_min_good)
    success = res.success & (n_matches >= tr.init_min_matches)
    N = f0.uv.shape[0]
    if bool(success):
        m2, kp_pt1, n_pts = _initial_map(cfg, m, f0, f1, fid0, fid1, res.T21,
                                         res.points3d, mm.idx,
                                         res.is_inlier & mm.valid)
    else:
        m2 = m
        kp_pt1 = torch.full((N,), -1, dtype=torch.int32, device=f0.uv.device)
        n_pts = torch.zeros((), dtype=torch.int64, device=f0.uv.device)
    return m2, kp_pt1, (success, n_matches, n_pts, f1.valid.sum())


def _initial_map(cfg: SystemConfig, m: ms.MapState, f0: Frame, f1: Frame,
                 fid0, fid1, T21, pts3d, match_idx, inlier):
    """CreateInitialMapMonocular (reference Tracking.cc:639-757): two
    keyframes, triangulated points, median-depth scale normalization, then
    a local BA over the initial structure and a geometry refresh."""
    N = f0.uv.shape[0]
    dev = pts3d.device
    # median-depth normalization (Tracking.cc:691-714)
    med = lm.nanmedian(torch.where(inlier, pts3d[:, 2], float("nan")))
    scale = 1.0 / torch.clamp(med, min=1e-6)
    T21 = T21.clone()
    T21[:3, 3] = T21[:3, 3] * scale
    pts3d = pts3d * scale

    none = torch.full((N,), -1, dtype=torch.int32, device=dev)
    m, k0 = lm.insert_keyframe(cfg, m, f0, torch.eye(4, device=dev), fid0,
                               none)
    m, k1 = lm.insert_keyframe(cfg, m, f1, T21, fid1, none)

    pos = torch.cumsum(inlier.to(torch.int32), 0) - 1
    P = m.pt_pos.shape[0]
    slot = torch.where(inlier, pos, P).long()
    scales = lm._table(cfg.extractor.scale_factors, dev)
    d0 = torch.linalg.vector_norm(pts3d, dim=1) + 1e-9
    normal = pts3d / d0[:, None]
    max_dist = d0 * scales[f0.level.long()]

    n_new = inlier.sum()
    zeros_i = torch.zeros(N, dtype=torch.int32, device=dev)
    ones_i = torch.ones(N, dtype=torch.int32, device=dev)
    m = m._replace(
        pt_pos=lm._pad_set(m.pt_pos, slot, inlier, pts3d),
        pt_valid=lm._pad_set(m.pt_valid, slot, inlier, inlier),
        pt_desc=lm._pad_set(m.pt_desc, slot, inlier, f0.desc),
        pt_normal=lm._pad_set(m.pt_normal, slot, inlier, normal),
        pt_max_dist=lm._pad_set(m.pt_max_dist, slot, inlier, max_dist),
        pt_ref_kf=lm._pad_set(m.pt_ref_kf, slot, inlier, zeros_i),
        pt_first_kf=lm._pad_set(m.pt_first_kf, slot, inlier, zeros_i),
        pt_visible=lm._pad_set(m.pt_visible, slot, inlier, ones_i),
        pt_found=lm._pad_set(m.pt_found, slot, inlier, ones_i),
        n_pt=n_new.to(torch.int32),
    )
    # associations: kp i of f0 -> slot; kp match_idx[i] of f1 -> slot
    new_id = torch.where(inlier, slot, -1).to(torch.int32)
    m = m._replace(kf_obs_pt=lm._set_row(m.kf_obs_pt, k0, new_id))
    row1 = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    tgt = torch.where(inlier, torch.clamp(match_idx, min=0), N)
    row1 = ms.scatter_set(row1, tgt, torch.where(inlier, new_id, -1))[:-1]
    m = m._replace(kf_obs_pt=lm._set_row(m.kf_obs_pt, k1, row1))
    # global BA on the initial structure (Tracking.cc:688) + geometry
    m = lm.local_ba_body(cfg, m, k1, iters=8)
    m = lm.refresh_point_geometry(cfg, m)
    return m, row1, n_new


def _frame_at(frames: Frame, j: int) -> Frame:
    return Frame(*[a[j] for a in frames])


class System:
    """SLAM engine instance (reference System ctor System.cc:32 +
    TrackMonocular / TrackStereo / TrackRGBD) on `device`: the GPU unless
    the caller passes device="cpu"."""

    def __init__(self, cfg: SystemConfig, device=DEFAULT_DEVICE,
                 enable_loop_closing: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.map = ms.empty_map(cfg, self.device)
        self.db = kdb.KeyFrameDatabase(cfg, device=self.device)
        self.loop_closer = lc.LoopCloser(cfg, self.db) \
            if enable_loop_closing else None
        self.n_loops_closed = 0
        self.state = "NOT_INITIALIZED"
        self.ref_frame: Optional[Frame] = None
        self.ref_frame_id = -1
        self.last_T = np.eye(4, dtype=np.float32)
        self.velocity: Optional[np.ndarray] = None
        self.last_kp_pt: Optional[torch.Tensor] = None
        self.last_level: Optional[torch.Tensor] = None
        # per-keypoint depth of the frame being tracked (stereo / RGB-D)
        self._cur_depth: Optional[torch.Tensor] = None
        self.frames_since_kf = 0
        self.ref_kf_matches = 0
        self.last_ref_kf = -1
        # per-frame log: (frame_id, ref_kf, T_frame_wrt_refkf)
        self.trajectory: List[Tuple[int, int, np.ndarray]] = []
        self.stats: List[dict] = []
        self.timestamps: dict = {}
        self.localization_only = False
        self.n_frames_tracked = 0
        self._host_n_kf = 0   # exact host mirror of map.n_kf
        self._host_n_pt = 0   # host mirror of map.n_pt (exact after flushes)
        self._pending_kf: List[tuple] = []
        self._pending_pt_arrays: List[torch.Tensor] = []
        self._kf_pose_host: Optional[np.ndarray] = None
        self._kf_pose_dirty = True
        self._last_insert_pose: Optional[np.ndarray] = None
        # injected RANSAC draws per initialisation frame id, and per
        # (n_frames_tracked, candidate keyframe) of a relocalization attempt
        # (see module doc)
        self.init_draws: Dict[int, np.ndarray] = {}
        self.reloc_draws: Dict[Tuple[int, int], np.ndarray] = {}
        # injected Sim3 draws per (keyframe, candidate): the loop closer's
        self.sim3_draws: Dict[Tuple[int, int], np.ndarray] = \
            self.loop_closer.sim3_draws if self.loop_closer is not None \
            else {}
        self.n_relocalizations = 0
        # measured mapper model for mapper_latency_frames < 0 (AUTO)
        self._insert_cost_s: Optional[float] = None
        self.n_frames_chunked = 0
        self.n_frames_discarded = 0
        self._pf_cooldown = 0

    # ------------------------------------------------------------------
    @property
    def _mapper_busy_frames(self) -> int:
        """The measured mapper cycle in frame periods at this camera rate
        (reference: mono inserts only when LocalMapping is idle,
        Tracking.cc:1041-1059)."""
        cost = self._insert_cost_s if self._insert_cost_s is not None else 0.1
        fps = self.cfg.camera.fps or 30.0
        return int(np.clip(np.ceil(cost * fps), 1,
                           max(self.cfg.tracker.max_frames // 2, 1)))

    @property
    def _mapper_latency(self) -> int:
        lat = self.cfg.tracker.mapper_latency_frames
        return lat if lat >= 0 else self._mapper_busy_frames

    def _note_insert_cost(self, dt: float):
        """Keep the fastest observed backend cycle."""
        if self._insert_cost_s is None or dt < self._insert_cost_s:
            self._insert_cost_s = dt

    def activate_localization_mode(self):
        """Stop mapping; keep tracking against the frozen map (reference
        System::ActivateLocalizationMode, System.h:80 / System.cc:237)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        """Resume full SLAM (System::DeactivateLocalizationMode)."""
        self.localization_only = False

    def _to_device(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img)).to(self.device)

    # ------------------------------------------------------------------
    def track_mono(self, img, frame_id: int,
                   timestamp: Optional[float] = None) -> Optional[np.ndarray]:
        self._note_frame(frame_id, timestamp)
        self._cur_depth = None
        frame = build_frame(self._to_device(img), self.cfg)
        if self.state == "NOT_INITIALIZED":
            self._try_initialize(frame, frame_id)
            T = self.last_T if self.state == "OK" else None
        else:
            T = self._track(frame_id, frame)
        return self._log_pose(frame_id, T)

    def track_rgbd(self, img, depth, frame_id: int,
                   timestamp: Optional[float] = None) -> Optional[np.ndarray]:
        """RGB-D tracking (reference System::TrackRGBD): sensor depth gives
        metric scale; initialisation is one keyframe with backprojected
        landmarks."""
        self._note_frame(frame_id, timestamp)
        return self._track_with_depth(self._to_device(img),
                                      self._to_device(depth), "rgbd",
                                      frame_id)

    def track_stereo(self, img_left, img_right, frame_id: int,
                     timestamp: Optional[float] = None) -> Optional[np.ndarray]:
        """Rectified stereo tracking (reference System::TrackStereo): ORB
        on both views and row-banded matching give per-keypoint depth; the
        rest of the pipeline is shared."""
        self._note_frame(frame_id, timestamp)
        return self._track_with_depth(self._to_device(img_left),
                                      self._to_device(img_right), "stereo",
                                      frame_id)

    def _track_with_depth(self, img: torch.Tensor, aux: torch.Tensor,
                          sensor: str, frame_id: int) -> Optional[np.ndarray]:
        frame = build_frame(img, self.cfg)
        sd = tracking.sensor_depth(self.cfg, frame, img, aux, sensor)
        self._cur_depth = sd.depth
        if self.state == "NOT_INITIALIZED":
            self._initialize_with_depth(frame, sd, frame_id)
            T = self.last_T if self.state == "OK" else None
        else:
            T = self._track(frame_id, frame)
        return self._log_pose(frame_id, T)

    def _note_frame(self, frame_id: int, timestamp: Optional[float]):
        self.n_frames_tracked += 1
        self.timestamps[frame_id] = (float(timestamp) if timestamp is not None
                                     else float(frame_id))

    def _kf_pose_np(self) -> np.ndarray:
        """Host copy of the keyframe poses, refreshed only after events
        that move them (insertion, BA, compaction)."""
        if self._kf_pose_host is None or self._kf_pose_dirty:
            self._kf_pose_host = self.map.kf_pose.cpu().numpy()
            self._kf_pose_dirty = False
        return self._kf_pose_host

    def _log_pose(self, frame_id: int, T) -> Optional[np.ndarray]:
        if T is not None:
            ref_kf = self.last_ref_kf if self.last_ref_kf >= 0 \
                else max(self._host_n_kf - 1, 0)
            T_rel = np.asarray(T) @ np.linalg.inv(self._kf_pose_np()[ref_kf])
            self.trajectory.append((frame_id, ref_kf, T_rel))
        return T

    # ------------------------------------------------------------------
    def _initialize_with_depth(self, frame: Frame, sd, frame_id: int):
        """Stereo / RGB-D bootstrap (reference
        Tracking::StereoInitialization): one keyframe at the origin with
        depth-backprojected landmarks, once 50 keypoints have a depth."""
        if int((sd.valid & frame.valid).sum()) < 50:
            return
        N = frame.uv.shape[0]
        dev = self.device
        m, k = lm.insert_keyframe(
            self.cfg, self.map, frame, torch.eye(4, device=dev), frame_id,
            torch.full((N,), -1, dtype=torch.int32, device=dev))
        m = lm.add_depth_points(self.cfg, m, k, sd.depth, close_only=False)
        m = lm.refresh_point_geometry(self.cfg, m)
        self.map = m
        self._kf_pose_dirty = True
        self.state = "OK"
        self._host_n_kf = 1
        self.last_T = np.eye(4, dtype=np.float32)
        self.last_kp_pt = m.kf_obs_pt[0]
        self.last_level = frame.level
        self.velocity = None
        self.frames_since_kf = 0
        self.ref_kf_matches = int((self.last_kp_pt >= 0).sum())
        self._host_n_pt = self.ref_kf_matches
        self.last_ref_kf = 0
        self.db.add(0, frame.desc, frame.valid)

    def _try_initialize(self, frame: Frame, frame_id: int):
        tr = self.cfg.tracker
        if self.ref_frame is None:
            if int(frame.valid.sum()) > tr.init_min_keypoints:
                self.ref_frame = frame
                self.ref_frame_id = frame_id
            return
        samples = self.init_draws.get(frame_id)
        gen = None
        if samples is not None:
            samples = torch.as_tensor(np.asarray(samples, np.int64),
                                      device=self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(frame_id))
        m2, _kp_pt1, scalars = _init_attempt(
            self.cfg, self.map, self.ref_frame, frame, self.ref_frame_id,
            frame_id, samples=samples, generator=gen)
        success, n_matches, n_pts, n_kp = [int(v) for v in torch.stack(
            [s.to(torch.int64) for s in scalars]).cpu()]
        if not success:
            if n_matches < tr.init_min_matches:
                # too weak — restart from this frame (Tracking.cc:590-600)
                self.ref_frame = frame if n_kp > tr.init_min_keypoints \
                    else None
                self.ref_frame_id = frame_id
            return
        self.map = m2
        self._kf_pose_dirty = True
        self.state = "OK"
        self._host_n_kf = 2
        self.last_T = m2.kf_pose[1].cpu().numpy()
        self.last_kp_pt = m2.kf_obs_pt[1]
        self.last_level = frame.level
        self.velocity = None
        self.frames_since_kf = 0
        self.ref_kf_matches = n_pts
        self._host_n_pt = n_pts
        self.last_ref_kf = 1
        # the two bootstrap keyframes enter the place-recognition DB like
        # any other (KeyFrameDatabase.cc:40)
        self.db.add(0, self.ref_frame.desc, self.ref_frame.valid)
        self.db.add(1, frame.desc, frame.valid)
        self.trajectory.append((self.ref_frame_id, 0,
                                np.eye(4, dtype=np.float32)))

    # ------------------------------------------------------------------
    def _track(self, frame_id: int, frame: Frame) -> np.ndarray:
        """Per-frame tracking (Tracking.cc:267-563): motion model + local
        map in the OK state, a relocalization attempt in the LOST state or
        when motion tracking fails outright, dead reckoning while lost;
        then the keyframe decision and insert in mapping mode."""
        T_pred = torch.as_tensor(
            self.velocity @ self.last_T if self.velocity is not None
            else self.last_T, dtype=torch.float32, device=self.device)
        res2 = None
        if self.state != "LOST":
            radius = 15.0 if self.velocity is not None else 30.0
            _n1, res2, self.map = tracking.track_frame_built(
                self.cfg, self.map, frame, self.last_kp_pt, self.last_level,
                T_pred, torch.tensor(radius, dtype=torch.float32,
                                     device=self.device),
                ref_kf=torch.tensor(self.last_ref_kf, dtype=torch.int32,
                                    device=self.device))
        if res2 is None or int(res2.n_inliers) < 10:
            # lost before, or motion tracking failed outright: the reference
            # falls through to Relocalization (Tracking.cc:366-380)
            res = self._attempt_relocalization(frame)
            if res is not None:
                res2, self.map = tracking.track_local_map(
                    self.cfg, self.map, frame, res.T, res.kp_pt)
        n_inl = int(res2.n_inliers) if res2 is not None else 0
        if n_inl < 10:
            # lost: constant-velocity dead reckoning until a relocalization
            # succeeds
            self.state = "LOST"
            T_np = T_pred.cpu().numpy()
            self.velocity = None
            self.last_T = T_np
            self.last_kp_pt = torch.full_like(self.last_kp_pt, -1)
            self.stats.append({"frame": frame_id, "inliers": 0, "lost": True})
            return T_np
        T_np = res2.T.cpu().numpy()
        need_close = False
        if self.cfg.sensor != "mono" and self._cur_depth is not None:
            tracked, untracked = tracking.close_counts(
                self.cfg, self._cur_depth, frame.valid, res2.kp_pt)
            need_close = int(tracked) < 100 and int(untracked) > 70
        self.state = "OK"
        self.velocity = T_np @ np.linalg.inv(self.last_T)
        self.last_T = T_np
        self.last_kp_pt = res2.kp_pt
        self.last_level = frame.level
        self.last_ref_kf = int(res2.ref_kf)
        self.ref_kf_matches = int(res2.n_ref_matches)
        self.frames_since_kf += 1
        self.stats.append({"frame": frame_id, "inliers": n_inl, "lost": False})
        if not self.localization_only \
                and self._need_keyframe(n_inl, need_close):
            self._insert_keyframe(frame, frame_id)
            # the frame is the new keyframe: report its BA-adjusted pose
            T_np = np.asarray(self.last_T)
        return T_np

    def _attempt_relocalization(self, frame: Frame):
        """Place recognition + EPnP RANSAC + pose refinement against each
        of the best candidates (Tracking::Relocalization, Tracking.cc:1343).
        Returns the TrackResult with the most inliers at or above the
        acceptance gate (Tracking.cc:1459 `if(nGood>=50)`), or None."""
        gate = self.cfg.tracker.min_inliers_reloc
        best, best_n = None, 0
        for c in self.db.detect_reloc_candidates(frame.desc, frame.valid,
                                                 top_k=5):
            samples = self.reloc_draws.get((self.n_frames_tracked, c))
            gen = None
            if samples is not None:
                samples = torch.as_tensor(np.asarray(samples, np.int64),
                                          device=self.device)
            else:
                # keyed by frame count and candidate, so independent of the
                # order and number of attempts made before
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.n_frames_tracked * 1_000_003 + c)
            res = tracking.relocalize_against_kf(
                self.cfg, self.map, frame, c, samples=samples, generator=gen)
            n = int(res.n_inliers)
            if n >= gate and (best is None or n > best_n):
                best, best_n = res, n
        if best is not None:
            self.n_relocalizations += 1
        return best

    # ------------------------------------------------------------------
    def run_sequence(self, images, frame_ids=None, timestamps=None,
                     depths=None, right_images=None,
                     chunk: Optional[int] = None):
        """Track a (sub)sequence with the chunked driver: C frames per
        `tracking.track_chunk` call and one host readback of the per-frame
        results per chunk.  Initialisation runs per frame.  A chunk is cut
        before its first degraded frame (<= 20 inliers); at the first
        keyframe flag the accepted prefix is kept with its unflagged
        suffix, and the keyframe is inserted either overlapped (the backend
        queued on the device, the carry chained with
        `tracking.chain_carry_after_insert`, its bookkeeping deferred to
        the next chunk) or, at a capacity watermark, synchronously
        (`_insert_keyframes_batch`, which may compact the map).
        `depths` (RGB-D) / `right_images` (stereo) ride along with the
        images: per frame on the per-frame path, stacked per chunk as
        `track_chunk`'s `aux_imgs`."""
        n = len(images)
        C = chunk if chunk is not None else self.cfg.tracker.chunk_frames
        fid = (lambda i: frame_ids[i]) if frame_ids is not None else \
            (lambda i: i)
        ts = (lambda i: timestamps[i]) if timestamps is not None else \
            (lambda i: None)

        aux_seq = depths if depths is not None else right_images

        def track_one(i):
            if depths is not None:
                return self.track_rgbd(images[i], depths[i], fid(i), ts(i))
            if right_images is not None:
                return self.track_stereo(images[i], right_images[i],
                                         fid(i), ts(i))
            return self.track_mono(images[i], fid(i), ts(i))

        i = 0
        carry = None
        while i < n:
            if self.state != "OK" or self._pf_cooldown > 0:
                if self.state == "OK" and self._pf_cooldown > 0:
                    self._pf_cooldown -= 1
                # a deferred loop closure / global BA collected here moves
                # every keyframe pose; the tracker's motion prior (last_T /
                # velocity) is re-expressed in the corrected frame, as in
                # the limit == 0 path below
                kf_pose_snap = self.map.kf_pose
                moved = self._flush_pending()
                if carry is not None:
                    self._sync_host_from_carry(carry)
                    carry = None
                if moved and self.last_ref_kf >= 0:
                    self._reexpress_last_T(kf_pose_snap)
                track_one(i)
                if self.state == "OK" and self.stats \
                        and self.stats[-1].get("inliers", 99) < 25:
                    self._pf_cooldown = max(self._pf_cooldown, 1)
                i += 1
                continue
            real = min(C, n - i)
            src = [i + j for j in range(real)] + [i + real - 1] * (C - real)
            imgs = torch.stack([self._to_device(images[j]) for j in src])
            aux_imgs = None if aux_seq is None else torch.stack(
                [self._to_device(aux_seq[j]) for j in src])
            if carry is None:
                carry = self._carry_from_host()
            # the poses this chunk tracks against (a reference, no copy)
            kf_pose_snap = self.map.kf_pose
            ml = (torch.tensor(self._mapper_latency, dtype=torch.int32,
                               device=self.device)
                  if self.cfg.tracker.mapper_latency_frames < 0 else None)
            carry2, steps, frames, kp_pts, vis_snap, found_snap, kp_depths \
                = tracking.track_chunk(self.cfg, self.map, imgs,
                                       not self.localization_only, carry,
                                       aux_imgs, mapper_latency=ml)
            if aux_imgs is None:
                kp_depths = None
            # the previous chunk's deferred keyframe bookkeeping
            map_moved = self._flush_pending()
            out = tracking.ChunkStep(*[t.cpu().numpy() for t in steps])
            oks = out.ok
            first_bad = int(np.argmin(oks)) if not oks.all() else C
            degraded = out.n_inliers <= 20
            deg_idx = np.nonzero(degraded[:first_bad])[0]
            limit = int(deg_idx[0]) if deg_idx.size else first_bad
            limit = min(limit, real)   # padded tail frames are never accepted

            self.n_frames_chunked += real
            if limit == 0:
                # no usable prefix: the per-frame path arbitrates this frame
                self.n_frames_discarded += real
                self._pf_cooldown = C
                self._sync_host_from_carry(carry)
                if map_moved and self.last_ref_kf >= 0:
                    self._reexpress_last_T(kf_pose_snap)
                track_one(i)
                i += 1
                carry = None
                continue

            needs = out.need_kf
            flag_idx = np.nonzero(needs[:limit])[0]
            j1 = int(flag_idx[0]) if flag_idx.size else None
            # spliced acceptance: cut at the first keyframe flag but keep
            # the unflagged suffix tracked against the pre-insert map
            if j1 is None:
                n_acc = limit
            else:
                n_acc = j1 + 1
                while n_acc < limit and not needs[n_acc]:
                    n_acc += 1
            self.n_frames_discarded += real - n_acc

            for j in range(n_acc):
                self._note_frame(fid(i + j), ts(i + j))
                self.trajectory.append((fid(i + j), int(out.ref_kf[j]),
                                        out.T_rel[j]))
                self.stats.append({"frame": fid(i + j),
                                   "inliers": int(out.n_inliers[j]),
                                   "lost": False})
            self.ref_kf_matches = int(out.n_ref_matches[n_acc - 1])
            self.frames_since_kf += n_acc
            last = n_acc - 1
            # the chunk's visibility statistics up to its last accepted frame
            vis, found = ((carry2.pt_visible, carry2.pt_found)
                          if n_acc == C
                          else (vis_snap[last], found_snap[last]))

            if map_moved:
                # a deferred loop closure / global BA moved the map while
                # this chunk was in flight: accept the frames (their anchors
                # re-express automatically) but do not insert from stale
                # state — the c2 condition persists, so the next chunk
                # re-flags.  Rebuild the tracking state in the corrected
                # frame.
                ref = int(out.ref_kf[last])
                self.map = self.map._replace(pt_visible=vis, pt_found=found)
                self.last_T = (out.T_rel[last]
                               @ self._kf_pose_np()[ref]).astype(np.float32)
                self.velocity = None
                self.last_kp_pt = kp_pts[last] if n_acc < C else carry2.kp_pt
                self.last_level = frames.level[last] if n_acc < C \
                    else carry2.level
                self.last_ref_kf = ref
                carry = None
                i += n_acc
                continue

            if j1 is not None and self._capacity_headroom_ok():
                # overlapped insert: queue the backend, chain the carry on
                # the device, defer the bookkeeping
                self.map = self.map._replace(pt_visible=vis, pt_found=found)
                # InterruptBA (LocalMapping.cc:615-631): a keyframe inside
                # the mapper cycle of the previous one gets the truncated BA
                fs_at_flag = self.frames_since_kf - n_acc + j1 + 1
                ba_iters = 2 if fs_at_flag < self._mapper_busy_frames else 4
                depth_j = kp_depths[j1] if kp_depths is not None else None
                m2, _k, aux = lm.backend_insert(
                    self.cfg, self.map, _frame_at(frames, j1), steps.T[j1],
                    fid(i + j1), kp_pts[j1], depth_j is not None, depth_j,
                    self.db.vocab, ba_iters=ba_iters)
                self.map = m2
                kf_i = self._host_n_kf
                self._host_n_kf += 1
                self._host_n_pt += 2 * self.cfg.extractor.max_keypoints
                #   (conservative; exact at flush)
                self._pending_kf.append((kf_i, aux, time.perf_counter()))
                self._kf_pose_dirty = True
                self.stats[-(n_acc - j1)]["keyframe"] = True
                self.trajectory[-(n_acc - j1)] = (
                    fid(i + j1), kf_i, np.eye(4, dtype=np.float32))
                carry = tracking.chain_carry_after_insert(
                    carry, m2, steps.T, kp_pts, frames.level, j1, last, kf_i,
                    last - j1)
                self.frames_since_kf = last - j1
            elif j1 is not None:
                # capacity watermark: synchronous insert (handles
                # compaction / growth), host-state rebuild
                self.map = self.map._replace(pt_visible=vis, pt_found=found)
                prev_T = out.T[last - 1] if last >= 1 else self.last_T
                self.last_T = out.T[last]
                self.velocity = self.last_T @ np.linalg.inv(prev_T) \
                    if (last >= 1 or self.velocity is not None) else None
                self.last_kp_pt = kp_pts[last] if n_acc < C else carry2.kp_pt
                self.last_level = frames.level[last] if n_acc < C \
                    else carry2.level
                self.last_ref_kf = int(out.ref_kf[last])
                last_kf_i = self._insert_keyframes_batch(
                    [(j1, fid(i + j1))], frames, kp_pts, out, kp_depths)
                self.stats[-(n_acc - j1)]["keyframe"] = True
                self.frames_since_kf = n_acc - 1 - j1
                self.trajectory[-(n_acc - j1)] = (
                    fid(i + j1), last_kf_i, np.eye(4, dtype=np.float32))
                if j1 == n_acc - 1:
                    # the keyframe is the final accepted frame: tracking
                    # continues from its post-backend row and pose
                    self.last_kp_pt = self.map.kf_obs_pt[last_kf_i]
                    self.last_T = self._last_insert_pose
                    self.last_ref_kf = last_kf_i
                carry = None
            elif n_acc == C:
                carry = carry2        # clean chunk: chain on device
            else:
                # degradation cut without keyframe: host-state rebuild
                self.map = self.map._replace(pt_visible=vis, pt_found=found)
                prev_T = out.T[last - 1] if last >= 1 else self.last_T
                self.last_T = out.T[last]
                self.velocity = self.last_T @ np.linalg.inv(prev_T) \
                    if (last >= 1 or self.velocity is not None) else None
                self.last_kp_pt = kp_pts[last]
                self.last_level = frames.level[last]
                self.last_ref_kf = int(out.ref_kf[last])
                carry = None
            i += n_acc
        self._flush_pending()
        if carry is not None:
            self._sync_host_from_carry(carry)

    def _reexpress_last_T(self, kf_pose_before: torch.Tensor):
        """After a correction moved the keyframes: carry the tracker's pose
        over through its reference keyframe and drop the velocity."""
        r = self.last_ref_kf
        self.last_T = (self.last_T
                       @ np.linalg.inv(kf_pose_before[r].cpu().numpy())
                       @ self._kf_pose_np()[r]).astype(np.float32)
        self.velocity = None

    def _capacity_headroom_ok(self) -> bool:
        """True when the overlapped insert cannot need compaction or
        growth (which remap slot ids and must synchronize)."""
        K = self.cfg.mapper.max_keyframes
        P = self.cfg.mapper.max_points
        N = self.cfg.extractor.max_keypoints
        return (self._host_n_kf + 1 < K - 1
                and self._host_n_pt + 2 * N < 0.95 * P)

    def _carry_from_host(self) -> tracking.ChunkCarry:
        dev = self.device
        vel = self.velocity if self.velocity is not None \
            else np.eye(4, dtype=np.float32)
        return tracking.ChunkCarry(
            T=torch.as_tensor(self.last_T, dtype=torch.float32, device=dev),
            vel=torch.as_tensor(vel, dtype=torch.float32, device=dev),
            has_vel=torch.tensor(self.velocity is not None, device=dev),
            kp_pt=torch.as_tensor(self.last_kp_pt, device=dev),
            level=torch.as_tensor(self.last_level, device=dev),
            frames_since_kf=torch.tensor(self.frames_since_kf,
                                         dtype=torch.int32, device=dev),
            ref_kf=torch.tensor(self.last_ref_kf, dtype=torch.int32,
                                device=dev),
            pt_visible=self.map.pt_visible, pt_found=self.map.pt_found)

    def _sync_host_from_carry(self, carry: tracking.ChunkCarry):
        """Pull the chunk-carried tracking state back into the host
        mirrors."""
        self.last_T = carry.T.cpu().numpy()
        self.velocity = carry.vel.cpu().numpy() if bool(carry.has_vel) \
            else None
        self.last_kp_pt = carry.kp_pt
        self.last_level = carry.level
        self.last_ref_kf = int(carry.ref_kf)
        self.map = self.map._replace(pt_visible=carry.pt_visible,
                                     pt_found=carry.pt_found)

    def _close_loops(self, m: ms.MapState, kf_i: int, covis_row):
        """The loop closer's turn on keyframe `kf_i`: a global BA deferred
        from an earlier closure (unless a newer loop supersedes it, the
        reference's abort-on-new-loop semantics, LoopClosing.cc:579), then
        detection / verification / correction.  Returns (map, moved)."""
        m2 = self.loop_closer.maybe_run_gba(m)
        moved = m2 is not m
        m2, closed = self.loop_closer.on_keyframe(m2, kf_i,
                                                  covis_row=covis_row)
        if closed:
            moved = True
            self.n_loops_closed += 1
            m2 = lm.refresh_point_geometry(self.cfg, m2)
            if self.stats:
                self.stats[-1]["loop_closed"] = True
        return m2, moved

    def _flush_pending(self) -> bool:
        """Collect the deferred bookkeeping of overlapped inserts: BoW rows
        into the place-recognition DB, the exact point count, the deferred
        global BA and loop closing on the newest keyframe.  Returns True if
        the map's poses moved (loop closure / global BA), which invalidates
        any chunk carry in flight."""
        if not self._pending_kf:
            return False
        pend = self._pending_kf
        self._pending_kf = []
        rows = torch.stack([a["bow_row"] for _, a, _t in pend]).cpu().numpy()
        n_pt = int(pend[-1][1]["n_pt"])
        # readback ~= the queued backend finishing on the device
        self._note_insert_cost(time.perf_counter() - pend[-1][2])
        for (kf_i, _, _t), bow_row in zip(pend, rows):
            self.db.add_row(kf_i, bow_row)
        self._host_n_pt = n_pt
        self.db.maybe_retrain(self.map)
        moved = False
        if self.loop_closer is not None:
            covis_row = pend[-1][1]["covis_row"].cpu().numpy()
            self.map, moved = self._close_loops(self.map, pend[-1][0],
                                                covis_row)
        if moved:
            self._kf_pose_dirty = True
        return moved

    def _insert_keyframes_batch(self, jobs, frames, kp_pts, out,
                                kp_depths=None) -> int:
        """Insert a chunk's flagged keyframes synchronously, after making
        room for all of them (`_ensure_capacity`, which may compact the
        map and remap the chunk's pending bindings).  Each insert's pose
        is re-expressed in the map frame left by the previous insert's BA
        (raw_pose @ corr).  A depth-sensor keyframe takes its per-keypoint
        depth from the chunk (`kp_depths`, None for mono).  The reference's
        `_depth_for`, which recomputes it where the chunk gave none, is not
        ported: its one caller passes the chunk's depth whenever a sensor
        gives one, so it never runs in either package."""
        cfg = self.cfg
        N = cfg.extractor.max_keypoints
        self._pending_pt_arrays = [kp_pts]
        self._ensure_capacity(kf_headroom=len(jobs),
                              pt_headroom=len(jobs) * N)
        kp_pts = self._pending_pt_arrays[0]
        self._pending_pt_arrays = []
        pend = []
        corr = None
        for jq, frame_id in jobs:
            frame_j = _frame_at(frames, jq)
            depth_j = kp_depths[jq] if kp_depths is not None else None
            T_raw = torch.as_tensor(out.T[jq], device=self.device)
            T_in = T_raw if corr is None else T_raw @ corr
            m, _k, aux = lm.backend_insert(
                cfg, self.map, frame_j, T_in, frame_id, kp_pts[jq],
                depth_j is not None, depth_j, self.db.vocab)
            self.map = m
            corr = geo.se3_inverse(T_raw) @ aux["pose"]
            kf_i = self._host_n_kf
            self._host_n_kf += 1
            pend.append((kf_i, aux))
        rows = torch.stack([a["bow_row"] for _, a in pend]).cpu().numpy()
        for (kf_i, _), bow_row in zip(pend, rows):
            self.db.add_row(kf_i, bow_row)
        self._host_n_pt = int(pend[-1][1]["n_pt"])
        # re-anchor the tracker's pose to the corrected map frame
        j_last = jobs[-1][0]
        T_post = pend[-1][1]["pose"].cpu().numpy()
        self._last_insert_pose = T_post
        self.last_T = (self.last_T @ np.linalg.inv(out.T[j_last])
                       @ T_post).astype(np.float32)
        self._kf_pose_dirty = True
        self.db.maybe_retrain(self.map)
        if self.loop_closer is not None:
            covis_row = pend[-1][1]["covis_row"].cpu().numpy()
            self.map, _ = self._close_loops(self.map, pend[-1][0], covis_row)
        return pend[-1][0]

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_inliers: int,
                       need_close: bool = False) -> bool:
        """NeedNewKeyFrame (reference Tracking.cc:979-1063):
        (c1a || c1b || c1c) && c2.  Mono: ratio 0.9, no c1c, throttled to
        the mapper latency.  Depth sensors: ratio 0.75 (0.4 while the map
        has one keyframe), c1c = under a quarter of the reference
        keyframe's matches or the close-point term `need_close`
        (Tracking.cc:1020-1037), unthrottled."""
        tr = self.cfg.tracker
        n_ref = self.ref_kf_matches
        mono = self.cfg.sensor == "mono"
        if mono:
            ratio = tr.ref_ratio_mono
        else:
            ratio = 0.4 if self._host_n_kf < 2 else 0.75
        c1a = self.frames_since_kf >= tr.max_frames
        c1b = self.frames_since_kf >= tr.min_frames
        c1c = not mono and (n_inliers < n_ref * 0.25 or need_close)
        c2 = (n_inliers < n_ref * ratio or need_close) and n_inliers > 15
        if mono and self.frames_since_kf < self._mapper_latency:
            return False
        return bool((c1a or c1b or c1c) and c2)

    def _ensure_capacity(self, kf_headroom: int = 1,
                         pt_headroom: Optional[int] = None):
        """At capacity watermarks (checked against the host mirrors of
        n_kf / n_pt), compact culled slots away (models/compaction.py); if
        that cannot free enough, double the capacity."""
        K = self.cfg.mapper.max_keyframes
        P = self.cfg.mapper.max_points
        N = self.cfg.extractor.max_keypoints
        if pt_headroom is None:
            pt_headroom = N
        if (self._host_n_kf + kf_headroom < K - 1
                and self._host_n_pt + pt_headroom < 0.95 * P):
            return
        old = self.map
        new_m, kf_map, pt_map = compaction.compact(self.cfg, old)
        self._remap_after_compact(old, new_m, kf_map, pt_map)
        self.map = new_m
        self._kf_pose_dirty = True
        n_kf, n_pt = int(new_m.n_kf), int(new_m.n_pt)
        self._host_n_kf = n_kf
        self._host_n_pt = n_pt
        grow_K = 2 * K if n_kf >= K - max(4, K // 16) else 0
        grow_P = 2 * P if n_pt >= 0.90 * P else 0
        if grow_K or grow_P:
            cfg2, m2 = compaction.grow(self.cfg, self.map,
                                       grow_K or K, grow_P or P)
            self.map = m2
            self._set_cfg(cfg2)

    def _remap_after_compact(self, old, new_m, kf_map, pt_map):
        """Point every host-side slot reference at the compacted layout."""
        K = kf_map.shape[0]
        kf_valid_old = old.kf_valid.cpu().numpy()
        # last surviving keyframe at-or-before each old slot
        alive_before = np.maximum(np.cumsum(kf_valid_old) - 1, 0)
        old_poses = old.kf_pose.cpu().numpy()

        def remap_kf(i: int) -> int:
            i = int(np.clip(i, 0, K - 1))
            return int(kf_map[i]) if kf_map[i] >= 0 else int(alive_before[i])

        # trajectory anchors: culled refs are re-expressed against the
        # nearest surviving keyframe using the old poses
        new_traj = []
        for fid, ref, T_rel in self.trajectory:
            ref = int(np.clip(ref, 0, K - 1))
            if kf_map[ref] >= 0:
                new_traj.append((fid, int(kf_map[ref]), T_rel))
            else:
                fb_old = int(np.nonzero(kf_valid_old)[0][alive_before[ref]]) \
                    if kf_valid_old.any() else 0
                T_w = T_rel @ old_poses[ref]
                T_rel2 = T_w @ np.linalg.inv(old_poses[fb_old])
                new_traj.append((fid, int(alive_before[ref]), T_rel2))
        self.trajectory = new_traj

        def remap_pts(a: torch.Tensor) -> torch.Tensor:
            a = a.cpu().numpy()
            return torch.from_numpy(np.where(
                a >= 0, pt_map[np.maximum(a, 0)], -1).astype(np.int32)) \
                .to(self.device)

        if self.last_kp_pt is not None:
            self.last_kp_pt = remap_pts(self.last_kp_pt)
        self._pending_pt_arrays = [remap_pts(a)
                                   for a in self._pending_pt_arrays]
        self.last_ref_kf = remap_kf(self.last_ref_kf) \
            if self.last_ref_kf >= 0 else -1
        self.db.remap(kf_map, new_K=kf_map.shape[0])
        if self.loop_closer is not None:
            self.loop_closer.remap(kf_map, remap_kf)

    def _set_cfg(self, cfg2: SystemConfig):
        self.cfg = cfg2
        self.db.cfg = cfg2
        self.db.grow(cfg2.mapper.max_keyframes)
        if self.loop_closer is not None:
            self.loop_closer.cfg = cfg2

    def _insert_keyframe(self, frame: Frame, frame_id: int) -> int:
        """Per-frame keyframe insert: make room, run the backend, store the
        BoW row, then place recognition and loop closing (the reference's
        LoopClosing thread; here a synchronous stage after local mapping).
        Uses self.last_kp_pt, which `_ensure_capacity` remaps if
        it compacted the map."""
        self._ensure_capacity()
        has_depth = self._cur_depth is not None
        m, k, aux = lm.backend_insert(
            self.cfg, self.map, frame,
            torch.as_tensor(self.last_T, dtype=torch.float32,
                            device=self.device),
            frame_id, self.last_kp_pt, has_depth, self._cur_depth,
            self.db.vocab)
        # one bundled readback: slot, point count, BoW row, pose
        head = torch.stack([k.to(torch.int64), aux["n_pt"].to(torch.int64)])
        (kf_i, n_pt), bow_row, pose = [
            t.cpu().numpy() for t in (head, aux["bow_row"], aux["pose"])]
        kf_i = int(kf_i)
        self._host_n_kf = kf_i + 1
        self._host_n_pt = int(n_pt)
        self.db.add_row(kf_i, bow_row)
        self.db.maybe_retrain(m)
        if self.loop_closer is not None:
            m, pose_moved = self._close_loops(
                m, kf_i, aux["covis_row"].cpu().numpy())
            if pose_moved:
                # tracking references the corrected new-keyframe pose
                pose = m.kf_pose[kf_i].cpu().numpy()
        self.map = m
        self._kf_pose_dirty = True
        self.last_T = pose
        self.last_kp_pt = m.kf_obs_pt[kf_i]
        self.last_ref_kf = kf_i
        self.frames_since_kf = 0
        if self.stats:
            self.stats[-1]["keyframe"] = True
        return kf_i

    # ------------------------------------------------------------------
    def trajectory_poses(self):
        """(frame ids, (F, 4, 4) Tcw array) reconstructed against the
        current keyframe poses."""
        if not self.trajectory:
            return [], np.zeros((0, 4, 4), np.float32)
        kf_poses = self._kf_pose_np()
        ids = [fid for fid, _, _ in self.trajectory]
        poses = np.stack([T_rel @ kf_poses[ref]
                          for _, ref, T_rel in self.trajectory])
        return ids, poses

    def reset(self):
        """Clear map, place-recognition DB and tracking state (reference
        System::Reset, System.h:92 -> Tracking::Reset, Tracking.cc:1506)."""
        self.map = ms.empty_map(self.cfg, self.device)
        self._kf_pose_dirty = True
        self._host_n_kf = 0
        self._host_n_pt = 0
        self._pending_kf = []
        self.db = kdb.KeyFrameDatabase(self.cfg, device=self.device)
        if self.loop_closer is not None:
            self.loop_closer = lc.LoopCloser(self.cfg, self.db)
            self.loop_closer.sim3_draws = self.sim3_draws
        self.state = "NOT_INITIALIZED"
        self.ref_frame = None
        self.ref_frame_id = -1
        self.last_T = np.eye(4, dtype=np.float32)
        self.velocity = None
        self.last_kp_pt = None
        self.last_level = None
        self.frames_since_kf = 0
        self.ref_kf_matches = 0
        self.last_ref_kf = -1
        self.trajectory.clear()
        self.stats.clear()
        self.timestamps.clear()
        self.n_loops_closed = 0

    def get_tracked_map_points(self) -> np.ndarray:
        """Map-point ids associated to the last frame's keypoints, -1 where
        none (reference System::GetTrackedMapPoints, System.h:122)."""
        if self.last_kp_pt is None:
            return np.empty(0, np.int32)
        return self.last_kp_pt.cpu().numpy()

    def get_tracked_keypoints_un(self) -> np.ndarray:
        """Undistorted keypoints of the newest keyframe
        (System::GetTrackedKeyPointsUn, System.h:123)."""
        return self.map.kf_uv[max(self._host_n_kf - 1, 0)].cpu().numpy()

    def shutdown(self) -> dict:
        """Finish all queued work and report run statistics (reference
        System::Shutdown, System.h:97)."""
        self._flush_pending()
        if self.loop_closer is not None:
            # flush a deferred global BA so the exported map is consistent
            self.map = self.loop_closer.maybe_run_gba(self.map)
            self._kf_pose_dirty = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n_kf = int(self.map.kf_valid.sum())
        n_pt = int(self.map.pt_valid.sum())
        return {"frames": self.n_frames_tracked, "keyframes": n_kf,
                "map_points": n_pt, "loops_closed": self.n_loops_closed,
                "relocalizations": self.n_relocalizations,
                "frames_chunked": self.n_frames_chunked,
                "frames_discarded": self.n_frames_discarded,
                "chunk_discard_rate": round(
                    self.n_frames_discarded
                    / max(self.n_frames_chunked, 1), 4)}

    def save_trajectory_tum(self, path: str):
        """Per-frame camera trajectory in TUM format (System.cc:325)."""
        from coslam_tpu_torch.utils import io
        ids, poses = self.trajectory_poses()
        io.save_trajectory_tum(path, [self.timestamps.get(i, float(i))
                                      for i in ids], poses)

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only trajectory in TUM format (System.cc:386)."""
        from coslam_tpu_torch.utils import io
        kf_valid = self.map.kf_valid.cpu().numpy()
        poses = self.map.kf_pose.cpu().numpy()[kf_valid]
        fids = self.map.kf_frame_id.cpu().numpy()[kf_valid]
        io.save_trajectory_tum(path, [self.timestamps.get(int(i), float(i))
                                      for i in fids], poses)

    def save_trajectory_kitti(self, path: str):
        """Per-frame trajectory in KITTI format (System.cc:422)."""
        from coslam_tpu_torch.utils import io
        _, poses = self.trajectory_poses()
        io.save_trajectory_kitti(path, poses)
