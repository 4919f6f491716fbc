"""System facade + per-frame orchestration (port of coslam_tpu/models/
system.py, localization mode).

Ported: tracking in the OK state against a frozen map — the reference's
System::ActivateLocalizationMode (System.cc:237) after resuming a saved map
(utils/checkpoint.load_system) — through `track_mono` and the chunked
steady-state loop `run_sequence`.  Still to port, each raising
NotImplementedError that names its ROADMAP item: monocular initialisation
(NOT_INITIALIZED), relocalization (a frame with < 10 inliers) and keyframe
insertion (mapping mode, i.e. localization mode off).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.models import tracking
from coslam_tpu_torch.models.frame import Frame, build_frame


class System:
    """Monocular SLAM engine instance (reference System ctor System.cc:32 +
    TrackMonocular :219) on `device`."""

    def __init__(self, cfg: SystemConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = ms.empty_map(cfg, self.device)
        # place-recognition state from a loaded checkpoint (numpy), kept for
        # the relocalization port
        self.db_state: dict = {}
        self.state = "NOT_INITIALIZED"
        self.last_T = np.eye(4, dtype=np.float32)
        self.velocity: Optional[np.ndarray] = None
        self.last_kp_pt: Optional[torch.Tensor] = None
        self.last_level: Optional[torch.Tensor] = None
        self.frames_since_kf = 0
        self.ref_kf_matches = 0
        self.last_ref_kf = -1
        # per-frame log: (frame_id, ref_kf, T_frame_wrt_refkf)
        self.trajectory: List[Tuple[int, int, np.ndarray]] = []
        self.stats: List[dict] = []
        self.timestamps: dict = {}
        self.localization_only = False
        self.n_frames_tracked = 0
        self._host_n_kf = 0
        # host copy of the keyframe poses: the map is frozen in localization
        # mode, so it is fetched once per load (load_system resets it)
        self._kf_pose_host: Optional[np.ndarray] = None
        self.n_frames_chunked = 0
        self._pf_cooldown = 0

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Stop mapping; keep tracking against the frozen map (reference
        System::ActivateLocalizationMode, System.h:80 / System.cc:237)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        """Resume full SLAM (System::DeactivateLocalizationMode)."""
        self.localization_only = False

    def _check_ported(self):
        if not self.localization_only:
            raise NotImplementedError(
                "mapping mode needs keyframe insertion, which is not ported "
                "yet (ROADMAP Queue 1 item 10, the keyframe backend); call "
                "activate_localization_mode() to track against a loaded map")
        if self.state == "NOT_INITIALIZED":
            raise NotImplementedError(
                "monocular initialisation is not ported yet (ROADMAP Queue 1 "
                "item 9); resume a saved map with "
                "utils.checkpoint.load_system first")

    def _to_device(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img)).to(self.device)

    # ------------------------------------------------------------------
    def track_mono(self, img, frame_id: int,
                   timestamp: Optional[float] = None) -> Optional[np.ndarray]:
        self._check_ported()
        self._note_frame(frame_id, timestamp)
        frame = build_frame(self._to_device(img), self.cfg)
        T = self._track(frame_id, frame)
        return self._log_pose(frame_id, T)

    def _note_frame(self, frame_id: int, timestamp: Optional[float]):
        self.n_frames_tracked += 1
        self.timestamps[frame_id] = (float(timestamp) if timestamp is not None
                                     else float(frame_id))

    def _kf_pose_np(self) -> np.ndarray:
        if self._kf_pose_host is None:
            self._kf_pose_host = self.map.kf_pose.cpu().numpy()
        return self._kf_pose_host

    def _log_pose(self, frame_id: int, T) -> Optional[np.ndarray]:
        if T is not None:
            ref_kf = self.last_ref_kf if self.last_ref_kf >= 0 \
                else max(self._host_n_kf - 1, 0)
            T_rel = np.asarray(T) @ np.linalg.inv(self._kf_pose_np()[ref_kf])
            self.trajectory.append((frame_id, ref_kf, T_rel))
        return T

    # ------------------------------------------------------------------
    def _track(self, frame_id: int, frame: Frame) -> np.ndarray:
        """Per-frame tracking in the OK state (Tracking.cc:267-563)."""
        T_pred = torch.as_tensor(
            self.velocity @ self.last_T if self.velocity is not None
            else self.last_T, dtype=torch.float32, device=self.device)
        radius = 15.0 if self.velocity is not None else 30.0
        _n1, res2, self.map = tracking.track_frame_built(
            self.cfg, self.map, frame, self.last_kp_pt, self.last_level,
            T_pred, torch.tensor(radius, dtype=torch.float32,
                                 device=self.device),
            ref_kf=torch.tensor(self.last_ref_kf, dtype=torch.int32,
                                device=self.device))
        n_inl = int(res2.n_inliers)
        if n_inl < 10:
            raise NotImplementedError(
                f"frame {frame_id} tracked only {n_inl} inliers: "
                "relocalization is not ported yet (ROADMAP Queue 1 item 12)")
        T_np = res2.T.cpu().numpy()
        self.state = "OK"
        self.velocity = T_np @ np.linalg.inv(self.last_T)
        self.last_T = T_np
        self.last_kp_pt = res2.kp_pt
        self.last_level = frame.level
        self.last_ref_kf = int(res2.ref_kf)
        self.ref_kf_matches = int(res2.n_ref_matches)
        self.frames_since_kf += 1
        self.stats.append({"frame": frame_id, "inliers": n_inl, "lost": False})
        return T_np

    # ------------------------------------------------------------------
    def run_sequence(self, images, frame_ids=None, timestamps=None,
                     depths=None, right_images=None,
                     chunk: Optional[int] = None):
        """Track a (sub)sequence with the chunked steady-state loop: C
        frames per `tracking.track_chunk` call, one host readback of the
        per-frame results per chunk.  A chunk is cut before its first
        degraded frame (<= 20 inliers), which the per-frame path then
        tracks; a tail shorter than a chunk is padded with copies of the
        last frame and only its real prefix accepted."""
        if depths is not None or right_images is not None:
            raise NotImplementedError(
                "stereo / RGB-D tracking is not ported yet "
                "(ROADMAP Queue 1 item 14)")
        self._check_ported()
        n = len(images)
        C = chunk if chunk is not None else self.cfg.tracker.chunk_frames
        fid = (lambda i: frame_ids[i]) if frame_ids is not None else \
            (lambda i: i)
        ts = (lambda i: timestamps[i]) if timestamps is not None else \
            (lambda i: None)

        i = 0
        carry = None
        while i < n:
            if self.state != "OK" or self._pf_cooldown > 0:
                if self.state == "OK" and self._pf_cooldown > 0:
                    self._pf_cooldown -= 1
                if carry is not None:
                    self._sync_host_from_carry(carry)
                    carry = None
                self.track_mono(images[i], fid(i), ts(i))
                if self.state == "OK" and self.stats \
                        and self.stats[-1].get("inliers", 99) < 25:
                    self._pf_cooldown = max(self._pf_cooldown, 1)
                i += 1
                continue
            real = min(C, n - i)
            src = [i + j for j in range(real)] + [i + real - 1] * (C - real)
            imgs = torch.stack([self._to_device(images[j]) for j in src])
            if carry is None:
                carry = self._carry_from_host()
            carry2, steps, frames, kp_pts, vis_snap, found_snap, _ = \
                tracking.track_chunk(self.cfg, self.map, imgs,
                                     not self.localization_only, carry)
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
                self._pf_cooldown = C
                self._sync_host_from_carry(carry)
                self.track_mono(images[i], fid(i), ts(i))
                i += 1
                carry = None
                continue

            n_acc = limit   # localization mode: no keyframe flags to splice
            for j in range(n_acc):
                self._note_frame(fid(i + j), ts(i + j))
                self.trajectory.append((fid(i + j), int(out.ref_kf[j]),
                                        out.T_rel[j]))
                self.stats.append({"frame": fid(i + j),
                                   "inliers": int(out.n_inliers[j]),
                                   "lost": False})
            self.ref_kf_matches = int(out.n_ref_matches[n_acc - 1])
            self.frames_since_kf += n_acc

            if n_acc == C:
                carry = carry2        # clean chunk: chain on device
            else:
                # cut without keyframe: rebuild the host state
                last = n_acc - 1
                self.map = self.map._replace(pt_visible=vis_snap[last],
                                             pt_found=found_snap[last])
                prev_T = out.T[last - 1] if last >= 1 else self.last_T
                self.last_T = out.T[last]
                self.velocity = self.last_T @ np.linalg.inv(prev_T) \
                    if (last >= 1 or self.velocity is not None) else None
                self.last_kp_pt = kp_pts[last]
                self.last_level = frames.level[last]
                self.last_ref_kf = int(out.ref_kf[last])
                carry = None
            i += n_acc
        if carry is not None:
            self._sync_host_from_carry(carry)

    def _carry_from_host(self) -> tracking.ChunkCarry:
        dev = self.device
        vel = self.velocity if self.velocity is not None \
            else np.eye(4, dtype=np.float32)
        return tracking.ChunkCarry(
            T=torch.as_tensor(self.last_T, dtype=torch.float32, device=dev),
            vel=torch.as_tensor(vel, dtype=torch.float32, device=dev),
            has_vel=torch.tensor(self.velocity is not None, device=dev),
            kp_pt=self.last_kp_pt, level=self.last_level,
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

    # ------------------------------------------------------------------
    def trajectory_poses(self):
        """(frame ids, (F, 4, 4) Tcw array) reconstructed against the
        keyframe poses."""
        if not self.trajectory:
            return [], np.zeros((0, 4, 4), np.float32)
        kf_poses = self._kf_pose_np()
        ids = [fid for fid, _, _ in self.trajectory]
        poses = np.stack([T_rel @ kf_poses[ref]
                          for _, ref, T_rel in self.trajectory])
        return ids, poses
