"""Cooperative multi-agent layer: keyframe exchange + cross-agent map merge
(port of coslam_tpu/models/cooperative.py, whole).

The reference links two ORB-SLAM2 processes by LCM UDP multicast: the
sender serializes batches of <= 10 keyframes (ORB_SLAM2.1/.../
ros_mono.cc:1915-2399) and the receiver rebuilds KeyFrame + MapPoint
objects from the wire data — no image, no re-extraction — and hands them
to its LocalMapping / LoopClosing back end (ORB_SLAM2/.../
ros_mono.cc:2108-2192).  Here:

  * a packet (`KeyFramePacket`) is numpy arrays of the same dtypes and
    shapes as the JAX package's, so a packet of either package is a packet
    of the other, and `serialize_packet` writes the same npz fields;
  * transport is pluggable: `InMemoryBus`, or `UdpBus` over the port's own
    copy of the native UDP-multicast bus (coslam_tpu_torch/native);
  * foreign keyframes enter the receiver's map through
    `local_mapping.insert_keyframe` (no extraction, no BoW recompute); the
    back-end pass (`local_mapping.backend_post_insert`) runs for them once
    their sub-map is aligned;
  * cross-agent place recognition (BoW shortlist, landmark match counts)
    and Sim3 RANSAC align the foreign sub-map, which is then similarity-
    transformed into the local frame, fused and jointly optimized
    (`loop_closing.global_ba`).

The map's arrays stay on the agent's device; the bookkeeping (which agent
owns each keyframe and landmark, the sender-id dedup table, the stored
alignments) is host numpy, as in the JAX package.  The cross-agent Sim3
RANSAC draws (the JAX package's `PRNGKey(1234 + foreign_kf)`) come from a
`torch.Generator` seeded `1234 + foreign_kf`, unless
`CoopAgent.cross_sim3_draws[(foreign_kf, candidate)]` holds injected
(iters, 3) sample indices (parity runs inject the JAX package's draws).
"""

from __future__ import annotations

import io
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import local_mapping as lm
from coslam_tpu_torch.models import loop_closing as lc
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.models.frame import Frame
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.utils import geometry as geo
from coslam_tpu_torch.utils import profiling
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE


# the gates of one cross-agent Sim3 search (CoopAgent._find_cross_sim3) in
# the order a candidate meets them: no own keyframe scores in the BoW
# database, too few landmark matches in the shortlist, too few matched
# pairs, too few RANSAC inliers, the RANSAC scale outside its window, the
# polished Sim3 rejected (inliers or scale); `ok` is a verified Sim3
GATES = ("bow", "count", "pairs", "ransac", "scale", "polish", "ok")


class KeyFramePacket(NamedTuple):
    """Wire keyframe — the analog of lcmKeyFrameInfo (reference
    include/lcmKeyFrame/lcmKeyFrameInfo.hpp:25-150)."""
    agent_id: int
    frame_id: int
    pose: np.ndarray       # (4, 4) f32 Tcw in the SENDER's world frame
    uv: np.ndarray         # (N, 2) f32 undistorted keypoints
    level: np.ndarray      # (N,) i32
    angle: np.ndarray      # (N,) f32
    desc: np.ndarray       # (N, 8) uint32
    kp_valid: np.ndarray   # (N,) bool
    pt_flag: np.ndarray    # (N,) bool — keypoint has a landmark
    pt_world: np.ndarray   # (N, 3) f32 landmark position (sender world frame)
    pt_id: np.ndarray      # (N,) int64 stable sender landmark id (-1)


def pack_keyframe(m: ms.MapState, kf_id: int, agent_id: int) -> KeyFramePacket:
    """Serialize one keyframe + its landmarks (sender side; the analogue of
    the TX loop at reference ORB_SLAM2.1/.../ros_mono.cc:1943-2393)."""
    obs = m.kf_obs_pt[kf_id]
    pt = obs.cpu().numpy()
    flag = pt >= 0
    pos = m.pt_pos[torch.clamp(obs, min=0).long()].cpu().numpy()
    return KeyFramePacket(
        agent_id=agent_id,
        frame_id=int(m.kf_frame_id[kf_id]),
        pose=m.kf_pose[kf_id].cpu().numpy(),
        uv=m.kf_uv[kf_id].cpu().numpy(),
        level=m.kf_level[kf_id].cpu().numpy(),
        angle=m.kf_angle[kf_id].cpu().numpy(),
        desc=m.kf_desc[kf_id].cpu().numpy().view(np.uint32),
        kp_valid=m.kf_kp_valid[kf_id].cpu().numpy(),
        pt_flag=flag,
        pt_world=np.where(flag[:, None], pos, 0.0).astype(np.float32),
        pt_id=np.where(flag, pt.astype(np.int64), -1),
    )


def _add_foreign_points(cfg: SystemConfig, m: ms.MapState, pos, desc,
                        need, kf_slot_hint) -> Tuple[ms.MapState,
                                                     torch.Tensor]:
    """Allocate landmarks for a foreign keyframe's flagged keypoints that
    have not been seen before (prefix-sum slot allocation).  The slots of
    the allocated rows are distinct, so only they are written (the rest go
    to a pad row that is dropped).  Returns (map, (N,) i32 slot or -1)."""
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    cum = torch.cumsum(need.to(torch.int32), 0) - 1
    slot = m.n_pt + cum
    can = need & (slot < P)
    slot_safe = torch.where(can, slot, P).long()

    def sc(arr, vals):
        pad = torch.zeros((1,) + arr.shape[1:], dtype=arr.dtype, device=dev)
        big = torch.cat([arr, pad])
        return big.index_copy(0, slot_safe, vals.to(arr.dtype))[:-1]

    n = pos.shape[0]
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    normal[:, 2] = 1.0
    hint = torch.as_tensor(kf_slot_hint, dtype=torch.int32,
                           device=dev).expand(n)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    m = m._replace(
        pt_pos=sc(m.pt_pos, pos),
        pt_valid=sc(m.pt_valid, can),
        pt_desc=sc(m.pt_desc, desc),
        pt_normal=sc(m.pt_normal, normal),
        pt_max_dist=sc(m.pt_max_dist, torch.full((n,), 10.0, device=dev)),
        pt_ref_kf=sc(m.pt_ref_kf, hint),
        pt_first_kf=sc(m.pt_first_kf, hint),
        pt_visible=sc(m.pt_visible, ones),
        pt_found=sc(m.pt_found, ones),
        n_pt=torch.clamp(m.n_pt + can.sum(), max=P).to(torch.int32),
    )
    return m, torch.where(can, slot, -1).to(torch.int32)


def _apply_sim3_to_component(cfg: SystemConfig, m: ms.MapState,
                             s, R, t, kf_mask, pt_mask) -> ms.MapState:
    """Similarity-transform a sub-map component: X -> s R X + t for its
    landmarks; poses updated so that camera-frame coordinates are kept
    (S_kw_new = S_kw_old o S^-1, then [R | t / s])."""
    S = geo.sim3(s, R, t)
    Sinv = geo.sim3_inverse(S)
    pt_new = geo.sim3_apply(S, m.pt_pos[:, None, :])[:, 0, :]
    K = m.kf_pose.shape[0]
    R_old, t_old = m.kf_pose[:, :3, :3], m.kf_pose[:, :3, 3]
    s_n = torch.ones(K, dtype=torch.float32, device=R_old.device) * Sinv["s"]
    R_n = torch.einsum("kij,jl->kil", R_old, Sinv["R"])
    t_n = torch.einsum("kij,j->ki", R_old, Sinv["t"]) + t_old
    T_new = geo.se3(R_n, t_n / s_n[:, None])
    return m._replace(
        pt_pos=torch.where(pt_mask[:, None], pt_new, m.pt_pos),
        kf_pose=torch.where(kf_mask[:, None, None], T_new, m.kf_pose),
    )


class CoopAgent(System):
    """A SLAM agent that can publish its keyframes and integrate foreign
    ones — the union of the reference's sender (ORB_SLAM2.1) and receiver
    (ORB_SLAM2) roles — on `device` (the GPU unless the caller passes
    device="cpu")."""

    CROSS_SIM3_SEED = 1234

    def __init__(self, cfg: SystemConfig, agent_id: int = 0,
                 device=DEFAULT_DEVICE, **kw):
        super().__init__(cfg, device=device, **kw)
        self.agent_id = agent_id
        K = cfg.mapper.max_keyframes
        P = cfg.mapper.max_points
        self.kf_agent = np.full(K, -1, np.int32)
        self.pt_agent = np.full(P, -1, np.int32)
        self._kf_sent = np.zeros(K, bool)
        # sender (agent, pt_id) -> local pt slot (dedup across packets,
        # mirroring the reference's global-MapPoint-id reconstruction)
        self._foreign_pt: Dict[Tuple[int, int], int] = {}
        self._published_kfs = 0
        self._foreign_agents: set = set()
        self.merged_agents: Dict[int, bool] = {}
        # per-agent world alignment (s, R, t): x_local = s R x_sender + t
        self._agent_sim3: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
        self.n_merges = 0
        self.n_realigns = 0
        self.packets_integrated = 0
        # _try_merge attempts by the gate of _find_cross_sim3 that ended
        # them (GATES); `last_gate` is the latest search's
        self.merge_gates: Dict[str, int] = dict.fromkeys(GATES, 0)
        self.last_gate = ""
        # injected cross-agent Sim3 draws per (foreign keyframe, candidate)
        self.cross_sim3_draws: Dict[Tuple[int, int], np.ndarray] = {}

    def _tag_new_points(self, agent_id: int):
        """Landmarks that have no owner yet belong to `agent_id`."""
        self.pt_agent[self.map.pt_valid.cpu().numpy()
                      & (self.pt_agent < 0)] = agent_id

    def _need_keyframe(self, n_inliers, need_close=False):
        # nMinObs is 2 while the map holds at most 2 keyframes
        # (Tracking.cc:985-990).  The tracker counts map.n_kf, which here
        # includes an unmerged sender's keyframes in this map's slots; the
        # reference stages those apart (Map_KFV, ros_mono.cc:178,540), so
        # its young own map is counted alone.  Counting them raises nMinObs
        # to 3 and starves that map of keyframes.
        n_kf = self._host_n_kf
        pending = [a for a in self._foreign_agents
                   if not self.merged_agents.get(a)]
        if n_kf > 2 and pending and np.count_nonzero(
                ~np.isin(self.kf_agent[:n_kf], pending)) <= 2:
            m = self.map
            row = m.kf_obs_pt[self.last_ref_kf]
            safe = torch.clamp(row, min=0).long()
            ok = (row >= 0) & m.kf_kp_valid[self.last_ref_kf] \
                & m.pt_valid[safe]
            self.ref_kf_matches = int(
                (ok & (ms.point_obs_count(m)[safe] >= 2)).sum())
        return super()._need_keyframe(n_inliers, need_close)

    # -- bookkeeping hooks -------------------------------------------------
    def _note_inserted_keyframes(self, first_kf: int, count: int):
        # every own insert ends here, with the slots it filled after any
        # compaction
        self.kf_agent[first_kf: first_kf + count] = self.agent_id
        self._tag_new_points(self.agent_id)
        self._merge_retry()

    def _try_initialize(self, frame, frame_id):
        super()._try_initialize(frame, frame_id)
        if self.state == "OK":
            self.kf_agent[: self._host_n_kf] = self.agent_id
            self._tag_new_points(self.agent_id)

    def _remap_after_compact(self, old, new_m, kf_map, pt_map):
        super()._remap_after_compact(old, new_m, kf_map, pt_map)
        kf_agent = np.full_like(self.kf_agent, -1)
        keep = kf_map >= 0
        kf_agent[kf_map[keep]] = self.kf_agent[: len(kf_map)][keep]
        self.kf_agent = kf_agent
        pt_agent = np.full_like(self.pt_agent, -1)
        keepp = pt_map >= 0
        pt_agent[pt_map[keepp]] = self.pt_agent[: len(pt_map)][keepp]
        self.pt_agent = pt_agent
        self._foreign_pt = {key: int(pt_map[v])
                            for key, v in self._foreign_pt.items()
                            if v < len(pt_map) and pt_map[v] >= 0}
        sent = np.zeros_like(self._kf_sent)
        sent[kf_map[keep]] = self._kf_sent[: len(kf_map)][keep]
        self._kf_sent = sent

    def _set_cfg(self, cfg2):
        super()._set_cfg(cfg2)
        K2 = cfg2.mapper.max_keyframes
        P2 = cfg2.mapper.max_points
        if K2 > len(self.kf_agent):
            self.kf_agent = np.concatenate(
                [self.kf_agent, np.full(K2 - len(self.kf_agent), -1,
                                        np.int32)])
        if P2 > len(self.pt_agent):
            self.pt_agent = np.concatenate(
                [self.pt_agent, np.full(P2 - len(self.pt_agent), -1,
                                        np.int32)])
        if K2 > len(self._kf_sent):
            self._kf_sent = np.concatenate(
                [self._kf_sent, np.zeros(K2 - len(self._kf_sent), bool)])

    # -- sender ------------------------------------------------------------
    def drain_packets(self, max_batch: int = 10) -> List[KeyFramePacket]:
        """Publish keyframes not yet sent (reference cadence: <= 10 KFs per
        batch, ros_mono.cc:1948)."""
        n_kf = int(self.map.n_kf)
        kf_valid = self.map.kf_valid.cpu().numpy()
        out = []
        for k in range(n_kf):
            if len(out) >= max_batch:
                break
            if self._kf_sent[k] or self.kf_agent[k] != self.agent_id \
                    or not kf_valid[k]:
                continue
            out.append(pack_keyframe(self.map, k, self.agent_id))
            self._kf_sent[k] = True
            self._published_kfs += 1
        return out

    # -- receiver ----------------------------------------------------------
    def receive_packet(self, pkt: KeyFramePacket) -> bool:
        """Handle a wire keyframe (reference CreateNewKeyFrame(id) path,
        ros_mono.cc:2108-2192).  Keyframes of a sender not yet aligned
        integrate WITHOUT the back-end pass: their sub-map lives in the
        sender's unrelated world frame, where fusing and local BA across
        the components would cross-bind them (the reference's staging map
        Map_KFV keeps received data apart the same way, ros_mono.cc:178,
        540).  Alignment is attempted on every received packet and again
        whenever the OWN map grows (_merge_retry).  Returns True on an
        alignment / closure event."""
        if self.state != "OK":
            return False
        with profiling.span("coop.receive_packet") as sp:
            self._foreign_agents.add(pkt.agent_id)
            merged = self.merged_agents.get(pkt.agent_id, False)
            k = self._integrate_packet(pkt, full_backend=merged)
            self.packets_integrated += 1
            sp.set(kf=k)
            if not merged:
                return self._try_merge(k, pkt.agent_id)
            # keep cross-agent place recognition alive after the merge: the
            # loop-closing path when the receiver runs it, then re-alignment
            # of the whole foreign component by a verified residual Sim3
            if self.loop_closer is not None:
                m, closed = self.loop_closer.on_keyframe(self.map, k)
                self.map = m
                if closed:
                    self.n_merges += 1
                    return True
            return self._try_realign(k, pkt.agent_id)

    def _integrate_packet(self, pkt: KeyFramePacket,
                          full_backend: bool = True) -> int:
        """Wire-reconstruct a foreign keyframe into the local map; returns
        its keyframe slot."""
        self._ensure_capacity()   # recycle / grow slots like local insertion
        m = self.map
        dev = self.device
        # a sender already aligned: transform the packet into the local
        # world frame on arrival
        if pkt.agent_id in self._agent_sim3:
            s, R, t = self._agent_sim3[pkt.agent_id]
            pt_world = (s * pkt.pt_world @ R.T + t).astype(np.float32)
            # T_new = [R_old R^T | (t_old - R_old R^T t / s) * s], from
            # S_kw_new = S_kw_old o S^-1 and then [Rn | tn / sn]
            R_old, t_old = pkt.pose[:3, :3], pkt.pose[:3, 3]
            Rn = R_old @ R.T
            tn = t_old - Rn @ t / s
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = Rn
            pose[:3, 3] = tn * s
            pkt = pkt._replace(pose=pose, pt_world=pt_world)
        # dedup landmarks by sender id
        N = pkt.uv.shape[0]
        kp_pt = np.full(N, -1, np.int32)
        need_new = np.zeros(N, bool)
        for i in np.nonzero(pkt.pt_flag)[0]:
            key = (pkt.agent_id, int(pkt.pt_id[i]))
            if key in self._foreign_pt:
                kp_pt[i] = self._foreign_pt[key]
            else:
                need_new[i] = True
        desc = torch.from_numpy(
            np.ascontiguousarray(pkt.desc).view(np.int32)).to(dev)
        m, new_ids = _add_foreign_points(
            self.cfg, m, torch.from_numpy(pkt.pt_world).to(dev), desc,
            torch.from_numpy(need_new).to(dev), m.n_kf)
        new_ids = new_ids.cpu().numpy()
        for i in np.nonzero(need_new)[0]:
            if new_ids[i] >= 0:
                self._foreign_pt[(pkt.agent_id, int(pkt.pt_id[i]))] = \
                    int(new_ids[i])
                kp_pt[i] = new_ids[i]
                self.pt_agent[new_ids[i]] = pkt.agent_id

        uv = torch.from_numpy(pkt.uv).to(dev)
        level = torch.from_numpy(pkt.level).to(dev)
        frame = Frame(
            uv=uv, uv_raw=uv, level=level,
            angle=torch.from_numpy(pkt.angle).to(dev),
            response=torch.zeros(N, dtype=torch.float32, device=dev),
            desc=desc, valid=torch.from_numpy(pkt.kp_valid).to(dev),
            inv_sigma2=1.0 / lm._table(self.cfg.extractor.level_sigma2,
                                       dev)[level.long()])
        m, k_t = lm.insert_keyframe(
            self.cfg, m, frame, torch.from_numpy(pkt.pose).to(dev),
            pkt.frame_id, torch.from_numpy(kp_pt).to(dev))
        k = int(k_t)
        self._host_n_kf = k + 1
        self.kf_agent[k] = pkt.agent_id
        self.db.add(k, frame.desc, frame.valid)
        self.db.maybe_retrain(m)
        # an ALIGNED foreign keyframe gets the back-end pass of a local one
        # (the reference hands wire-reconstructed keyframes to LocalMapping,
        # ros_mono.cc:2163); before the merge they stay raw wire
        # reconstructions, and _try_merge's sweep runs the pass for them
        if full_backend:
            m = lm.backend_post_insert(self.cfg, m, k_t)
        self.map = m
        self._kf_pose_dirty = True
        self._host_n_pt = int(m.n_pt)
        # new triangulated points belong to the sub-map of their keyframe
        self._tag_new_points(pkt.agent_id)
        return k

    # -- cross-agent alignment --------------------------------------------
    def _own_and_foreign(self, agent_id: int):
        """(own keyframes mask, foreign keyframe ids of `agent_id`) among
        the valid keyframes with a BoW row."""
        K = self.db.bows.shape[0]
        valid = self.map.kf_valid.cpu().numpy()[:K]
        fore = np.nonzero((self.kf_agent[:K] == agent_id) & valid
                          & self.db.has)[0]
        own = (self.kf_agent[:K] == self.agent_id) & valid & self.db.has
        return own, fore

    def _merge_retry(self):
        """Re-attempt the first alignment of a still-unmerged foreign
        sub-map whenever the OWN map grows (the reference's LoopClosing
        checks every inserted keyframe against the database, so a foreign
        keyframe that arrived before the local map covered the overlap
        merges once coverage appears, LoopClosing.cc:57-101).  The retried
        keyframes are the foreign ones scoring highest against the own map
        in the BoW database."""
        for aid in list(self._foreign_agents):
            if self.merged_agents.get(aid):
                continue
            own, fore = self._own_and_foreign(aid)
            if len(fore) == 0 or own.sum() < 2:
                continue
            best = [(self._best_own_score(own, k), int(k)) for k in fore]
            best.sort(reverse=True)
            for s, k in best[:2]:
                if s <= 0.02:
                    break
                if self._try_merge(k, aid):
                    break

    def _best_own_score(self, own: np.ndarray, kf) -> float:
        """Keyframe `kf`'s best BoW score against the own keyframes (`own`,
        a mask over the database's rows), -1 where there are none.  Only
        those rows are scored: every row is a pass over the whole
        vocabulary, and this runs for each foreign keyframe."""
        rows = np.nonzero(own)[0]
        if len(rows) == 0:
            return -1.0
        return float(self.db.scores_against_all(int(kf), rows).max())

    def _backend_pass(self, kf: int, agent_id: int):
        """The back-end pass for keyframe `kf` of `agent_id`'s sub-map."""
        self.map = lm.backend_post_insert(
            self.cfg, self.map,
            torch.tensor(kf, dtype=torch.int32, device=self.device))
        self._host_n_pt = int(self.map.n_pt)
        self._tag_new_points(agent_id)

    def _try_merge(self, foreign_kf: int, agent_id: int) -> bool:
        """First cross-agent alignment: on a verified Sim3 the foreign
        component is similarity-transformed into the local frame, duplicate
        landmarks fuse, and the alignment is stored so that later packets
        arrive pre-transformed."""
        with profiling.span("coop.merge", kf=foreign_kf) as sp:
            found = self._find_cross_sim3(foreign_kf)
            self.merge_gates[self.last_gate] += 1
            sp.set(gate=self.last_gate)
            if found is None:
                return False
            S_w, pt1, pt2, pairs = found
            self._apply_cross_sim3(agent_id, S_w, pt1, pt2, pairs,
                                   ba_iters=5)
            self.merged_agents[agent_id] = True
            self._agent_sim3[agent_id] = (
                float(S_w["s"]), S_w["R"].cpu().numpy(), S_w["t"].cpu().numpy())
            self.n_merges += 1
            # the pre-merge foreign keyframes skipped the back-end pass; the
            # merge keyframe gets it now that its component sits in the local
            # frame (triangulation / fusion across agents)
            self._backend_pass(foreign_kf, agent_id)
            # residual-drift sweep: re-verify the strongest other cross-agent
            # pairs after their back-end pass and fold their residual Sim3s in
            own, fore = self._own_and_foreign(agent_id)
            scored = []
            for k in fore:
                if int(k) == int(foreign_kf):
                    continue
                scored.append((self._best_own_score(own, k), int(k)))
            scored.sort(reverse=True)
            for s, k in scored[:3]:
                if s <= 0.02:
                    break
                self._backend_pass(k, agent_id)
                self._kf_pose_dirty = True
                self._try_realign(k, agent_id)
            # one joint optimization over the merged map with the sweep's
            # cross-agent observations in place (the reference's post-loop GBA,
            # LoopClosing.cc:645)
            if scored:
                self.map = lc.global_ba(self.cfg, self.map, iters=8)
                self._kf_pose_dirty = True
            return True

    def _cross_draws(self, foreign_kf: int, cand: int):
        """(samples, generator) of one cross-agent Sim3 RANSAC."""
        samples = self.cross_sim3_draws.get((foreign_kf, cand))
        if samples is not None:
            return torch.as_tensor(np.asarray(samples, np.int64),
                                   device=self.device), None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.CROSS_SIM3_SEED + foreign_kf)
        return None, gen

    def _find_cross_sim3(self, foreign_kf: int):
        """Place-recognize `foreign_kf` against OWN keyframes via the BoW
        database (the reference's KeyFrameDatabase feeding
        LoopClosing::DetectLoop finds cross-sub-map loops the same way,
        KeyFrameDatabase.cc:76); a short BoW candidate list is
        pre-verified with landmark match counts, then Sim3 RANSAC, the
        SearchBySim3 expansion (K2) and the polish verify.

        Returns (S_w, pt1, pt2, inlier_pairs) with S_w the world-to-world
        similarity taking the foreign keyframe's CURRENT frame into the own
        map's frame, or None if no candidate verifies."""
        cfg = self.cfg
        m = self.map
        dev = self.device
        K = self.db.bows.shape[0]
        own = (self.kf_agent[:K] == self.agent_id) \
            & m.kf_valid.cpu().numpy()[:K]
        self.last_gate = "bow"
        if cfg.loop.brute_force_shortlist:
            counts = lc.match_counts_all(cfg, m, foreign_kf).cpu().numpy()
            counts = np.where(own[: counts.shape[0]], counts, -1)
            order = [int(c) for c in np.argsort(-counts)[:3]]
        else:
            scores = self.db.scores_against_all(foreign_kf)
            scores = np.where(own & self.db.has, scores, -1.0)
            bow_cands = [int(c) for c in np.argsort(-scores)[:8]
                         if scores[c] > 0.02]
            if not bow_cands:
                return None
            counts_sub = lc.match_counts_subset(
                cfg, m, foreign_kf,
                torch.as_tensor(bow_cands, dtype=torch.int32, device=dev)) \
                .cpu().numpy()
            counts = np.full(K, -1, np.int64)
            counts[np.asarray(bow_cands)] = counts_sub
            order = [int(bow_cands[i]) for i in np.argsort(-counts_sub)[:3]]
        s_max = cfg.loop.sim3_max_scale ** 2
        reached = GATES.index("count")

        def stop(gate):
            nonlocal reached
            reached = max(reached, GATES.index(gate))

        for cand in order:
            if counts[cand] < cfg.loop.sim3_min_bow_matches:
                continue
            idx2, pt1, pt2, ok = lc.match_pair_points(cfg, m, foreign_kf,
                                                      cand)
            if int(ok.sum()) < cfg.loop.sim3_min_bow_matches:
                stop("pairs")
                continue
            samples, gen = self._cross_draws(foreign_kf, cand)
            res = lc.sim3_between(cfg, m, foreign_kf, cand, idx2, pt1, pt2,
                                  ok, samples=samples, generator=gen)
            n_inl, s_hat = torch.stack(
                [res.n_inliers.to(torch.float64),
                 res.s.to(torch.float64)]).cpu().numpy()
            if int(n_inl) < max(8, cfg.loop.sim3_min_inliers // 2):
                stop("ransac")
                continue
            # scale sanity: two mono agents' maps are each normalized by
            # their median depth at initialisation, so their relative scale
            # is bounded; the cross-agent bound is the square of the
            # intra-map one
            if not (1.0 / s_max < float(s_hat) < s_max):
                stop("scale")
                continue
            # SearchBySim3-style expansion + polish; the acceptance gate
            # applies to the EXPANDED inlier set
            idx2, pt1, pt2, ok = lc.expand_sim3_matches(
                cfg, m, foreign_kf, cand, res.s, res.R, res.t)
            res = lc.sim3_refine_pairs(cfg, m, foreign_kf, cand, idx2, pt1,
                                       pt2, ok, res.s, res.R, res.t)
            n_inl, s_hat = torch.stack(
                [res.n_inliers.to(torch.float64),
                 res.s.to(torch.float64)]).cpu().numpy()
            if int(n_inl) < cfg.loop.sim3_min_inliers \
                    or not (1.0 / s_max < float(s_hat) < s_max):
                stop("polish")
                continue
            # S21: foreign-KF camera -> own-KF camera.  World to world:
            # S_wOwn_wFor = T_own^-1 o S21 o T_for (as Sim3)
            T_own = geo.sim3_from_se3(geo.se3_inverse(m.kf_pose[cand]))
            S21 = {"s": res.s, "R": res.R, "t": res.t}
            T_for = geo.sim3_from_se3(m.kf_pose[foreign_kf])
            S_w = geo.sim3_compose(T_own, geo.sim3_compose(S21, T_for))
            self.last_gate = "ok"
            return S_w, pt1, pt2, ok & res.inliers
        self.last_gate = GATES[reached]
        return None

    def _apply_cross_sim3(self, agent_id: int, S_w, pt1, pt2, pairs,
                          ba_iters: int):
        """Similarity-correct the whole foreign component, fuse duplicate
        landmarks, refresh geometry and jointly optimize."""
        cfg = self.cfg
        m = self.map
        dev = self.device
        kf_mask = torch.from_numpy(self.kf_agent == agent_id).to(dev) \
            & m.kf_valid
        pt_mask = torch.from_numpy(self.pt_agent == agent_id).to(dev) \
            & m.pt_valid
        m = _apply_sim3_to_component(cfg, m, S_w["s"], S_w["R"], S_w["t"],
                                     kf_mask, pt_mask)
        m = lc.fuse_landmarks(cfg, m, pt1, pt2, pairs)
        m = lm.refresh_point_geometry(cfg, m)
        m = lc.global_ba(cfg, m, iters=ba_iters)
        self.map = m
        self._kf_pose_dirty = True

    def _try_realign(self, foreign_kf: int, agent_id: int) -> bool:
        """Continued cross-agent correction (the reference's LoopClosing
        keeps firing between local and received sub-maps as both grow,
        ros_mono.cc:2163 -> LoopClosing.cc:57): re-verify the keyframe
        against the own map; a verified RESIDUAL Sim3 (the component is
        already in the local frame) re-corrects the whole foreign component
        and composes into the stored alignment."""
        with profiling.span("coop.realign", kf=foreign_kf) as sp:
            found = self._find_cross_sim3(foreign_kf)
            sp.set(gate=self.last_gate)
            if found is None:
                return False
            S_res, pt1, pt2, pairs = found
            # the component is ALREADY aligned, so a valid correction is
            # near the identity: a wildly scaled Sim3 can carry many RANSAC
            # inliers (the reprojection test is blind to (s, t) -> (a s,
            # a t)), and applying one would wreck the merged map
            s = float(S_res["s"])
            R = S_res["R"].cpu().numpy()
            t = S_res["t"].cpu().numpy()
            ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2,
                                               -1, 1)))
            if not (0.8 < s < 1.25) or ang > 15.0:
                return False
            # and it must move the fused pairs' duplicates closer together
            pairs_np = pairs.cpu().numpy()
            p1 = pt1.cpu().numpy()
            p2 = pt2.cpu().numpy()
            sel = pairs_np & (p1 != p2)
            if sel.sum() >= 6:
                idx = torch.from_numpy(np.concatenate([p1[sel], p2[sel]])) \
                    .long().to(self.device)
                ab = self.map.pt_pos[idx].cpu().numpy()
                a, b = ab[: sel.sum()], ab[sel.sum():]
                pre = np.median(np.linalg.norm(a - b, axis=1))
                post = np.median(np.linalg.norm((s * a @ R.T + t) - b,
                                                axis=1))
                if post >= pre:
                    return False
            self._apply_cross_sim3(agent_id, S_res, pt1, pt2, pairs,
                                   ba_iters=4)
            # compose: x_local_new = S_res(x_local_old), x_local_old =
            # S_old(x_sender)
            s0, R0, t0 = self._agent_sim3[agent_id]
            dev = self.device
            S_old = geo.sim3(s0, torch.as_tensor(R0, device=dev),
                             torch.as_tensor(t0, device=dev))
            S_new = geo.sim3_compose(S_res, S_old)
            self._agent_sim3[agent_id] = (
                float(S_new["s"]), S_new["R"].cpu().numpy(),
                S_new["t"].cpu().numpy())
            self.n_merges += 1
            self.n_realigns += 1
            return True


def serialize_packet(pkt: KeyFramePacket) -> bytes:
    """Wire encoding (the lcm-gen analog): npz of the packet fields, the
    JAX package's layout."""
    bio = io.BytesIO()
    np.savez_compressed(
        bio, agent_id=pkt.agent_id, frame_id=pkt.frame_id, pose=pkt.pose,
        uv=pkt.uv, level=pkt.level, angle=pkt.angle, desc=pkt.desc,
        kp_valid=pkt.kp_valid, pt_flag=pkt.pt_flag, pt_world=pkt.pt_world,
        pt_id=pkt.pt_id)
    return bio.getvalue()


def deserialize_packet(data: bytes) -> KeyFramePacket:
    z = np.load(io.BytesIO(data))
    return KeyFramePacket(
        agent_id=int(z["agent_id"]), frame_id=int(z["frame_id"]),
        pose=z["pose"], uv=z["uv"], level=z["level"], angle=z["angle"],
        desc=z["desc"], kp_valid=z["kp_valid"], pt_flag=z["pt_flag"],
        pt_world=z["pt_world"], pt_id=z["pt_id"])


class UdpBus:
    """Cross-process transport over the native UDP-multicast bus
    (coslam_tpu_torch/native) — the direct LCM replacement: channel
    "KeyFrameexample", best-effort delivery, receiver-side filtering by
    sender id (reference ros_mono.cc:602/2399).  The JAX package's UdpBus
    on the same group and port exchanges packets with this one.  A bus
    publishes on `channel` and drains that channel alone, as an LCM
    subscriber does: two pairs on one host keep apart by port or by
    channel."""

    CHANNEL = "KeyFrameexample"

    def __init__(self, group_ip: str = "239.255.76.67", port: int = 7667,
                 channel: str = CHANNEL):
        from coslam_tpu_torch import native

        self.channel = channel
        self._tp = native.Transport(group_ip, port)
        # receive buffer, grown to the largest message seen: the
        # transport's default is a fresh 64 MiB buffer a call, zeroed and
        # copied whole, tens of ms of host memory traffic per call
        self._buf_len = 1 << 20

    def publish(self, sender: int, pkts: List[KeyFramePacket],
                subscribers=None):
        for p in pkts:
            self._tp.publish(self.channel, serialize_packet(p))

    def _receive(self, timeout_ms: int):
        try:
            return self._tp.receive(timeout_ms=timeout_ms,
                                    max_len=self._buf_len)
        except OSError:
            # a message above the buffer stays queued: take it with the
            # transport's default buffer
            msg = self._tp.receive(timeout_ms=timeout_ms)
            if msg is not None:
                self._buf_len = max(self._buf_len, len(msg[1]))
            return msg

    def drain(self, agent_id: int, timeout_ms: int = 200
              ) -> List[KeyFramePacket]:
        out = []
        while True:
            msg = self._receive(timeout_ms if not out else 20)
            if msg is None:
                break
            channel, data = msg
            if channel != self.channel:
                continue
            pkt = deserialize_packet(data)
            if pkt.agent_id != agent_id:
                out.append(pkt)
        return out

    def close(self):
        self._tp.close()


class InMemoryBus:
    """Loss-less in-process transport (tests / single-host multi-agent);
    `UdpBus` is the drop-in cross-process replacement."""

    def __init__(self):
        self.queues: Dict[int, List[KeyFramePacket]] = {}

    def publish(self, sender: int, pkts: List[KeyFramePacket],
                subscribers: List[int]):
        for sub in subscribers:
            if sub != sender:
                self.queues.setdefault(sub, []).extend(pkts)

    def drain(self, agent_id: int) -> List[KeyFramePacket]:
        out = self.queues.get(agent_id, [])
        self.queues[agent_id] = []
        return out
