"""What a receiver must hold after integrating a foreign keyframe packet,
rebuilt from the packet alone, and the merge's world-to-world similarity
from the merge's own inputs; NumPy in float64, importing nothing of the
program.

A packet is a mapping with the wire fields of the port's
`KeyFramePacket` (agent_id, frame_id, pose, uv, level, angle, desc,
kp_valid, pt_flag, pt_world, pt_id).  What the receiver wrote is the
keyframe row of its map right after the wire reconstruction (before any
back-end pass): `kf_uv`, `kf_level`, `kf_angle`, `kf_desc`,
`kf_kp_valid`, `kf_pose`, `kf_obs_pt` of the new keyframe, `pt_pos` of the
landmarks it binds, `pt_valid` of the map it was written into (which
landmarks were alive), and the alignment `(s, R, t)` stored for the sender
when the packet arrived (None before the merge), x_receiver = s R x_sender
+ t.

Exact: keypoints, levels, angles, descriptor bits and the valid mask; the
dedup of landmarks by (agent, pt_id): a pair seen in an earlier packet
binds the slot the table holds for it while that landmark is alive (none
once a fusion or culling has ended it), a pair new in this packet binds a
slot no pair holds yet at each keypoint that carries it (or none, when the
map is full), and the table then holds the last of them; an unflagged
keypoint binds none.  (A sender's keyframe can bind one landmark at two
keypoints; the receiver then makes two landmarks of it, as the JAX
package's receiver does, and later packets bind the second.)

Within POSE_TOL / POINT_TOL, relative to max(1, the largest magnitude
compared): the keyframe pose and the new landmarks under the stored
alignment, which the program composes in float32 (a 3x3 product, a
matrix-vector product, a difference and two scalings: each rounds to half
an ulp, 2^-24 = 6.0e-8 relative, so a few ulps, 1e-6 relative, is the
most float32 can part from float64; 1e-5 leaves room for the packet's own
float32 pose rounded at the sender).  Before the merge both are copied,
and compared exactly."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

POSE_TOL = 1e-5
POINT_TOL = 1e-5


def aligned_pose(pose, alignment) -> np.ndarray:
    """The receiver-frame Tcw of a sender-frame Tcw: S_kw o S^-1 as a
    similarity, then its rotation and its translation over its scale."""
    T = np.asarray(pose, np.float64)
    if alignment is None:
        return T
    s, R, t = (float(alignment[0]), np.asarray(alignment[1], np.float64),
               np.asarray(alignment[2], np.float64))
    Rn = T[:3, :3] @ R.T
    out = np.eye(4)
    out[:3, :3] = Rn
    out[:3, 3] = (T[:3, 3] - Rn @ t / s) * s
    return out


def aligned_points(pts, alignment) -> np.ndarray:
    X = np.asarray(pts, np.float64)
    if alignment is None:
        return X
    s, R, t = (float(alignment[0]), np.asarray(alignment[1], np.float64),
               np.asarray(alignment[2], np.float64))
    return s * X @ R.T + t


def _rel_gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


class Receiver:
    """The reference's side of one receiver: its dedup table of
    (agent, pt_id) -> landmark slot, fed packet by packet."""

    def __init__(self):
        self.slots: Dict[Tuple[int, int], int] = {}

    def remap(self, pt_map) -> None:
        """Follow a compaction of the receiver's landmark slots (old slot
        -> new slot, -1 dropped)."""
        pt_map = np.asarray(pt_map)
        self.slots = {k: int(pt_map[v]) for k, v in self.slots.items()
                      if v < len(pt_map) and pt_map[v] >= 0}

    def check(self, pkt, wrote: dict, alignment=None) -> dict:
        """Compare one integration with the packet; returns the counts of
        differing fields (exact ones) and the relative gaps (toleranced
        ones), and `ok`."""
        N = np.asarray(pkt["uv"]).shape[0]
        out = {}
        out["uv"] = int((np.asarray(wrote["kf_uv"], np.float32)
                         != np.asarray(pkt["uv"], np.float32)).any(-1).sum())
        out["level"] = int((np.asarray(wrote["kf_level"]).astype(np.int64)
                            != np.asarray(pkt["level"]).astype(np.int64))
                           .sum())
        out["angle"] = int((np.asarray(wrote["kf_angle"], np.float32)
                            != np.asarray(pkt["angle"], np.float32)).sum())
        desc_w = np.ascontiguousarray(wrote["kf_desc"]).view(np.uint32)
        desc_p = np.ascontiguousarray(pkt["desc"]).view(np.uint32)
        out["desc_bits"] = int(sum(bin(int(x)).count("1") for x in
                                   np.bitwise_xor(desc_w, desc_p).ravel()))
        out["kp_valid"] = int((np.asarray(wrote["kf_kp_valid"], bool)
                               != np.asarray(pkt["kp_valid"], bool)).sum())

        # dedup by (agent, pt_id)
        obs = np.asarray(wrote["kf_obs_pt"]).astype(np.int64)
        flag = np.asarray(pkt["pt_flag"], bool)
        ids = np.asarray(pkt["pt_id"]).astype(np.int64)
        agent = int(pkt["agent_id"])
        alive = np.asarray(wrote["pt_valid"], bool)
        kp_valid = np.asarray(pkt["kp_valid"], bool)
        held = set(self.slots.values())
        bad_dedup = int((obs[~flag] != -1).sum())
        new_slots, new_rows, added = [], [], {}
        for i in np.nonzero(flag)[0]:
            key = (agent, int(ids[i]))
            if key in self.slots:
                slot = self.slots[key]
                # a binding holds while the landmark lives in the
                # receiver's map (a fusion or culling ends it)
                want = slot if alive[slot] and kp_valid[i] else -1
                bad_dedup += int(obs[i] != want)
            elif obs[i] < 0:
                continue                 # no slot left in the map
            else:
                # a pair new in this packet: a new slot at each keypoint
                # that carries it; the table keeps the last (see the
                # module doc)
                if int(obs[i]) in held:
                    bad_dedup += 1
                added[key] = int(obs[i])
                held.add(int(obs[i]))
                new_slots.append(int(obs[i]))
                new_rows.append(int(i))
        self.slots.update(added)
        out["dedup"] = bad_dedup
        out["new_points"] = len(new_slots)

        exact = alignment is None
        pose_exp = aligned_pose(pkt["pose"], alignment)
        pts_exp = aligned_points(np.asarray(pkt["pt_world"])[new_rows],
                                 alignment)
        pts_got = np.asarray(wrote["pt_pos"], np.float64)[new_slots] \
            if new_slots else np.zeros((0, 3))
        out["pose_gap"] = _rel_gap(wrote["kf_pose"], pose_exp)
        out["point_gap"] = _rel_gap(pts_got, pts_exp)
        exact_fields = ("uv", "level", "angle", "desc_bits", "kp_valid",
                        "dedup")
        out["ok"] = (all(out[k] == 0 for k in exact_fields)
                     and (out["pose_gap"] == 0 and out["point_gap"] == 0
                          if exact else
                          out["pose_gap"] <= POSE_TOL
                          and out["point_gap"] <= POINT_TOL))
        out["n"] = int(N)
        return out


def merge_similarity(own_pose, s21, R21, t21, foreign_pose
                     ) -> Tuple[float, np.ndarray, np.ndarray]:
    """S_w = T_own^-1 o S21 o T_for in float64: the similarity taking the
    foreign keyframe's world into the own keyframe's, from the own and
    foreign keyframes' Tcw and S21 (foreign camera -> own camera)."""
    To = np.asarray(own_pose, np.float64)
    Tf = np.asarray(foreign_pose, np.float64)
    R21 = np.asarray(R21, np.float64)
    t21 = np.asarray(t21, np.float64)
    # S21 o T_for: x -> s21 R21 (Rf x + tf) + t21
    s1, R1, t1 = float(s21), R21 @ Tf[:3, :3], float(s21) * R21 @ Tf[:3, 3] \
        + t21
    # T_own^-1: y -> Ro^T (y - to)
    Ro, to = To[:3, :3], To[:3, 3]
    return s1, Ro.T @ R1, Ro.T @ (t1 - to)


def similarity_gap(a, b, extent: float) -> dict:
    """How far two similarities (s, R, t) part: |s_a / s_b - 1|, the angle
    of R_a R_b^T in degrees, |t_a - t_b| over `extent`."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    # the angle from the chord |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): the
    # arccos of the trace loses the small angles float32 rotations part by
    chord = np.linalg.norm(np.asarray(Ra, np.float64)
                           - np.asarray(Rb, np.float64))
    ang = np.degrees(2.0 * np.arcsin(min(1.0, chord / (2.0 * np.sqrt(2.0)))))
    return {"s_rel": abs(float(sa) / float(sb) - 1.0), "R_deg": float(ang),
            "t_rel": float(np.linalg.norm(np.asarray(ta, np.float64)
                                          - np.asarray(tb, np.float64))
                           / max(extent, 1e-9))}


def packet_dict(pkt) -> dict:
    """A packet's wire fields as a plain dict (from any object that has
    them as attributes, or a mapping)."""
    keys = ("agent_id", "frame_id", "pose", "uv", "level", "angle", "desc",
            "kp_valid", "pt_flag", "pt_world", "pt_id")
    if isinstance(pkt, dict):
        return {k: pkt[k] for k in keys}
    return {k: getattr(pkt, k) for k in keys}


def alignment_of(stored: Optional[tuple]):
    return None if stored is None else (float(stored[0]),
                                        np.asarray(stored[1]),
                                        np.asarray(stored[2]))
