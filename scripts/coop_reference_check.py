"""Hold the cooperative receiver to the plain reference
(benchmark/reference/coop.py) on one window of the benchmark cell
coop-pair-640x480.merge, or on any run of `cli.drive_coop`:

  * every foreign keyframe the receiver integrates, as its wire
    reconstruction wrote it (`local_mapping.insert_keyframe` inside
    `CoopAgent._integrate_packet`, before any back-end pass), against what
    the reference rebuilds from the packet: keypoints, levels, angles,
    descriptor bits and the valid mask exactly, the dedup of landmarks by
    (agent, pt_id) exactly, the pose and the new landmarks under the
    stored alignment within the reference's float32 tolerance;
  * every verified cross-agent Sim3 (`CoopAgent._find_cross_sim3`): its
    world-to-world similarity S_w against the float64 composition
    T_own^-1 o S21 o T_for of the same inputs.

    python scripts/coop_reference_check.py --seed 7400123 --seconds 51 \
        [--out coop_reference.json]

None of these numbers joins the benchmark's `correct`."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.reference import coop as ref  # noqa: E402

CELL = "coop-pair-640x480.merge"


class Capture:
    """What the receivers wrote, per agent in order: integrations
    ("packet", packet, stored alignment, the keyframe row and the landmark
    rows), compactions ("remap", pt_map); and every verified Sim3 search
    ("sim3": own and foreign Tcw, S21, the program's S_w, the map's
    extent)."""

    def __init__(self):
        self.events: Dict[int, List[tuple]] = {}
        self.sim3: List[dict] = []

    def install(self, patches) -> "Capture":
        from coslam_tpu_torch.models import cooperative as coop
        from coslam_tpu_torch.models import local_mapping as lm
        from coslam_tpu_torch.models import loop_closing as lc

        cap = self
        inside = {"agent": None, "pkt": None, "refine": None}

        def integrate(inner):
            def call(a, pkt, *args, **kw):
                stored = a._agent_sim3.get(pkt.agent_id)
                inside["agent"], inside["pkt"] = a, (
                    ref.packet_dict(pkt), ref.alignment_of(stored))
                try:
                    return inner(a, pkt, *args, **kw)
                finally:
                    inside["agent"] = inside["pkt"] = None
            return call

        def insert(inner):
            def call(cfg, m, frame, pose, frame_id, kp_pt, *args, **kw):
                out = inner(cfg, m, frame, pose, frame_id, kp_pt, *args,
                            **kw)
                a = inside["agent"]
                if a is not None:
                    m2, k = out
                    k = int(k)
                    obs = m2.kf_obs_pt[k]
                    bound = obs[obs >= 0].long()
                    wrote = {f: getattr(m2, f)[k].cpu().numpy() for f in
                             ("kf_uv", "kf_level", "kf_angle", "kf_desc",
                              "kf_kp_valid", "kf_pose", "kf_obs_pt")}
                    pos = np.zeros((int(m2.pt_pos.shape[0]), 3), np.float32)
                    pos[bound.cpu().numpy()] = m2.pt_pos[bound].cpu().numpy()
                    wrote["pt_pos"] = pos
                    wrote["pt_valid"] = m.pt_valid.cpu().numpy()
                    pkt, align = inside["pkt"]
                    cap.events.setdefault(id(a), []).append(
                        ("packet", pkt, align, wrote))
                return out
            return call

        def remap(inner):
            def call(a, old, new_m, kf_map, pt_map):
                cap.events.setdefault(id(a), []).append(
                    ("remap", np.asarray(pt_map)))
                return inner(a, old, new_m, kf_map, pt_map)
            return call

        def refine(inner):
            def call(cfg, m, k1, k2, *args, **kw):
                res = inner(cfg, m, k1, k2, *args, **kw)
                inside["refine"] = (int(k1), int(k2), res)
                return res
            return call

        def find(inner):
            def call(a, foreign_kf):
                inside["refine"] = None
                out = inner(a, foreign_kf)
                if out is not None and inside["refine"] is not None:
                    k1, k2, res = inside["refine"]
                    m = a.map
                    valid = m.kf_valid.cpu().numpy()
                    poses = m.kf_pose.cpu().numpy()
                    centres = -np.einsum("kji,kj->ki", poses[:, :3, :3],
                                         poses[:, :3, 3])[valid]
                    cap.sim3.append({
                        "foreign_kf": k1, "candidate": k2,
                        "own_pose": poses[k2], "foreign_pose": poses[k1],
                        "S21": (float(res.s), res.R.cpu().numpy(),
                                res.t.cpu().numpy()),
                        "S_w": (float(out[0]["s"]),
                                out[0]["R"].cpu().numpy(),
                                out[0]["t"].cpu().numpy()),
                        "extent": float(np.ptp(centres, 0).max())
                        if len(centres) else 1.0})
                return out
            return call

        patches.replace(coop.CoopAgent, "_integrate_packet",
                        integrate)
        patches.replace(lm, "insert_keyframe", insert)
        patches.replace(coop.CoopAgent, "_remap_after_compact", remap)
        patches.replace(lc, "sim3_refine_pairs", refine)
        patches.replace(coop.CoopAgent, "_find_cross_sim3", find)
        return self

    def judge(self) -> dict:
        """The reference's verdict on everything captured."""
        rows = []
        for events in self.events.values():
            r = ref.Receiver()
            for ev in events:
                if ev[0] == "remap":
                    r.remap(ev[1])
                    continue
                _kind, pkt, align, wrote = ev
                rows.append({"aligned": align is not None,
                             **r.check(pkt, wrote, align)})
        gaps = []
        for c in self.sim3:
            exp = ref.merge_similarity(c["own_pose"], *c["S21"],
                                       c["foreign_pose"])
            gaps.append(ref.similarity_gap(c["S_w"], exp, c["extent"]))
        out = {"packets": len(rows),
               "packets_ok": sum(r["ok"] for r in rows),
               "aligned_packets": sum(r["aligned"] for r in rows),
               "exact_fields_differing": sum(
                   r[k] for r in rows for k in
                   ("uv", "level", "angle", "desc_bits", "kp_valid",
                    "dedup")),
               "new_points": sum(r["new_points"] for r in rows),
               "pose_gap_max": max((r["pose_gap"] for r in rows),
                                   default=None),
               "point_gap_max": max((r["point_gap"] for r in rows),
                                    default=None),
               "sim3": len(gaps)}
        for k in ("s_rel", "R_deg", "t_rel"):
            out[f"sim3_{k}_max"] = max((g[k] for g in gaps), default=None)
        return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=7400123)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    t_process = time.perf_counter()
    from benchmark.harness import main as hmain, spec
    hmain.cache_environment()
    cell = spec.cell(CELL)
    cap = Capture()
    res = hmain.run(cell, args.seed, args.seconds, False, t_process,
                    faults=cap.install)
    verdict = cap.judge()
    out = {"seed": args.seed, "correct": res["correct"],
           "window": {k: res["window"][k] for k in
                      ("seconds", "sessions", "sessions_finished", "posed",
                       "per_session")},
           "device": res["device"], "reference": verdict}
    print(json.dumps(out, default=float), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
