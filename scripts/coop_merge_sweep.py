"""Sweep the cooperative pair of the benchmark cell coop-pair-640x480.merge
over scenes: one pair per seed (its scene and trajectory both drawn from
the seed), on the cell's configuration, layout and bus, as
benchmark/drivers/coop.py drives it.  Prints, per seed, whether the
receiver merged, its joint keyframe ATE (every foreign keyframe included)
and the sender's, the packets, and every merge attempt with the gate of
the cross-agent Sim3 search that ended it (`CoopAgent.merge_gates`).

    python scripts/coop_merge_sweep.py --seeds 7400001-7400012 \
        [--plant] [--probe] [--out sweep.json]

`--plant` plants `CoopAgent._try_merge` out (it returns False untried):
the reading an unmerged receiver gives.  `--probe` searches, after the
pair, every foreign keyframe against the receiver's final own map, and
counts the gates there.  Needs a CUDA device unless `--device cpu`."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import render, spec  # noqa: E402
from benchmark.reference import trajectory  # noqa: E402

CELL = "coop-pair-640x480.merge"


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def sequence(cell, seed: int, workers: int):
    t = cell.traffic
    sc, tj = t["scene"], t["trajectory"]
    lens = render.Lens.of(cell.config["system"]["camera"])
    poses = render.make_loop_trajectory(t["frames"], tj["cam_radius_m"],
                                        tj["look_radius_m"], tj["frac"],
                                        seed=seed)
    scene = render.make_cylinder_scene(sc["n_points"], sc["radius_m"],
                                       sc["height_m"], seed=seed)
    return render.render_frames(lens, poses, scene, workers), poses


def ate(ids, T, gt):
    if len(ids) < 3:
        return None
    return trajectory.ate_rmse(trajectory.centres(T),
                               trajectory.centres(gt[np.asarray(ids)]))


def run_pair(drv, st, frames, gt, plant: bool, probe: bool) -> dict:
    a0, a1 = drv._pair(st)
    attempts = []
    where = {"via": "retry"}
    inner_merge, inner_receive = a0._try_merge, a0.receive_packet

    def receive(pkt):
        where["via"] = "packet"
        try:
            return inner_receive(pkt)
        finally:
            where["via"] = "retry"

    def merge(fk, aid):
        if plant:
            return False
        before = dict(a0.merge_gates)
        ok = inner_merge(fk, aid)
        gate = next(g for g, n in a0.merge_gates.items() if n > before[g])
        attempts.append((int(a0.map.kf_frame_id[fk]),
                         len(a0.trajectory), where["via"], gate))
        return ok

    a0._try_merge, a0.receive_packet = merge, receive
    t0 = time.perf_counter()
    drv._drive(st, a0, a1, frames, drv.split(st.traffic))
    wall = time.perf_counter() - t0
    ids, T = drv.joint_keyframes(a0, True)
    sid, sT = a1.trajectory_poses()
    res = {"merged": bool(a0.merged_agents.get(1)), "wall_s": wall,
           "joint_ate_m": ate(ids, T, gt),
           "sender_ate_m": ate(sid, np.asarray(sT), gt),
           "posed": [len(a0.trajectory), len(a1.trajectory)],
           **drv.counters(a0),
           "packets_published": int(a1._published_kfs),
           "gates": {k: v for k, v in a0.merge_gates.items() if v},
           "attempts": attempts}
    if probe:
        own, fore = a0._own_and_foreign(1)
        gates = {}
        for k in fore:
            a0._find_cross_sim3(int(k))
            gates[a0.last_gate] = gates.get(a0.last_gate, 0) + 1
        res["probe_gates"] = gates
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", default="7400001-7400012")
    p.add_argument("--plant", action="store_true")
    p.add_argument("--probe", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda":
        from coslam_tpu_torch.ops import cuda_kernels  # noqa: F401
    cell = spec.cell(CELL)
    drv = cell.driver()
    from benchmark.harness import program
    st = drv.State(cfg=program.system_config(cell.config),
                   config=cell.config, traffic=cell.traffic, sequences=[],
                   first=0, device=args.device,
                   port=41000 + 2 * (os.getpid() % 4000),
                   channel=f"KeyFrame.sweep.{os.getpid()}")
    rows = {}
    for seed in seeds_of(args.seeds):
        frames, gt = sequence(cell, seed, args.workers)
        r = run_pair(drv, st, frames, gt, args.plant, args.probe)
        rows[seed] = r
        print(json.dumps({"seed": seed, **r}), flush=True)
    merged = sum(r["merged"] for r in rows.values())
    worst = max((r["joint_ate_m"] or 0.0) for r in rows.values())
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"merged {merged} of {len(rows)}; worst joint ATE {worst:.4f} m; "
          f"card {card}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
