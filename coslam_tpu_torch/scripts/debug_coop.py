"""Instrumented two-agent run (port of scripts/debug_coop.py, the repro of
tests/test_cooperative.py::test_two_agent_continued_correction).

Prints, for every foreign keyframe received after the first merge, why the
loop-closing path did or did not fire: cooldown, eligibility breakdown, BoW
candidate shortlist, geometric match counts.

    python -m coslam_tpu_torch.scripts.debug_coop [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from coslam_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                     LoopConfig, MapperConfig, SystemConfig,
                                     TrackerConfig)
from coslam_tpu_torch.models import loop_closing as lc
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.models.cooperative import CoopAgent, InMemoryBus
from coslam_tpu_torch.utils import evaluation, synthetic
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

CFG = SystemConfig(
    camera=CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320, height=240),
    extractor=ExtractorConfig(n_features=400, max_keypoints=512),
    mapper=MapperConfig(max_keyframes=128, max_points=32768),
    loop=LoopConfig(min_kfs_between_loops=8, sim3_min_bow_matches=15,
                    sim3_min_inliers=12),
    tracker=TrackerConfig(init_min_matches=60, init_min_good=35),
)


def probe(agent, k):
    """Replicate LoopCloser.on_keyframe gating for keyframe k, verbosely."""
    self = agent.loop_closer
    m = agent.map
    lcfg = self.cfg.loop
    cd = k - self.last_loop_kf
    covis_row = ms.covisibility_row(m, k).cpu().numpy()
    K = covis_row.shape[0]
    kf_valid = m.kf_valid.cpu().numpy()
    eligible = (np.arange(K) != k) \
        & (covis_row < self.cfg.mapper.covis_edge_threshold) \
        & (np.abs(np.arange(K) - k) > lcfg.min_kfs_between_loops) \
        & kf_valid
    own = agent.kf_agent[:K] == agent.agent_id
    n_own_elig = int((eligible & own).sum())
    blocked_covis = int((own & kf_valid[:K]
                         & (covis_row >= self.cfg.mapper.covis_edge_threshold)
                         ).sum())
    blocked_dist = int((own & kf_valid[:K]
                        & (np.abs(np.arange(K) - k)
                           <= lcfg.min_kfs_between_loops)).sum())
    cands = self.db.detect_loop_candidates(m, k, covis_row)
    cands_elig = [c for c in cands if eligible[c]]
    cands_own = [c for c in cands if eligible[c] and own[c]]
    counts_str = ""
    if cands_elig:
        counts = lc.match_counts_subset(
            self.cfg, m, k, torch.as_tensor(cands_elig[:8], dtype=torch.int32,
                                            device=m.kf_valid.device)).cpu()
        counts_str = str(list(zip(cands_elig[:8], counts.tolist())))
    print(f"  [probe kf {k}] cooldown={cd} own_elig={n_own_elig} "
          f"blocked(covis)={blocked_covis} blocked(dist)={blocked_dist} "
          f"bow_cands={list(cands)[:8]} elig={cands_elig[:8]} own={cands_own} "
          f"counts={counts_str}", flush=True)


def joint_ate(a0, traj):
    m = a0.map
    K = int(m.n_kf)
    valid = m.kf_valid[:K].cpu().numpy()
    fid = m.kf_frame_id[:K].cpu().numpy()
    centers = ms.kf_centers(m).cpu().numpy()[:K]
    gt_centers = evaluation.trajectory_xyz(traj.poses_cw[fid])
    return evaluation.ate_rmse(centers[valid], gt_centers[valid])


def run(device=DEFAULT_DEVICE) -> dict:
    """The JAX script's `main`: agent 0 maps frames 0-37, then agent 1
    tracks frames 30-79 and publishes every 8 frames into agent 0.  Returns
    the merge count, the (frame, keyframe) events, the keyframes probed, the
    joint ATE, the number of frames the two agents tracked and their states
    (agent 0's after its frames, agent 1's at the end)."""
    dev = resolve_device(device)
    scene = synthetic.make_cylinder_scene(700, seed=5)
    traj = synthetic.make_loop_trajectory(90, seed=5, frac=0.72)
    seq = synthetic.render_sequence(CFG.camera, traj, scene)

    a0 = CoopAgent(CFG, 0, device=dev, enable_loop_closing=True)
    a1 = CoopAgent(CFG, 1, device=dev, enable_loop_closing=False)
    a0.loop_closer.verbose = True
    n_frames = 0
    for i in range(0, 38):
        a0.track_mono(seq[i], i)
        n_frames += 1
    state0 = a0.state
    print(f"a0 init: state={a0.state} n_kf={int(a0.map.n_kf)} "
          f"ate={joint_ate(a0, traj):.4f}")

    bus = InMemoryBus()
    events, probed = [], []
    for i in range(30, 80):
        a1.track_mono(seq[i], i)
        n_frames += 1
        if i % 8 == 0 or i == 79:
            bus.publish(1, a1.drain_packets(max_batch=10), subscribers=[0, 1])
            for p in bus.drain(0):
                before = a0.n_merges
                merged_agent = a0.merged_agents.get(p.agent_id, False)
                got = a0.receive_packet(p)
                k = a0._host_n_kf - 1
                if merged_agent:
                    probe(a0, k)
                    probed.append(k)
                if got:
                    events.append((i, k))
                    print(f"  EVENT at frame {i}, kf {k} "
                          f"(n_merges {before}->{a0.n_merges}) "
                          f"ate={joint_ate(a0, traj):.4f}", flush=True)
            print(f"[i={i}] a0 n_kf={int(a0.map.n_kf)} "
                  f"merges={a0.n_merges} ate={joint_ate(a0, traj):.4f}",
                  flush=True)
    ate = joint_ate(a0, traj)
    print(f"final: merges={a0.n_merges} events={events} ate={ate:.4f}")
    return dict(merges=a0.n_merges, events=events, probed=probed, ate=ate,
                frames=n_frames, states=(state0, a1.state))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
