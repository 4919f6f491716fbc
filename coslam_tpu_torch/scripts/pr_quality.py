"""Place-recognition quality (port of scripts/pr_quality.py): BoW shortlist
recall / precision against the brute-force landmark matcher as ground truth.

The loop and merge machinery depends on the vocabulary's shortlist
selectivity (models/keyframe_db.py; the reference ships a pretrained 1M-word
DBoW2 tree, ORB_SLAM2/src/KeyFrameDatabase.cc:76-196; this build ships the
offline-trained assets/vocab.npz of scripts/train_vocab.py).  The harness
runs 1.25-lap loop trajectories over three cylinder scenes with per-frame
`track_mono` (loop closing off), so that every late keyframe revisits early
ones, then for each late-lap query keyframe compares:

  * ground truth: the eligible keyframe with the most mutual sub-TH_HIGH
    landmark descriptor matches (`loop_closing.match_counts_all`), the
    geometric matcher the Sim3 verification ultimately depends on;
  * the BoW database's top-k score shortlist (tf-idf L1, consistency gates
    skipped to isolate retrieval quality).

Reported per scene and pooled: recall@1/@3/@8 of the ground-truth best
candidate, precision@1/@3 (the share of shortlisted candidates that are
geometrically acceptable, >= ACCEPT_TH matches), and the share of queries
where any accepted candidate is in the BoW top-3.

Writes PLACE_RECOGNITION_TORCH.md at the repository root (the JAX script's
tables, with the device and the vocabulary file named).

    python -m coslam_tpu_torch.scripts.pr_quality [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from coslam_tpu_torch.bench import card_name
from coslam_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                     LoopConfig, MapperConfig, SystemConfig,
                                     TrackerConfig)
from coslam_tpu_torch.models import loop_closing as lc
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.ops import bow
from coslam_tpu_torch.utils import synthetic
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "PLACE_RECOGNITION_TORCH.md")
ACCEPT_TH = 15   # landmark matches for a geometrically acceptable candidate
# (name, seed, points, radius, frames)
SCENES = (("cylinder-A", 11, 700, 10.0, 140),
          ("cylinder-B", 29, 900, 8.0, 150),
          ("cylinder-C", 47, 800, 12.0, 160))
STAT_KEYS = ("n_q", "rec1", "rec3", "rec8", "any3", "prec1_hit", "prec1_n",
             "prec3_hit", "prec3_n")


def cfg_for(w: int, h: int) -> SystemConfig:
    return SystemConfig(
        camera=CameraConfig(fx=300, fy=300, cx=w / 2, cy=h / 2,
                            width=w, height=h),
        extractor=ExtractorConfig(n_features=400, max_keypoints=512),
        mapper=MapperConfig(max_keyframes=192, max_points=32768),
        loop=LoopConfig(min_kfs_between_loops=10),
        tracker=TrackerConfig(init_min_matches=60, init_min_good=35),
    )


def scenes():
    """(name, scene, trajectory, frames, cfg) of each scene."""
    out = []
    for name, seed, n_pts, radius, frames in SCENES:
        scene = synthetic.make_cylinder_scene(n_pts, radius=radius, seed=seed)
        traj = synthetic.make_loop_trajectory(frames, seed=seed, frac=1.25)
        out.append((name, scene, traj, frames, cfg_for(320, 240)))
    return out


def run_scene(name, scene, traj, n, cfg, device=DEFAULT_DEVICE) -> System:
    """The tracking half of the JAX `run_scene`: frames 0..n-1 through
    `track_mono`, loop closing off."""
    seq = synthetic.render_sequence(cfg.camera, traj, scene)
    slam = System(cfg, device=device, enable_loop_closing=False)
    for i in range(n):
        slam.track_mono(seq[i], i)
    return slam


def score_queries(cfg: SystemConfig, slam: System, n: int):
    """The query half of the JAX `run_scene` on the System's map: (keyframes,
    stats, per-query rows)."""
    m = slam.map
    K = int(m.n_kf)
    kf_valid = m.kf_valid[:K].cpu().numpy()
    fids = m.kf_frame_id[:K].cpu().numpy()

    lap_end = int(n / 1.25)
    queries = [k for k in range(K)
               if kf_valid[k] and fids[k] >= lap_end + 5]
    th = cfg.loop.sim3_min_bow_matches
    rows = []
    stats = dict.fromkeys(STAT_KEYS, 0)
    for q in queries:
        covis = ms.covisibility_row(m, q).cpu().numpy()
        eligible = (np.arange(K) != q) & kf_valid[:K] \
            & (covis[:K] < cfg.mapper.covis_edge_threshold) \
            & (np.abs(fids - fids[q]) > 20)
        if eligible.sum() < 3:
            continue
        counts = lc.match_counts_all(cfg, m, q).cpu().numpy()[:K]
        counts = np.where(eligible, counts, -1)
        gt_best = int(np.argmax(counts))
        if counts[gt_best] < th:
            continue          # no geometrically-acceptable loop exists
        accepted = set(np.nonzero(counts >= ACCEPT_TH)[0].tolist())
        scores = slam.db.scores_against_all(q)[:K]
        scores = np.where(eligible & slam.db.has[:K], scores, -1.0)
        order = np.argsort(-scores)
        stats["n_q"] += 1
        for k_at, key in ((1, "rec1"), (3, "rec3"), (8, "rec8")):
            if gt_best in order[:k_at]:
                stats[key] += 1
        if accepted & set(order[:3].tolist()):
            stats["any3"] += 1
        stats["prec1_hit"] += int(int(order[0]) in accepted)
        stats["prec1_n"] += 1
        top3 = [int(c) for c in order[:3] if scores[c] > 0]
        stats["prec3_hit"] += sum(1 for c in top3 if c in accepted)
        stats["prec3_n"] += len(top3)
        rows.append((q, int(fids[q]), gt_best, int(counts[gt_best]),
                     order[:3].tolist(),
                     round(float(scores[gt_best]), 3)))
    return K, stats, rows


def _ratio(a, b) -> str:
    return f"{a / max(b, 1):.2f}"


def write_report(path: str, per_scene, pooled, all_rows, vocab_note: str,
                 device_note: str, min_bow_matches: int) -> None:
    n_q = pooled["n_q"]
    with open(path, "w") as f:
        f.write("# Place-recognition quality (BoW shortlist vs brute-force "
                "landmark matcher), coslam_tpu_torch\n\n")
        f.write(f"Device: {device_note}.  Vocabulary: {vocab_note}.\n\n")
        f.write("3 scenes, 1.25-lap loop trajectories; queries are revisit "
                f"keyframes with a >= {min_bow_matches}-match ground-truth "
                "candidate.  Precision counts shortlisted candidates with "
                f">= {ACCEPT_TH} landmark matches as acceptable.\n\n")
        f.write("| scene | frames | KFs | queries | recall@1 | recall@3 | "
                "recall@8 | precision@1 | precision@3 | any-accepted@3 |\n")
        f.write("|---|---|---|---|---|---|---|---|---|---|\n")
        for name, n, K, s in per_scene:
            f.write(f"| {name} | {n} | {K} | {s['n_q']} "
                    f"| {_ratio(s['rec1'], s['n_q'])} "
                    f"| {_ratio(s['rec3'], s['n_q'])} "
                    f"| {_ratio(s['rec8'], s['n_q'])} "
                    f"| {_ratio(s['prec1_hit'], s['prec1_n'])} "
                    f"| {_ratio(s['prec3_hit'], s['prec3_n'])} "
                    f"| {_ratio(s['any3'], s['n_q'])} |\n")
        f.write(f"| **pooled** | | | {n_q} "
                f"| {_ratio(pooled['rec1'], n_q)} "
                f"| {_ratio(pooled['rec3'], n_q)} "
                f"| {_ratio(pooled['rec8'], n_q)} "
                f"| {_ratio(pooled['prec1_hit'], pooled['prec1_n'])} "
                f"| {_ratio(pooled['prec3_hit'], pooled['prec3_n'])} "
                f"| {_ratio(pooled['any3'], n_q)} |\n\n")
        f.write("Per-query detail (first 30):\n\n")
        f.write("| scene | query kf | frame | GT best | matches | BoW top-3 "
                "| BoW score of GT |\n|---|---|---|---|---|---|---|\n")
        for r in all_rows[:30]:
            f.write("| " + " | ".join(str(x) for x in r) + " |\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    jobs = scenes()

    pre = bow.load_pretrained_vocabulary()
    path = os.path.relpath(bow.pretrained_vocabulary_path(), ROOT)
    vocab_note = (f"pretrained {path}, {pre.shape[0]} words "
                  "(scripts/train_vocab.py)" if pre is not None
                  else "online-trained fallback")

    per_scene = []
    pooled = dict.fromkeys(STAT_KEYS, 0)
    all_rows = []
    for name, scene, traj, n, cfg in jobs:
        slam = run_scene(name, scene, traj, n, cfg, dev)
        K, stats, rows = score_queries(cfg, slam, n)
        per_scene.append((name, n, K, stats))
        for k in pooled:
            pooled[k] += stats[k]
        all_rows += [(name,) + r for r in rows]
        print(f"{name}: {K} keyframes, {stats['n_q']} queries, "
              f"recall@3={_ratio(stats['rec3'], stats['n_q'])}", flush=True)

    write_report(OUT, per_scene, pooled, all_rows, vocab_note,
                 card_name(dev), jobs[0][4].loop.sim3_min_bow_matches)
    n_q = pooled["n_q"]
    print(f"wrote {OUT}: pooled n_q={n_q} "
          f"recall@3={_ratio(pooled['rec3'], n_q)} "
          f"precision@1={_ratio(pooled['prec1_hit'], pooled['prec1_n'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
