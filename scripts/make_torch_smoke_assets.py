"""Build the map checkpoint and the reference run that `chip_smoke.py` uses.

Runs the JAX package (`coslam_tpu`) on the CPU:

  1. maps frames 0-79 of the synthetic reference workload with
     `System.run_sequence` and writes the checkpoint
     `coslam_tpu_torch/assets/smoke_map.npz` (`utils/checkpoint.save_system`);
  2. loads that file into a fresh `System`, activates localization mode, runs
     frames 80-119 and writes the per-frame poses, inlier counts, lost flags,
     ground-truth poses and ATE to `coslam_tpu_torch/assets/smoke_expected.npz`.

The workload is the bench's (bench.py: 640x480, 1000 features,
max_keypoints=1024, make_scene(600, seed=3), make_trajectory(360, seed=3))
with the default map capacity (K=256, P=32768) and the keyframe throttle
pinned to 3 frames, so that the map does not depend on host speed.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_assets.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from coslam_tpu.config import (CameraConfig, ExtractorConfig,  # noqa: E402
                               MapperConfig, SystemConfig, TrackerConfig)
from coslam_tpu.models.system import System  # noqa: E402
from coslam_tpu.utils import checkpoint, evaluation, synthetic  # noqa: E402

MAP_FRAMES = 80
LOC_FRAMES = (80, 120)
ASSETS = os.path.join(ROOT, "coslam_tpu_torch", "assets")


def smoke_config() -> SystemConfig:
    return SystemConfig(
        camera=CameraConfig(fx=400, fy=400, cx=320, cy=240,
                            width=640, height=480),
        extractor=ExtractorConfig(n_features=1000, max_keypoints=1024),
        tracker=TrackerConfig(mapper_latency_frames=3),
        mapper=MapperConfig())


def main() -> int:
    cfg = smoke_config()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    poses = traj.poses_cw[:LOC_FRAMES[1]]
    seq = synthetic.render_sequence(cfg.camera,
                                    synthetic.Trajectory(poses), scene)
    os.makedirs(ASSETS, exist_ok=True)
    map_path = os.path.join(ASSETS, "smoke_map.npz")

    t0 = time.perf_counter()
    mapper = System(cfg)
    mapper.run_sequence(seq[:MAP_FRAMES])
    mapper.shutdown()
    checkpoint.save_system(map_path, mapper)
    n_kf = int(np.asarray(mapper.map.kf_valid).sum())
    n_pt = int(np.asarray(mapper.map.pt_valid).sum())
    print(f"mapped frames 0-{MAP_FRAMES - 1}: {n_kf} keyframes, {n_pt} "
          f"points, state {mapper.state} ({time.perf_counter() - t0:.1f} s)")
    assert mapper.state == "OK", mapper.state

    loc = System(cfg)
    checkpoint.load_system(map_path, loc)
    loc.activate_localization_mode()
    lo, hi = LOC_FRAMES
    ids = list(range(lo, hi))
    loc.run_sequence(seq[lo:hi], frame_ids=ids)
    got_ids, T = loc.trajectory_poses()
    assert list(got_ids) == ids, got_ids
    inliers = np.array([s["inliers"] for s in loc.stats], np.int32)
    lost = np.array([bool(s.get("lost")) for s in loc.stats])
    new_kf = sum(1 for s in loc.stats if s.get("keyframe"))
    gt = poses[lo:hi]
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(gt))
    print(f"localization frames {lo}-{hi - 1}: lost {int(lost.sum())}, "
          f"new keyframes {new_kf}, inliers min {inliers.min()} "
          f"mean {inliers.mean():.1f}, ATE {ate:.5f}")
    assert not lost.any(), "the reference run lost frames"
    assert new_kf == 0
    assert int(np.asarray(loc.map.kf_valid).sum()) == n_kf
    np.savez_compressed(
        os.path.join(ASSETS, "smoke_expected.npz"),
        frame_ids=np.asarray(ids, np.int32), T=T.astype(np.float32),
        n_inliers=inliers, lost=lost, gt_T=gt.astype(np.float32),
        ate=np.float64(ate))
    for name in ("smoke_map.npz", "smoke_expected.npz"):
        p = os.path.join(ASSETS, name)
        print(f"{p}: {os.path.getsize(p)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
