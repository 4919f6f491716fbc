"""Build the map checkpoint and the reference runs that `chip_smoke.py` uses.

Runs the JAX package (`coslam_tpu`) on the CPU:

  1. maps frames 0-79 of the synthetic reference workload with
     `System.run_sequence` and writes the checkpoint
     `coslam_tpu_torch/assets/smoke_map.npz` (`utils/checkpoint.save_system`);
  2. loads that file into a fresh `System`, activates localization mode, runs
     frames 80-119 and writes the per-frame poses, inlier counts, lost flags,
     ground-truth poses and ATE to `coslam_tpu_torch/assets/smoke_expected.npz`;
  3. maps frames 0-119 from the first frame with loop closing off (the
     mapping workload) and writes `smoke_mapping_expected.npz`: the RANSAC
     draws of every initialisation attempt (and of the five frames after
     the initialisation frame, which the port may still attempt), the
     initialisation frame, the
     per-frame poses / inlier counts / keyframe flags, the keyframe and
     valid-point counts, the final keyframe poses and the ATE.  No map
     arrays.

The workload is the bench's (bench.py:140-160: 640x480, 1000 features,
max_keypoints=1024, make_scene(600, seed=3), make_trajectory(360, seed=3))
with the keyframe throttle pinned to 3 frames, so that the map does not
depend on host speed; the localization map uses the default capacity
(K=256, P=32768), the mapping run the bench's (K=64, P=16384).

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_assets.py [--mapping-only]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from coslam_tpu.config import (CameraConfig, ExtractorConfig,  # noqa: E402
                               MapperConfig, SystemConfig, TrackerConfig)
from coslam_tpu.models import system as jsystem  # noqa: E402
from coslam_tpu.models.system import System  # noqa: E402
from coslam_tpu.utils import checkpoint, evaluation, synthetic  # noqa: E402

MAP_FRAMES = 80
LOC_FRAMES = (80, 120)
MAPPING_FRAMES = 120
ASSETS = os.path.join(ROOT, "coslam_tpu_torch", "assets")


def smoke_config(mapper: MapperConfig = MapperConfig()) -> SystemConfig:
    return SystemConfig(
        camera=CameraConfig(fx=400, fy=400, cx=320, cy=240,
                            width=640, height=480),
        extractor=ExtractorConfig(n_features=1000, max_keypoints=1024),
        tracker=TrackerConfig(mapper_latency_frames=3),
        mapper=mapper)


def mapping_config() -> SystemConfig:
    return smoke_config(MapperConfig(max_keyframes=64, max_points=16384))


class DrawRecordingSystem(System):
    """The JAX System, recording the RANSAC sample indices of every
    initialisation attempt: `jax.random.choice(fold_in(PRNGKey(0), fid),
    N, (iters, 8), p=valid / sum)`, exactly as `twoview.initialize` draws
    them inside `_init_attempt` (models/system.py:355, ops/twoview.py:249)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.draws = {}

    def _try_initialize(self, frame, frame_id):
        if self.ref_frame is not None:
            mm = jsystem._match_for_init(self.cfg, self.ref_frame, frame)
            p = mm.valid.astype(jnp.float32)
            p = p / (p.sum() + 1e-9)
            key = jax.random.fold_in(self._init_key, frame_id)
            self.draws[frame_id] = np.asarray(jax.random.choice(
                key, frame.uv.shape[0], (self.cfg.tracker.ransac_iters, 8),
                replace=True, p=p), np.int32)
        return super()._try_initialize(frame, frame_id)


def map_and_localize(seq, poses) -> None:
    cfg = smoke_config()
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


def later_draws(s: DrawRecordingSystem, seq, ref_id: int, frames) -> None:
    """The draws the reference would make for initialisation attempts it
    did not need (frames after its initialisation frame, against its
    reference frame): the port's attempts there then use the reference's
    sample indices too."""
    from coslam_tpu.models.frame import build_frame
    f0 = build_frame(jnp.asarray(seq[ref_id]), s.cfg)
    for fid in frames:
        f1 = build_frame(jnp.asarray(seq[fid]), s.cfg)
        mm = jsystem._match_for_init(s.cfg, f0, f1)
        p = mm.valid.astype(jnp.float32)
        p = p / (p.sum() + 1e-9)
        key = jax.random.fold_in(s._init_key, fid)
        s.draws[fid] = np.asarray(jax.random.choice(
            key, f1.uv.shape[0], (s.cfg.tracker.ransac_iters, 8),
            replace=True, p=p), np.int32)


def mapping_reference(seq, poses) -> None:
    """The mapping workload from the first frame, loop closing off."""
    t0 = time.perf_counter()
    s = DrawRecordingSystem(mapping_config(), enable_loop_closing=False)
    s.run_sequence(seq[:MAPPING_FRAMES])
    s.shutdown()
    ids, T = s.trajectory_poses()
    stats = [st for st in s.stats]
    lost = sum(1 for st in stats if st.get("lost"))
    assert lost == 0, f"the reference mapping run lost {lost} frames"
    init_frame = int(ids[1])          # ids[0] is the reference frame
    assert s.state == "OK"
    kf_valid = np.asarray(s.map.kf_valid)
    gt = poses[np.asarray(ids)]
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(gt))
    n_attempts = len(s.draws)
    later_draws(s, seq, int(ids[0]), range(init_frame + 1, init_frame + 6))
    attempts = sorted(s.draws)
    n_kf = int(kf_valid.sum())
    n_pt = int(np.asarray(s.map.pt_valid).sum())
    print(f"mapping frames 0-{MAPPING_FRAMES - 1}: initialised at frame "
          f"{init_frame} (reference frame {ids[0]}), {n_attempts} "
          f"attempts, {n_kf} keyframes, {n_pt} points, lost {lost}, "
          f"ATE {ate:.5f} ({time.perf_counter() - t0:.1f} s)")
    np.savez_compressed(
        os.path.join(ASSETS, "smoke_mapping_expected.npz"),
        draw_frames=np.asarray(attempts, np.int32),
        draws=np.stack([s.draws[f] for f in attempts]).astype(np.int16),
        ref_frame=np.int32(ids[0]), init_frame=np.int32(init_frame),
        frame_ids=np.asarray(ids, np.int32), T=T.astype(np.float32),
        stat_frames=np.asarray([st["frame"] for st in stats], np.int32),
        n_inliers=np.asarray([st["inliers"] for st in stats], np.int32),
        keyframe=np.asarray([bool(st.get("keyframe")) for st in stats]),
        n_keyframes=np.int32(n_kf), n_points=np.int32(n_pt),
        kf_frame_id=np.asarray(s.map.kf_frame_id)[kf_valid],
        kf_pose=np.asarray(s.map.kf_pose)[kf_valid].astype(np.float32),
        gt_T=gt.astype(np.float32), ate=np.float64(ate))


def main() -> int:
    cfg = smoke_config()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    poses = traj.poses_cw[:MAPPING_FRAMES]
    seq = synthetic.render_sequence(cfg.camera,
                                    synthetic.Trajectory(poses), scene)
    os.makedirs(ASSETS, exist_ok=True)
    if "--mapping-only" not in sys.argv:
        map_and_localize(seq, poses)
    mapping_reference(seq, poses)
    for name in ("smoke_map.npz", "smoke_expected.npz",
                 "smoke_mapping_expected.npz"):
        p = os.path.join(ASSETS, name)
        print(f"{p}: {os.path.getsize(p)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
