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
     arrays;
  4. carries that run on through a kidnap (RELOC_BLANK grey frames, then
     frames RELOC_RETURN of the same sequence, a viewpoint mapped earlier)
     and writes `smoke_reloc_expected.npz`: per frame the state, lost flag,
     inlier count and pose, the frame the run recovered on with the
     accepted candidate keyframe, and per relocalization attempt the frame
     count, the place-recognition candidates and the EPnP draws
     `ransac_pnp` made for each;
  5. runs the loop workload (640x480, 1000 features, K=96, P=16384,
     make_cylinder_scene(700, seed=5), make_loop_trajectory(115, seed=5,
     frac=1.25): 1.25 laps round a cylinder, default LoopConfig, keyframe
     throttle 3) with loop closing on, and writes `smoke_loop_map.npz` —
     the map as it was handed to the `LoopCloser.on_keyframe` call that
     closed the loop, in the checkpoint layout, plus the database's BoW rows
     and consistency groups, the closer's `last_loop_kf` / `loop_edges` and
     the Sim3 draws of every candidate that call verified —,
     `smoke_loop_resume.npz` — the System's checkpoint after frame 69, before
     the revisit, with its trajectory log (the run is two `run_sequence`
     calls, split there) — and `smoke_loop_expected.npz`: the accepted
     candidate, the expanded inlier count, s / R / t, keyframe poses and
     point positions after `correct_loop` and after `global_ba` on its
     result, and of the whole run the initialisation draws, the frame and keyframe that closed, the
     per-frame poses and the ATE;
  6. stereo at KITTI width: `kitti_config()` (1241x376, 1000 features,
     bf=386.1448) with K=64, P=16384, keyframe throttle 3, loop closing on,
     60 frames of make_trajectory(60, seed=3) in make_scene(600, seed=3),
     stereo pairs from render_stereo_frame with baseline bf / fx, through
     `run_sequence(left, right_images=right)`; writes
     `smoke_stereo_expected.npz`: frame 0's keypoints of both views and
     their `match_stereo` result, the per-frame poses, inliers and keyframe
     flags, the keyframe and point counts and the metric ATE (no scale
     alignment);
  7. RGB-D: the bench's camera (640x480, fx=400) with bf=48 (12 cm),
     1000 features, K=64, P=16384, the same scene and trajectory with
     render_depth, loop closing off; writes `smoke_rgbd_expected.npz`
     (frame 0's keypoints and `rgbd_depth`, then as step 6);
  8. the RGB-D run again for VOCAB_FRAMES frames with
     LoopConfig(vocab_pretrained=False); writes `smoke_vocab_expected.npz`:
     the `_n_added` milestones at which it retrained, and for the first the
     descriptors of the keyframes it pooled (only those: the pool's other
     rows are invalid and never read), their validity, the seed permutation
     (`jax.random.permutation(PRNGKey(0), K * N)`), the trained words and
     the database rows after the retrain;
  9. the two-agent workload of `cli._coop_setup` (make_cylinder_scene(700,
     seed=5), make_loop_trajectory(90, seed=5, frac=0.72), K=128,
     P=32768, its LoopConfig and TrackerConfig) at 640x480 / 1000
     features, the throttle pinned at 3: the receiver (CoopAgent 0) tracks
     frames 0-44, the sender (1) frames 29-89, a publish of <= 10 keyframes
     every 8 steps and two closing pumps, every packet through its npz
     bytes, loop closing off, as `cli.run_coop` runs it.  Writes
     `smoke_coop_merge.npz` (the receiver just before its first successful
     `_try_merge`: the map's used slots, its BoW rows and the cooperative
     bookkeeping, read by `checkpoint.load_coop_state`) and
     `smoke_coop_expected.npz`: that call's foreign keyframe, candidate,
     inlier pairs, S_w, sweep, merge count and keyframe poses after it,
     with its cross-agent Sim3 draws; the same for the call on that state
     without the landmarks its first global BA sends to infinity
     (`runaway_points`); every `_try_merge` attempt, every cross-agent
     Sim3 RANSAC's draws in order, every `_find_cross_sim3` outcome and
     every `_try_realign` with the values it gates on; and of the whole
     run the initialisation draws of both agents, the packet, merge and
     keyframe counts, the keyframes' frames, owners and centres and the
     joint ATE.
  10. the dataset front end: chip_smoke.py's phase 12 directories
     (`chip_smoke.dataset_layouts`: TUM fr1, KITTI 00 and EuRoC layouts
     of make_trajectory(60, seed=3) in make_scene(600, seed=3), written
     with the port's layout writers), each run by the JAX CLI's own driver
     `coslam_tpu.cli._run` (the chunked path) on a System built as the
     CLI's dataset branch builds it — the dataset's preset, its own camera
     where it has one, `sensor=mode`, loop closing on — with the keyframe
     throttle pinned at 3 and the mapper cycle at chip_smoke.MAPPER_CYCLE_S,
     for `mono` on tum, `rgbd` on tum, `stereo` on kitti and `mono` on
     euroc; writes `smoke_dataset_expected.npz`: per run the tracked frame
     ids (the first is the initialisation frame of a depth sensor, the
     reference frame of a monocular initialisation, whose frame is the
     second), poses and timestamps, the keyframes (inserted frames, valid
     count), the lost frames and the ATE as the
     CLI's `_dispatch` computes it, and the sha256 of every file the run
     read.
  11. the tracking hot path (`__graft_entry__.entry()`'s `track_step`,
     jitted, and bench.py's `ex_step` / `em_step` bodies): on the entry's
     example arguments, and on a tracking case — frame BENCH_CASE_FRAME of
     the bench's 8 frames (make_scene(800, seed=0), make_trajectory(8,
     seed=0) at the entry's 640x480 / fx 500 camera), the previous frame's
     keypoints from `build_frame` as prev_*, valid where `render_depth`
     sees a landmark, back-projected at that depth into the world as
     pt_pos, and the frame's true pose as T_pred.  Writes
     `smoke_bench_expected.npz`: both cases' inputs, (T, n_inliers, desc),
     the frame's valid mask and the two prefixes' counts.
  12. the JAX side's scripts (scripts/*.py, loaded as modules; nothing of
     them is changed): (a)-(c) `train_vocab.main` at its defaults with its
     output file redirected into a temporary directory — the first frame of
     each harvest job (descriptors, validity), the harvested count, the
     subsampled pool of 65536, its `PRNGKey(0)` permutation, the 8192
     trained words and the printed occupancy; (d)-(e) `pr_quality.run_scene`
     on cylinder-A (320x240, 400 features, 140 frames), its System captured
     and saved with `checkpoint.save_system` (keys `pr_ckpt_*`), the stats,
     the per-query rows and the unrounded BoW score of each row's ground
     truth; (f) `make_proxy_datasets` at chip_smoke.SCRIPTS_PROXY_FRAMES
     frames: every text file's bytes and every image's decoded sha256; (g)
     `debug_coop.main`'s `final:` line and first probe line.  Writes
     `smoke_scripts_expected.npz`.

The workload is the bench's (bench.py:140-160: 640x480, 1000 features,
max_keypoints=1024, make_scene(600, seed=3), make_trajectory(360, seed=3))
with the keyframe throttle pinned to 3 frames, so that the map does not
depend on host speed; the localization map uses the default capacity
(K=256, P=32768), the mapping run the bench's (K=64, P=16384).

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_assets.py \
        [--mapping-only | --reloc-only | --loop-only | --stereo-only |
         --rgbd-only | --vocab-only | --coop-only | --datasets-only |
         --bench-only | --scripts-only]

--mapping-only rebuilds steps 3 and 4, --reloc-only step 4 alone (it still
runs step 3's mapping, without writing its file), --loop-only step 5 alone
(~4 min), --stereo-only step 6, --rgbd-only step 7, --vocab-only step 8,
--coop-only step 9 (~2 min), --datasets-only step 10, --bench-only step
11 (~20 s), --scripts-only step 12.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from coslam_tpu.config import (CameraConfig, ExtractorConfig,  # noqa: E402
                               LoopConfig, MapperConfig, SystemConfig,
                               TrackerConfig, kitti_config)
from coslam_tpu.models import keyframe_db as jkdb  # noqa: E402
from coslam_tpu.models import loop_closing as jlc  # noqa: E402
from coslam_tpu.models import system as jsystem  # noqa: E402
from coslam_tpu.ops import matching as jmatching  # noqa: E402
from coslam_tpu.models.frame import build_frame  # noqa: E402
from coslam_tpu.models.system import System  # noqa: E402
from coslam_tpu.ops import orb as jorb  # noqa: E402
from coslam_tpu.ops import stereo as jstereo  # noqa: E402
from coslam_tpu.utils import checkpoint, evaluation, synthetic  # noqa: E402

MAP_FRAMES = 80
LOC_FRAMES = (80, 120)
MAPPING_FRAMES = 120
RELOC_BLANK = 3                    # grey frames, ids 1000 ..
RELOC_RETURN = tuple(range(28, 34))   # then these frames again, ids 2000 + i
LOOP_FRAMES = 115                  # 1.25 laps: the revisit begins at frame 92
LOOP_SEED = 5
LOOP_SPLIT = 70                    # the resume checkpoint is taken here
DEPTH_FRAMES = 60                  # stereo and RGB-D runs
VOCAB_FRAMES = 30                  # the RGB-D run without a vocabulary
COOP_FRAMES = 90                   # the two-agent workload (cli._coop_setup)
COOP_SEED = 5
COOP_PUBLISH_EVERY = 8             # cli.run_coop's defaults
COOP_MAX_BATCH = 10
RGBD_BF = 48.0                     # 12 cm at fx = 400
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


def loop_config() -> SystemConfig:
    return smoke_config(MapperConfig(max_keyframes=96, max_points=16384))


def stereo_config() -> SystemConfig:
    return kitti_config(
        mapper=MapperConfig(max_keyframes=64, max_points=16384),
        tracker=TrackerConfig(mapper_latency_frames=3))


def rgbd_config(loop: LoopConfig = LoopConfig()) -> SystemConfig:
    cfg = mapping_config()
    return cfg.replace(camera=dataclasses.replace(cfg.camera, bf=RGBD_BF),
                       sensor="rgbd", loop=loop)


def depth_frames(cfg: SystemConfig, n: int = DEPTH_FRAMES):
    """(left images, right images or depth maps, ground-truth poses) of the
    stereo / RGB-D workloads."""
    scene = synthetic.make_scene(600, seed=3)
    poses = synthetic.make_trajectory(DEPTH_FRAMES, seed=3).poses_cw[:n]
    cam = cfg.camera
    if cfg.sensor == "stereo":
        pairs = [synthetic.render_stereo_frame(cam, T, scene,
                                               baseline=cam.bf / cam.fx)
                 for T in poses]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]), poses)
    return (synthetic.render_sequence(cam, synthetic.Trajectory(poses),
                                      scene),
            np.stack([synthetic.render_depth(cam, T, scene) for T in poses]),
            poses)


class RetrainRecordingDB(jkdb.KeyFrameDatabase):
    """The reference database, keeping its state around each vocabulary
    retrain: the map it was given, the rows and words before and after."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.retrains = []

    def maybe_retrain(self, m):
        before = dict(n_added=self._n_added, bows=self.bows.copy(),
                      has=self.has.copy(), vocab=np.asarray(self.vocab),
                      version=self._version, map=m)
        super().maybe_retrain(m)
        if self._version != before["version"]:
            before.update(words=np.asarray(self.vocab),
                          bows_after=self.bows.copy())
            self.retrains.append(before)


class DrawRecordingSystem(System):
    """The JAX System, recording the RANSAC sample indices of every
    initialisation attempt: `jax.random.choice(fold_in(PRNGKey(0), fid),
    N, (iters, 8), p=valid / sum)`, exactly as `twoview.initialize` draws
    them inside `_init_attempt` (models/system.py:355, ops/twoview.py:249)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.draws = {}
        self.attempts = []     # (frames seen, candidates, draws, accepted)

    def _attempt_relocalization(self, frame):
        """Records, per attempt, the candidates and the (512, 6) indices
        `pnp.ransac_pnp` draws inside `relocalize_against_kf` for each: the
        same seed matching, then the same `jax.random.choice` with the key
        of models/system.py:981-984."""
        cands = self.db.detect_reloc_candidates(frame.desc, frame.valid,
                                                top_k=5)
        base = jax.random.fold_in(self._init_key, self.n_frames_tracked)
        m = self.map
        draws = []
        for c in cands:
            pt = m.kf_obs_pt[c]
            pt_safe = jnp.maximum(pt, 0)
            ok_t = (pt >= 0) & m.kf_kp_valid[c] & m.pt_valid[pt_safe]
            mm = jmatching.match(
                frame.desc, frame.valid, m.pt_desc[pt_safe], ok_t,
                self.cfg.matcher, max_dist=self.cfg.matcher.th_high,
                mutual=True, angle_q=frame.angle, angle_t=m.kf_angle[c])
            p = mm.valid.astype(jnp.float32)
            p = p / (p.sum() + 1e-9)
            draws.append(np.asarray(jax.random.choice(
                jax.random.fold_in(base, c), frame.uv.shape[0], (512, 6),
                replace=True, p=p), np.int16))
        best = super()._attempt_relocalization(frame)
        self.attempts.append((self.n_frames_tracked, cands, draws,
                              -1 if best is None else int(best.ref_kf),
                              0 if best is None else int(best.n_inliers)))
        return best

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


def reloc_reference(s: DrawRecordingSystem, seq, poses) -> None:
    """Carries the mapping run on through a kidnap and records it."""
    t0 = time.perf_counter()
    assert s.state == "OK"
    blank = np.full_like(seq[0], 96)
    frames = [(1000 + i, blank, -1) for i in range(RELOC_BLANK)] \
        + [(2000 + i, seq[i], i) for i in RELOC_RETURN]
    rows = []
    for fid, img, _src in frames:
        T = s.track_mono(img, fid)
        st = s.stats[-1]
        rows.append((fid, s.state == "OK", bool(st["lost"]), st["inliers"],
                     np.asarray(T, np.float32)))
        print(f"  frame {fid}: state {s.state}, inliers {st['inliers']}, "
              f"relocalizations {getattr(s, 'n_relocalizations', 0)}")
    s.shutdown()
    lost = np.array([r[2] for r in rows])
    assert lost[:RELOC_BLANK].all(), "the reference run did not get lost"
    back = [r[0] for r in rows[RELOC_BLANK:] if r[1]]
    assert back and back[0] < 2000 + RELOC_RETURN[4], \
        f"the reference run did not recover within 4 frames: {back}"
    att = s.attempts
    cands = np.full((len(att), 5), -1, np.int32)
    draws = np.zeros((len(att), 5, 512, 6), np.int16)
    for a, (_n, cs, ds, _acc, _inl) in enumerate(att):
        cands[a, :len(cs)] = cs
        for j, d in enumerate(ds):
            draws[a, j] = d
    src = np.asarray([f[2] for f in frames], np.int32)
    print(f"kidnap after frame {MAPPING_FRAMES - 1}: lost on "
          f"{int(lost.sum())} frames, recovered on frame {back[0]} against "
          f"keyframe {[a[3] for a in att if a[3] >= 0][0]} with "
          f"{[a[4] for a in att if a[3] >= 0][0]} inliers, "
          f"{getattr(s, 'n_relocalizations', 0)} relocalizations, "
          f"{len(att)} attempts ({time.perf_counter() - t0:.1f} s)")
    np.savez_compressed(
        os.path.join(ASSETS, "smoke_reloc_expected.npz"),
        frame_ids=np.asarray([r[0] for r in rows], np.int32), source=src,
        ok=np.asarray([r[1] for r in rows]), lost=lost,
        n_inliers=np.asarray([r[3] for r in rows], np.int32),
        T=np.stack([r[4] for r in rows]),
        gt_T=np.stack([poses[max(i, 0)] for i in src]).astype(np.float32),
        recovered_frame=np.int32(back[0]),
        n_relocalizations=np.int32(getattr(s, "n_relocalizations", 0)),
        attempt_frames_seen=np.asarray([a[0] for a in att], np.int32),
        attempt_candidates=cands, attempt_draws=draws,
        attempt_accepted=np.asarray([a[3] for a in att], np.int32),
        attempt_inliers=np.asarray([a[4] for a in att], np.int32))


def mapping_reference(seq, poses, write: bool = True) -> DrawRecordingSystem:
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
    if not write:
        return s
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
    return s


class RecordingLoopCloser(jlc.LoopCloser):
    """The reference LoopCloser, keeping what the closing `on_keyframe`
    call was given and what it computed.  `sim3_between` and `correct_loop`
    are looked up in the module at call time, so wrapping them there
    records the Sim3 draws (`jax.random.choice` with the key and
    probabilities `ransac_sim3` uses) and the accepted similarity.
    `recent` holds the inputs of the last four calls, with the candidates
    the database's loop detector returned (the parity tests replay them)."""

    def __init__(self, cfg, db):
        super().__init__(cfg, db)
        self.closing = None
        self.recent = collections.deque(maxlen=4)
        self._draws = {}
        self._accepted = None

    def on_keyframe(self, m, kf_id, covis_row=None):
        groups = self.db._consistent_groups
        before = dict(
            map=m, kf_id=kf_id, covis_row=np.asarray(covis_row),
            cg_groups=np.asarray(groups[0]) if groups
            else np.zeros((0, len(self.db.has)), bool),
            cg_counts=np.asarray(groups[1]) if groups
            else np.zeros(0, np.int32),
            last_loop_kf=self.last_loop_kf,
            loop_edges=np.asarray(self.loop_edges, np.int32).reshape(-1, 2),
            db_bows=self.db.bows.copy(), db_has=self.db.has.copy())
        self._draws, self._accepted = {}, None
        real_between, real_correct = jlc.sim3_between, jlc.correct_loop
        real_detect = self.db.detect_loop_candidates

        def detect(mm, k, row):
            before["bow_cands"] = real_detect(mm, k, row)
            return before["bow_cands"]

        def between(cfg, mm, k1, k2, idx2, pt1, pt2, ok, key):
            p = ok.astype(jnp.float32)
            p = p / (p.sum() + 1e-9)
            self._draws[(int(k1), int(k2))] = np.asarray(jax.random.choice(
                key, ok.shape[0], shape=(cfg.loop.sim3_ransac_iters, 3),
                replace=True, p=p), np.int16)
            return real_between(cfg, mm, k1, k2, idx2, pt1, pt2, ok, key)

        def correct(cfg, mm, kf_cur, kf_loop, s21, R21, t21, pt1, pt2,
                    pair_ok, **kw):
            out = real_correct(cfg, mm, kf_cur, kf_loop, s21, R21, t21, pt1,
                               pt2, pair_ok, **kw)
            self._accepted = dict(
                candidate=int(kf_loop), n_inliers=int(pair_ok.sum()),
                s=np.asarray(s21), R=np.asarray(R21), t=np.asarray(t21),
                corrected=out)
            return out

        jlc.sim3_between, jlc.correct_loop = between, correct
        self.db.detect_loop_candidates = detect
        try:
            m2, closed = super().on_keyframe(m, kf_id, covis_row=covis_row)
        finally:
            jlc.sim3_between, jlc.correct_loop = real_between, real_correct
            del self.db.detect_loop_candidates
        if self.closing is None:
            self.recent.append(before)
        if closed and self.closing is None:
            self.closing = dict(before, draws=dict(self._draws),
                                **self._accepted)
        return m2, closed


def loop_reference() -> None:
    """The loop workload with loop closing on (step 5)."""
    t0 = time.perf_counter()
    cfg = loop_config()
    scene = synthetic.make_cylinder_scene(700, seed=LOOP_SEED)
    traj = synthetic.make_loop_trajectory(LOOP_FRAMES, seed=LOOP_SEED,
                                          frac=1.25)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)
    s = DrawRecordingSystem(cfg, enable_loop_closing=True)
    s.loop_closer = RecordingLoopCloser(cfg, s.db)
    s.run_sequence(seq[:LOOP_SPLIT])
    assert s.state == "OK" and s.n_loops_closed == 0
    resume_path = os.path.join(ASSETS, "smoke_loop_resume.npz")
    checkpoint.save_system(resume_path, s)
    with np.load(resume_path) as z:
        saved = {k: z[k] for k in z.files}
    np.savez_compressed(
        resume_path, **saved,
        extra_traj_frame=np.asarray([f for f, _, _ in s.trajectory], np.int32),
        extra_traj_ref_kf=np.asarray([r for _, r, _ in s.trajectory],
                                     np.int32),
        extra_traj_T_rel=np.stack([np.asarray(t, np.float32)
                                   for _, _, t in s.trajectory]),
        extra_last_ref_kf=np.int32(s.last_ref_kf),
        extra_n_frames_tracked=np.int32(s.n_frames_tracked))
    s.run_sequence(seq[LOOP_SPLIT:],
                   frame_ids=list(range(LOOP_SPLIT, LOOP_FRAMES)))
    s.shutdown()
    c = s.loop_closer.closing
    assert s.n_loops_closed >= 1 and c is not None, "no loop was closed"
    assert s.state == "OK"
    ids, T = s.trajectory_poses()
    lost = sum(1 for st in s.stats if st.get("lost"))
    assert lost == 0, f"the reference loop run lost {lost} frames"
    gt = traj.poses_cw[np.asarray(ids)]
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(gt))
    init_frame = int(ids[1])
    later_draws(s, seq, int(ids[0]), range(init_frame + 1, init_frame + 6))
    attempts = sorted(s.draws)
    loop_frames = [st["frame"] for st in s.stats if st.get("loop_closed")]

    m0 = c["map"]
    pairs = sorted(c["draws"])
    checkpoint.save_map(
        os.path.join(ASSETS, "smoke_loop_map.npz"), m0, extra=dict(
            db_bows=c["db_bows"], db_has=c["db_has"],
            db_vocab=np.asarray(s.db.vocab), kf_id=np.int32(c["kf_id"]),
            covis_row=c["covis_row"], cg_groups=c["cg_groups"],
            cg_counts=c["cg_counts"], last_loop_kf=np.int64(c["last_loop_kf"]),
            loop_edges=c["loop_edges"],
            sim3_draw_pairs=np.asarray(pairs, np.int32).reshape(-1, 2),
            sim3_draws=np.stack([c["draws"][p] for p in pairs])))
    mc = c["corrected"]
    mg = jlc.global_ba(cfg, mc)
    kf_valid = np.asarray(m0.kf_valid)
    print(f"loop frames 0-{LOOP_FRAMES - 1}: initialised at frame "
          f"{init_frame}, loop closed on frame {loop_frames} by keyframe "
          f"{c['kf_id']} (frame {int(np.asarray(m0.kf_frame_id)[c['kf_id']])})"
          f" against keyframe {c['candidate']} with {c['n_inliers']} inliers,"
          f" scale {float(c['s']):.4f}; {int(kf_valid.sum())} keyframes at "
          f"the closure, {s.n_loops_closed} loops, ATE {ate:.5f} "
          f"({time.perf_counter() - t0:.1f} s)")
    np.savez_compressed(
        os.path.join(ASSETS, "smoke_loop_expected.npz"),
        kf_id=np.int32(c["kf_id"]), candidate=np.int32(c["candidate"]),
        n_inliers=np.int32(c["n_inliers"]),
        s=c["s"], R=c["R"], t=c["t"],
        kf_pose_corrected=np.asarray(mc.kf_pose),
        pt_pos_corrected=np.asarray(mc.pt_pos),
        pt_valid_corrected=np.asarray(mc.pt_valid),
        kf_pose_gba=np.asarray(mg.kf_pose), pt_pos_gba=np.asarray(mg.pt_pos),
        draw_frames=np.asarray(attempts, np.int32),
        draws=np.stack([s.draws[f] for f in attempts]).astype(np.int16),
        init_frame=np.int32(init_frame),
        loop_frame=np.int32(loop_frames[0]),
        loop_kf_frame=np.asarray(m0.kf_frame_id)[c["kf_id"]],
        n_loops_closed=np.int32(s.n_loops_closed),
        frame_ids=np.asarray(ids, np.int32), T=T.astype(np.float32),
        gt_T=gt.astype(np.float32), ate=np.float64(ate))


def _kps_arrays(prefix: str, kps) -> dict:
    return {f"{prefix}_{k}": np.asarray(kps[k])
            for k in ("uv", "level", "desc", "valid")}


def depth_reference(sensor: str) -> None:
    """Step 6 (stereo) or 7 (RGB-D)."""
    t0 = time.perf_counter()
    cfg = stereo_config() if sensor == "stereo" else rgbd_config()
    left, aux, poses = depth_frames(cfg)
    f0 = build_frame(jnp.asarray(left[0]), cfg)
    kpsL = {"uv": f0.uv, "level": f0.level, "desc": f0.desc,
            "valid": f0.valid}
    extra = _kps_arrays("kpl", kpsL)
    if sensor == "stereo":
        kpsR = jorb.extract(jnp.asarray(aux[0]), cfg.extractor)
        extra.update(_kps_arrays("kpr", kpsR))
        sd = jstereo.match_stereo(cfg.camera, cfg.extractor, cfg.matcher,
                                  kpsL, kpsR, jnp.asarray(left[0]),
                                  jnp.asarray(aux[0]))
        s = System(cfg)
        s.run_sequence(left, right_images=aux)
    else:
        sd = jstereo.rgbd_depth(cfg.camera, f0.uv, f0.valid,
                                jnp.asarray(aux[0]))
        s = System(cfg, enable_loop_closing=False)
        s.run_sequence(left, depths=aux)
    info = s.shutdown()
    ids, T = s.trajectory_poses()
    lost = sum(1 for st in s.stats if st.get("lost"))
    assert lost == 0 and s.state == "OK", f"the reference run lost {lost}"
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(poses[ids]),
                              with_scale=False)
    n_kf = int(np.asarray(s.map.kf_valid).sum())
    n_pt = int(np.asarray(s.map.pt_valid).sum())
    kf_frames = [st["frame"] for st in s.stats if st.get("keyframe")]
    print(f"{sensor} frames 0-{DEPTH_FRAMES - 1}: initialised at frame "
          f"{ids[0]}, {len(ids)} tracked, lost {lost}, {len(kf_frames)} "
          f"keyframes inserted, {n_kf} valid, {n_pt} points, loops "
          f"{s.n_loops_closed}, metric ATE {ate:.5f}, chunk discard rate "
          f"{info['chunk_discard_rate']}; frame 0: "
          f"{int(sd.valid.sum())} keypoints with depth "
          f"({time.perf_counter() - t0:.1f} s)")
    np.savez_compressed(
        os.path.join(ASSETS, f"smoke_{sensor}_expected.npz"),
        frame_ids=np.asarray(ids, np.int32), T=T.astype(np.float32),
        n_inliers=np.asarray([st["inliers"] for st in s.stats], np.int32),
        kf_frames=np.asarray(kf_frames, np.int32),
        n_keyframes=np.int32(n_kf), n_points=np.int32(n_pt),
        n_loops=np.int32(s.n_loops_closed), ate=np.float64(ate),
        chunk_discard_rate=np.float64(info["chunk_discard_rate"]),
        sd_u_right=np.asarray(sd.u_right), sd_depth=np.asarray(sd.depth),
        sd_valid=np.asarray(sd.valid), **extra)


def vocab_reference() -> None:
    """Step 8."""
    t0 = time.perf_counter()
    cfg = rgbd_config(LoopConfig(vocab_pretrained=False))
    left, aux, _ = depth_frames(cfg, VOCAB_FRAMES)
    s = System(cfg, enable_loop_closing=False)
    s.db = RetrainRecordingDB(cfg)
    s.run_sequence(left, depths=aux)
    s.shutdown()
    recs = s.db.retrains
    assert recs, "the reference run did not retrain"
    first = recs[0]
    m = first["map"]
    K, N = m.kf_obs_pt.shape
    kf = np.nonzero(np.asarray(m.kf_valid))[0]
    ok = np.asarray(m.kf_kp_valid & m.kf_valid[:, None])
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), K * N))
    print(f"vocabulary: retrained at {[r['n_added'] for r in recs]} added "
          f"keyframes in {VOCAB_FRAMES} frames; the first pool holds "
          f"{int(ok.sum())} descriptors of keyframes {list(kf)} "
          f"({time.perf_counter() - t0:.1f} s)")
    np.savez_compressed(
        os.path.join(ASSETS, "smoke_vocab_expected.npz"),
        milestones=np.asarray([r["n_added"] for r in recs], np.int32),
        K=np.int32(K), N=np.int32(N), kf=kf.astype(np.int32),
        desc=np.asarray(m.kf_desc)[kf], kp_valid=ok[kf],
        perm=perm.astype(np.int32), words=first["words"],
        rows=first["bows_after"][first["has"]],
        row_kf=np.nonzero(first["has"])[0].astype(np.int32),
        n_keyframes=np.int32(np.asarray(s.map.kf_valid).sum()))


DEPTH_ASSETS = ("smoke_stereo_expected.npz", "smoke_rgbd_expected.npz",
                "smoke_vocab_expected.npz")
COOP_ASSETS = ("smoke_coop_merge.npz", "smoke_coop_expected.npz")
DATASET_ASSET = "smoke_dataset_expected.npz"
BENCH_ASSET = "smoke_bench_expected.npz"
BENCH_CASE_FRAME = 4               # the tracking case: frame 4 after 3


def coop_setup():
    """`cli._coop_setup`'s configuration and arcs at the bench's camera and
    extractor (640x480, fx = fy = 400, 1000 features), the keyframe throttle
    pinned at 3: (cfg, trajectory, frames, receiver's last frame + 1,
    sender's first frame)."""
    from coslam_tpu import cli as jcli
    cfg, traj, _seq, split0, start1 = jcli._coop_setup(COOP_FRAMES,
                                                       COOP_SEED)
    full = smoke_config(cfg.mapper)
    cfg = cfg.replace(camera=full.camera, extractor=full.extractor,
                      tracker=dataclasses.replace(cfg.tracker,
                                                  mapper_latency_frames=3))
    scene = synthetic.make_cylinder_scene(700, seed=COOP_SEED)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)
    return cfg, traj, seq, split0, start1


def realign_gates(S, pt1, pt2, pairs, pt_pos):
    """The values `CoopAgent._try_realign` gates a verified residual Sim3
    on: its scale (0.8-1.25), its angle in degrees (<= 15), and the median
    distance of the fused pairs' duplicate landmarks before and after it
    (after < before; nan with fewer than 6 pairs, where it is not
    checked)."""
    s, R, t = (float(S["s"]), np.asarray(S["R"], np.float32),
               np.asarray(S["t"], np.float32))
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    p1, p2 = np.asarray(pt1), np.asarray(pt2)
    sel = np.asarray(pairs) & (p1 != p2)
    if sel.sum() < 6:
        return s, float(ang), np.nan, np.nan
    pos = np.asarray(pt_pos)
    a, b = pos[p1[sel]], pos[p2[sel]]
    pre = np.median(np.linalg.norm(a - b, axis=1))
    post = np.median(np.linalg.norm((s * a @ R.T + t) - b, axis=1))
    return s, float(ang), float(pre), float(post)


def _coop_agent_class():
    from coslam_tpu.models import cooperative as jcoop

    class RecordingCoopAgent(jcoop.CoopAgent, DrawRecordingSystem):
        """The reference CoopAgent, recording its initialisation draws
        (DrawRecordingSystem), the Sim3 draws of every cross-agent
        verification (keyed (foreign keyframe, candidate), as
        `jax.random.choice` makes them inside `ransac_sim3` with the key
        `PRNGKey(1234 + foreign_kf)`), and every `_try_merge` call: its
        outcome and, for the first that merges, the agent's state before
        it, what `_find_cross_sim3` returned and the map after it."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sim3_draws = {}
            self.merge_attempts = []       # (driver step, foreign kf, ok, s)
            self.first_merge = None
            self.step = -1
            self.in_receive = False
            self._found = []
            self._last_pair = None
            # every cross-agent Sim3 RANSAC of the run, in order: (foreign
            # kf, candidate, draws); every _find_cross_sim3 call with its
            # outcome; every _try_realign with the values it gates on
            self.draw_log = []
            self.find_log = []      # (step, fk, cand, pairs, s, in receive)
            self.realign_log = []   # (step, fk, realigned)
            self.realign_vals = []  # realign_gates(), nan where unverified
            self._realign_out = None

        def receive_packet(self, pkt):
            self.in_receive = True
            try:
                return super().receive_packet(pkt)
            finally:
                self.in_receive = False

        def _find_cross_sim3(self, foreign_kf):
            self._last_pair = None
            out = super()._find_cross_sim3(foreign_kf)
            self._found.append((foreign_kf, self._last_pair, out))
            self.find_log.append((
                self.step, foreign_kf,
                self._last_pair[1] if out is not None and self._last_pair
                else -1,
                int(np.asarray(out[3]).sum()) if out is not None else 0,
                float(out[0]["s"]) if out is not None else 0.0,
                self.in_receive))
            if out is not None and self._realign_out is not None:
                self._realign_out = realign_gates(out[0], *out[1:],
                                                  self.map.pt_pos)
            return out

        def _try_realign(self, foreign_kf, agent_id):
            self._realign_out = (np.nan,) * 4
            ok = super()._try_realign(foreign_kf, agent_id)
            self.realign_log.append((self.step, foreign_kf, ok))
            self.realign_vals.append(self._realign_out)
            self._realign_out = None
            return ok

        def _try_merge(self, foreign_kf, agent_id):
            first = self.first_merge is None
            before = self.snapshot() if first else None
            self.sim3_draws, self._found = {}, []
            t0 = time.perf_counter()
            ok = super()._try_merge(foreign_kf, agent_id)
            self.merge_attempts.append((self.step, foreign_kf, ok,
                                        time.perf_counter() - t0))
            if ok and first:
                fk, pair, (S_w, _p1, _p2, pairs) = self._found[0]
                assert fk == foreign_kf and pair[0] == foreign_kf
                self.first_merge = dict(
                    before=before, foreign_kf=foreign_kf,
                    candidate=pair[1], n_inliers=int(np.asarray(pairs).sum()),
                    s=np.float64(S_w["s"]), R=np.asarray(S_w["R"]),
                    t=np.asarray(S_w["t"]), draws=dict(self.sim3_draws),
                    after=self.map, n_merges_after=self.n_merges,
                    step=self.step, from_receive=self.in_receive,
                    realigns=[(k, pr[1] if pr else -1, o is not None)
                              for k, pr, o in self._found[1:]])
            return ok

        def snapshot(self):
            return dict(
                map=self.map, db_bows=self.db.bows.copy(),
                db_has=self.db.has.copy(), db_n_added=self.db._n_added,
                kf_agent=self.kf_agent.copy(), pt_agent=self.pt_agent.copy(),
                kf_sent=self._kf_sent.copy(),
                foreign_pt=dict(self._foreign_pt),
                foreign_agents=sorted(self._foreign_agents),
                merged_agents=dict(self.merged_agents),
                agent_sim3=dict(self._agent_sim3), n_merges=self.n_merges,
                published_kfs=self._published_kfs,
                host_n_kf=self._host_n_kf, host_n_pt=self._host_n_pt)

    return RecordingCoopAgent


def _compact_map_arrays(m) -> dict:
    """The map's used slots (keyframes below n_kf, points below n_pt) in
    the checkpoint layout; asserts that every slot past them holds what an
    empty map holds there, so that padding restores the map exactly."""
    from coslam_tpu.models import map_state as jms
    n_kf, n_pt = int(m.n_kf), int(m.n_pt)
    K, P = m.kf_pose.shape[0], m.pt_pos.shape[0]
    cfg = smoke_config(MapperConfig(max_keyframes=K, max_points=P))
    cfg = cfg.replace(extractor=dataclasses.replace(
        cfg.extractor, max_keypoints=int(m.kf_uv.shape[1])))
    empty = jms.empty_map(cfg)
    out = {}
    for k, v in m._asdict().items():
        a, e = np.asarray(v), np.asarray(getattr(empty, k))
        if k.startswith(("kf_", "pt_")):
            n = n_kf if k.startswith("kf_") else n_pt
            assert np.array_equal(a[n:], e[n:]), f"{k} past the used slots"
            a = a[:n]
        out[f"map_{k}"] = a
    return out


def _agent_from_snapshot(Agent, cfg, snap, drop_points=()):
    """A fresh recording agent in the state `snap` recorded (the receiver
    before a `_try_merge` call), with the landmarks `drop_points`
    invalidated."""
    a = Agent(cfg, 0, enable_loop_closing=False)
    m = snap["map"]
    if len(drop_points):
        m = m._replace(pt_valid=m.pt_valid.at[
            jnp.asarray(np.asarray(drop_points))].set(False))
    a.map = m
    a.state = "OK"
    a.db.bows, a.db.has = snap["db_bows"].copy(), snap["db_has"].copy()
    a.db._n_added = snap["db_n_added"]
    a.db._version += 1
    a.kf_agent, a.pt_agent = snap["kf_agent"].copy(), snap["pt_agent"].copy()
    a._kf_sent = snap["kf_sent"].copy()
    a._foreign_pt = dict(snap["foreign_pt"])
    a._foreign_agents = set(snap["foreign_agents"])
    a.merged_agents = dict(snap["merged_agents"])
    a._agent_sim3 = dict(snap["agent_sim3"])
    a.n_merges, a._published_kfs = snap["n_merges"], snap["published_kfs"]
    a._host_n_kf, a._host_n_pt = snap["host_n_kf"], snap["host_n_pt"]
    return a


def runaway_points(Agent, cfg, snap, foreign_kf: int, agent_id: int):
    """Landmarks that the merging call's first global BA (`_apply_cross_sim3`
    on its own alignment, 5 iterations, and the same run to 8) carries
    beyond ten times the farthest landmark of the map before the call,
    removed until none is left.  Such a landmark (seen by a few keyframes
    with next to no parallax) leaves its 3x3 normal block near singular,
    and an f32 solve then moves every keyframe by rounding: the JAX
    package's own call, with each landmark moved by one ulp, ends with
    keyframe centres 1e-2 of the map's extent away."""
    from coslam_tpu.models import cooperative as jcoop
    from coslam_tpu.models import local_mapping as jlm
    m0 = snap["map"]
    lim = 10 * np.linalg.norm(np.asarray(m0.pt_pos)[np.asarray(m0.pt_valid)],
                              axis=1).max()
    far = np.zeros(m0.pt_pos.shape[0], bool)
    while True:
        a = _agent_from_snapshot(Agent, cfg, snap, np.nonzero(far)[0])
        S, p1, p2, pairs = a._find_cross_sim3(foreign_kf)
        m = a.map
        m = jcoop._apply_sim3_to_component(
            cfg, m, S["s"], S["R"], S["t"],
            jnp.asarray(a.kf_agent == agent_id) & m.kf_valid,
            jnp.asarray(a.pt_agent == agent_id) & m.pt_valid)
        m = jlm.refresh_point_geometry(
            cfg, jlc.fuse_landmarks(cfg, m, p1, p2, pairs))
        new = np.zeros_like(far)
        for iters in (5, 8):
            r = jlc.global_ba(cfg, m, iters=iters)
            new |= np.asarray(m.pt_valid) & (
                np.linalg.norm(np.asarray(r.pt_pos), axis=1) > lim)
        if not new.any():
            return np.nonzero(far)[0]
        far |= new


def coop_reference(out_dir: str = ASSETS) -> None:
    """The two-agent workload (step 9); its files go to `out_dir`."""
    from coslam_tpu.models import cooperative as jcoop
    from coslam_tpu.models import map_state as jms
    t0 = time.perf_counter()
    cfg, traj, seq, split0, start1 = coop_setup()
    Agent = _coop_agent_class()
    a0 = Agent(cfg, 0, enable_loop_closing=False)         # receiver
    a1 = Agent(cfg, 1, enable_loop_closing=False)         # sender
    real_between = jlc.sim3_between
    recorder = [a0]

    def between(c, mm, k1, k2, idx2, pt1, pt2, ok, key):
        p = ok.astype(jnp.float32)
        p = p / (p.sum() + 1e-9)
        d = np.asarray(jax.random.choice(
            key, ok.shape[0], shape=(c.loop.sim3_ransac_iters, 3),
            replace=True, p=p), np.int16)
        recorder[0].sim3_draws[(int(k1), int(k2))] = d
        recorder[0].draw_log.append((int(k1), int(k2), d))
        recorder[0]._last_pair = (int(k1), int(k2))
        return real_between(c, mm, k1, k2, idx2, pt1, pt2, ok, key)

    bus = jcoop.InMemoryBus()
    pending = []
    n_packets = [0]

    def pump():
        bus.publish(1, a1.drain_packets(max_batch=COOP_MAX_BATCH),
                    subscribers=[0, 1])
        pending.extend(jcoop.deserialize_packet(jcoop.serialize_packet(p))
                       for p in bus.drain(0))
        if a0.state == "OK":
            while pending:
                a0.receive_packet(pending.pop(0))
                n_packets[0] += 1

    jlc.sim3_between = between
    try:
        for i in range(max(split0, COOP_FRAMES - start1)):
            a0.step = i
            f0, f1 = i, start1 + i
            if f0 < split0:
                a0.track_mono(seq[f0], f0)
            if f1 < COOP_FRAMES:
                a1.track_mono(seq[f1], f1)
            if i and i % COOP_PUBLISH_EVERY == 0:
                pump()
        a0.step = -1
        pump()
        pump()
        run_draws = list(a0.draw_log)   # runaway_points draws through a0 too
        fm = a0.first_merge
        assert fm is not None, "the reference coop run did not merge"
        # the merging call again, on its state with the runaway landmarks
        # of its first global BA removed
        drop = runaway_points(Agent, cfg, fm["before"], fm["foreign_kf"], 1)
        ac = _agent_from_snapshot(Agent, cfg, fm["before"], drop)
        recorder[0] = ac
        ac.step = fm["step"]
        if not ac._try_merge(fm["foreign_kf"], 1):
            raise RuntimeError("no merge on the conditioned state")
        cm = ac.first_merge
    finally:
        jlc.sim3_between = real_between
    for a in (a0, a1):
        assert a.state == "OK", a.state
        assert not any(st.get("lost") for st in a.stats), "lost frames"

    m = a0.map
    K = int(m.n_kf)
    valid = np.asarray(m.kf_valid[:K])
    fid = np.asarray(m.kf_frame_id[:K])
    agent = a0.kf_agent[:K]
    centers = np.asarray(jms.kf_centers(m))[:K]
    gt = evaluation.trajectory_xyz(traj.poses_cw[fid])
    ate = evaluation.ate_rmse(centers[valid], gt[valid])
    kf_own = int((valid & (agent == 0)).sum())
    kf_foreign = int((valid & (agent != 0) & (agent >= 0)).sum())
    draws = {}
    for tag, a in (("r", a0), ("s", a1)):
        ids = a.trajectory_poses()[0]
        init = int(ids[1])
        later_draws(a, seq, int(ids[0]), range(init + 1, init + 6))
        frames = sorted(a.draws)
        draws[f"{tag}_init_frame"] = np.int32(init)
        draws[f"{tag}_ref_frame"] = np.int32(ids[0])
        draws[f"{tag}_draw_frames"] = np.asarray(frames, np.int32)
        draws[f"{tag}_draws"] = np.stack([a.draws[f] for f in frames]) \
            .astype(np.int16)
    fails = [a for a in a0.merge_attempts if not a[2]]
    n_before = [a[2] for a in a0.merge_attempts].index(True)
    print(f"coop {COOP_FRAMES} frames (receiver 0-{split0 - 1}, sender "
          f"{start1}-{COOP_FRAMES - 1}): receiver initialised at frame "
          f"{int(draws['r_init_frame'])}, sender at "
          f"{int(draws['s_init_frame'])}; {n_packets[0]} packets received; "
          f"first merge at driver step {fm['step']} (from "
          f"{'receive_packet' if fm['from_receive'] else '_merge_retry'}) on "
          f"foreign keyframe {fm['foreign_kf']} against {fm['candidate']} "
          f"with {fm['n_inliers']} inlier pairs, s {fm['s']:.5f}, after "
          f"{n_before} attempts; sweep {fm['realigns']}; merges "
          f"{a0.n_merges}, own keyframes {kf_own}, foreign {kf_foreign}, "
          f"points {int(np.asarray(m.pt_valid).sum())}, joint ATE {ate:.5f}; "
          f"{len(fails)} attempts without a merge; without the runaway "
          f"landmarks {drop.tolist()} the call merges on {cm['foreign_kf']} "
          f"against {cm['candidate']} with {cm['n_inliers']} pairs, sweep "
          f"{cm['realigns']}, merges after {cm['n_merges_after']} "
          f"({time.perf_counter() - t0:.1f} s)")

    b = fm["before"]
    mb = b["map"]
    fpt = np.asarray([(k[0], k[1], v) for k, v in b["foreign_pt"].items()],
                     np.int64).reshape(-1, 3)
    sims = sorted(b["agent_sim3"])
    np.savez_compressed(
        os.path.join(out_dir, "smoke_coop_merge.npz"),
        **_compact_map_arrays(mb),
        extra_max_keyframes=np.int32(mb.kf_pose.shape[0]),
        extra_max_points=np.int32(mb.pt_pos.shape[0]),
        extra_db_bows=b["db_bows"][:int(mb.n_kf)],
        extra_db_has=b["db_has"][:int(mb.n_kf)],
        extra_db_n_added=np.int32(b["db_n_added"]),
        extra_agent_id=np.int32(0),
        extra_kf_agent=b["kf_agent"][:int(mb.n_kf)],
        extra_pt_agent=b["pt_agent"][:int(mb.n_pt)],
        extra_kf_sent=b["kf_sent"][:int(mb.n_kf)],
        extra_foreign_pt=fpt,
        extra_foreign_agents=np.asarray(b["foreign_agents"], np.int32),
        extra_merged_agents=np.asarray(
            [(k, v) for k, v in b["merged_agents"].items()],
            np.int32).reshape(-1, 2),
        extra_sim3_agents=np.asarray(sims, np.int32),
        extra_sim3_s=np.asarray([b["agent_sim3"][k][0] for k in sims],
                                np.float64),
        extra_sim3_R=np.asarray([b["agent_sim3"][k][1] for k in sims],
                                np.float32).reshape(-1, 3, 3),
        extra_sim3_t=np.asarray([b["agent_sim3"][k][2] for k in sims],
                                np.float32).reshape(-1, 3),
        extra_n_merges=np.int32(b["n_merges"]),
        extra_published_kfs=np.int32(b["published_kfs"]),
        extra_host_n_kf=np.int32(b["host_n_kf"]),
        extra_host_n_pt=np.int32(b["host_n_pt"]))
    ma = fm["after"]
    pairs = sorted(fm["draws"])
    np.savez_compressed(
        os.path.join(out_dir, "smoke_coop_expected.npz"),
        merge_foreign_kf=np.int32(fm["foreign_kf"]),
        merge_agent=np.int32(1),
        merge_candidate=np.int32(fm["candidate"]),
        merge_n_inliers=np.int32(fm["n_inliers"]),
        merge_s=np.float64(fm["s"]), merge_R=fm["R"].astype(np.float32),
        merge_t=fm["t"].astype(np.float32),
        merge_step=np.int32(fm["step"]),
        merge_from_receive=np.bool_(fm["from_receive"]),
        merge_realigns=np.asarray(fm["realigns"], np.int32).reshape(-1, 3),
        merge_n_merges_after=np.int32(fm["n_merges_after"]),
        merge_kf_pose_after=np.asarray(ma.kf_pose)[:int(ma.n_kf)],
        merge_kf_valid_after=np.asarray(ma.kf_valid)[:int(ma.n_kf)],
        merge_n_pt_valid_after=np.int32(np.asarray(ma.pt_valid).sum()),
        merge_draw_pairs=np.asarray(pairs, np.int32).reshape(-1, 2),
        merge_draws=np.stack([fm["draws"][p] for p in pairs]),
        attempts_step=np.asarray([a[0] for a in a0.merge_attempts],
                                 np.int32),
        attempts_kf=np.asarray([a[1] for a in a0.merge_attempts], np.int32),
        attempts_ok=np.asarray([a[2] for a in a0.merge_attempts]),
        n_merges=np.int32(a0.n_merges), kf_own=np.int32(kf_own),
        kf_foreign=np.int32(kf_foreign),
        n_points=np.int32(np.asarray(m.pt_valid).sum()),
        ate=np.float64(ate), kf_frame_id=fid[valid].astype(np.int32),
        kf_agent=agent[valid].astype(np.int32),
        kf_centres=centers[valid].astype(np.float32),
        n_packets=np.int32(n_packets[0]),
        sender_published=np.int32(a1._published_kfs),
        split0=np.int32(split0), start1=np.int32(start1),
        cond_runaway_pts=np.asarray(drop, np.int32),
        cond_candidate=np.int32(cm["candidate"]),
        cond_n_inliers=np.int32(cm["n_inliers"]),
        cond_s=np.float64(cm["s"]), cond_R=cm["R"].astype(np.float32),
        cond_t=cm["t"].astype(np.float32),
        cond_realigns=np.asarray(cm["realigns"], np.int32).reshape(-1, 3),
        cond_n_merges_after=np.int32(cm["n_merges_after"]),
        cond_realign_vals=np.asarray(ac.realign_vals,
                                     np.float64).reshape(-1, 4),
        cond_kf_pose_after=np.asarray(cm["after"].kf_pose)[
            :int(cm["after"].n_kf)],
        cond_kf_valid_after=np.asarray(cm["after"].kf_valid)[
            :int(cm["after"].n_kf)],
        cond_draw_pairs=np.asarray(sorted(cm["draws"]),
                                   np.int32).reshape(-1, 2),
        cond_draws=np.stack([cm["draws"][p] for p in sorted(cm["draws"])]),
        run_draw_pairs=np.asarray([(k, c) for k, c, _d in run_draws],
                                  np.int32).reshape(-1, 2),
        run_draws=np.stack([d for _k, _c, d in run_draws]),
        finds=np.asarray([f[:4] + (f[5],) for f in a0.find_log],
                         np.int32).reshape(-1, 5),
        finds_s=np.asarray([f[4] for f in a0.find_log], np.float64),
        realigns=np.asarray(a0.realign_log, np.int32).reshape(-1, 3),
        realign_vals=np.asarray(a0.realign_vals, np.float64).reshape(-1, 4),
        **draws)


def dataset_reference(out_dir: str = ASSETS) -> None:
    """Step 10."""
    import tempfile

    import chip_smoke as cs
    from coslam_tpu import cli as jcli
    from coslam_tpu import config as jcfg
    from coslam_tpu.utils import io as jio
    from coslam_tpu.utils import profiling as jprof

    loaders = {"tum": jio.load_tum_rgbd,
               "kitti": lambda root: jio.load_kitti(root, "00"),
               "euroc": jio.load_euroc}
    presets = {"tum": jcfg.tum_fr1_config, "kitti": jcfg.kitti_config,
               "euroc": jcfg.euroc_config}
    with tempfile.TemporaryDirectory(prefix="coslam_datasets_") as root:
        cs.dataset_layouts(root)
        hashes = cs.dataset_hashes(root)
        arrays = {"files": np.asarray(list(hashes)),
                  "sha256": np.asarray(list(hashes.values()))}
        for mode, ds in cs.DATASET_RUNS:
            t0 = time.perf_counter()
            key = f"{ds}_{mode}"
            seq = loaders[ds](os.path.join(root, ds))
            cfg = presets[ds]()
            if seq.camera is not None:
                cfg = cfg.replace(camera=seq.camera)
            cfg = cfg.replace(sensor=mode)
            cfg = cfg.replace(tracker=dataclasses.replace(
                cfg.tracker, mapper_latency_frames=3))
            s = System(cfg)
            s._insert_cost_s = cs.MAPPER_CYCLE_S[key]
            s._note_insert_cost = lambda dt: None
            timestamps = jcli._run(s, seq.frames, mode, seq.depth_factor,
                                   jprof.StageTimer(sync=False), 0)
            ids, poses = s.trajectory_poses()
            s.shutdown()
            # ATE as coslam_tpu.cli._dispatch computes it
            ts = np.asarray([timestamps[i] for i in ids])
            gt_idx = np.argmin(np.abs(seq.gt_timestamps[None, :]
                                      - ts[:, None]), axis=1)
            ate = evaluation.ate_rmse(
                evaluation.trajectory_xyz(poses),
                seq.gt_poses_wc[gt_idx][:, :3, 3],
                with_scale=(mode == "mono"))
            lost = [st["frame"] for st in s.stats if st.get("lost")]
            kf_frames = [st["frame"] for st in s.stats if st.get("keyframe")]
            n_kf = int(np.asarray(s.map.kf_valid).sum())
            print(f"{mode} on {ds} ({cfg.camera.width}x{cfg.camera.height}, "
                  f"{len(seq.frames)} frames): first tracked frames "
                  f"{ids[:2]}, {len(ids)} tracked, "
                  f"lost {len(lost)}, {len(kf_frames)} keyframes inserted, "
                  f"{n_kf} valid, loops {s.n_loops_closed}, ATE {ate:.5f} "
                  f"({time.perf_counter() - t0:.1f} s)")
            arrays.update({
                f"{key}_ids": np.asarray(ids, np.int32),
                f"{key}_T": np.asarray(poses, np.float32),
                f"{key}_ts": ts,
                f"{key}_lost": np.asarray(lost, np.int32),
                f"{key}_kf_frames": np.asarray(kf_frames, np.int32),
                f"{key}_n_keyframes": np.int32(n_kf),
                f"{key}_n_loops": np.int32(s.n_loops_closed),
                f"{key}_ate": np.float64(ate)})
    np.savez_compressed(os.path.join(out_dir, DATASET_ASSET), **arrays)


SCRIPTS_ASSET = "smoke_scripts_expected.npz"
# first strided frame of each harvest job of scripts/train_vocab.py (jobs of
# 48, 48, 48, 64 and 64 frames, every second one)
HARVEST_FIRST = (0, 24, 48, 72, 104)


def jax_script(name: str):
    """The JAX side's scripts/<name>.py as a module of its own name
    `jax_script_<name>` (its import-time settings pin JAX to the CPU, as
    this run is already)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout_of(fn, *args):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    print(buf.getvalue(), end="")
    return ret, buf.getvalue()


def train_vocab_reference(tmp: str) -> dict:
    """Step 12 (a)-(c): scripts/train_vocab.py's `main` at its defaults,
    its output file redirected into `tmp` (the JAX package's own
    assets/vocab.npz is not touched)."""
    import re
    import coslam_tpu.models.frame as jframe
    jtv = jax_script("train_vocab")
    frames, pools, calls = {}, [], [0]
    inner_build, inner_harvest = jframe.build_frame, jtv.harvest

    def build(img, cfg):
        f = inner_build(img, cfg)
        if calls[0] in HARVEST_FIRST:
            frames[calls[0]] = jax.device_get((f.desc, f.valid))
        calls[0] += 1
        return f

    def harvest():
        pools.append(inner_harvest())
        return pools[0]

    jframe.build_frame, jtv.harvest, jtv.ROOT = build, harvest, tmp
    argv, sys.argv = sys.argv, ["train_vocab.py"]
    try:
        _, log = _stdout_of(jtv.main)
    finally:
        jframe.build_frame, sys.argv = inner_build, argv
    pool = pools[0]
    rng = np.random.default_rng(0)
    sub = pool[rng.choice(pool.shape[0], 65536, replace=False)]
    with np.load(os.path.join(tmp, "coslam_tpu", "assets", "vocab.npz")) as z:
        words = z["words"]
    occ = re.search(r"occupied (\d+)/\d+, max bucket (\d+)", log)
    secs = re.search(r"\((\d+)s\)", log)
    assert calls[0] == 136, calls
    first = [frames[i] for i in HARVEST_FIRST]
    return {"tv_first_desc": np.stack([d for d, _ in first]),
            "tv_first_valid": np.stack([v for _, v in first]),
            "tv_n_harvested": np.int64(pool.shape[0]),
            "tv_pool": sub,
            "tv_perm": np.asarray(jax.random.permutation(
                jax.random.PRNGKey(0), sub.shape[0]), np.int32),
            "tv_words": words,
            "tv_occupied": np.int32(occ.group(1)),
            "tv_max_bucket": np.int32(occ.group(2)),
            "tv_harvest_s": np.float64(secs.group(1))}


def pr_quality_config() -> SystemConfig:
    """scripts/pr_quality.py's `cfg_for(320, 240)` (a closure there)."""
    return SystemConfig(
        camera=CameraConfig(fx=300, fy=300, cx=160.0, cy=120.0, width=320,
                            height=240),
        extractor=ExtractorConfig(n_features=400, max_keypoints=512),
        mapper=MapperConfig(max_keyframes=192, max_points=32768),
        loop=LoopConfig(min_kfs_between_loops=10),
        tracker=TrackerConfig(init_min_matches=60, init_min_good=35))


def pr_quality_reference(tmp: str) -> dict:
    """Step 12 (d)-(e): scripts/pr_quality.py's `run_scene` on cylinder-A,
    its System captured and saved with checkpoint.save_system."""
    jpq = jax_script("pr_quality")
    captured = []

    class Capturing(jpq.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    jpq.System = Capturing
    name, seed, n_pts, radius, n = "cylinder-A", 11, 700, 10.0, 140
    cfg = pr_quality_config()
    scene = synthetic.make_cylinder_scene(n_pts, radius=radius, seed=seed)
    traj = synthetic.make_loop_trajectory(n, seed=seed, frac=1.25)
    t0 = time.perf_counter()
    K, stats, rows = jpq.run_scene(name, scene, traj, n, cfg)
    wall = time.perf_counter() - t0
    slam = captured[0]
    path = os.path.join(tmp, "pr_system.npz")
    checkpoint.save_system(path, slam)
    lost = sum(1 for st in slam.stats if st.get("lost"))
    print(f"pr_quality {name}: {K} keyframes, {stats['n_q']} queries, "
          f"stats {stats}, {lost} lost, {wall:.1f} s")
    out = {"pr_K": np.int32(K), "pr_frames": np.int32(n),
           "pr_lost": np.int32(lost), "pr_wall_s": np.float64(wall),
           "pr_stat_keys": np.asarray(list(stats)),
           "pr_stats": np.asarray(list(stats.values()), np.int64),
           "pr_rows": np.asarray([r[:4] for r in rows], np.int64)
           .reshape(-1, 4),
           "pr_top3": np.asarray([r[4] for r in rows], np.int64)
           .reshape(-1, 3),
           "pr_score": np.asarray([r[5] for r in rows], np.float64),
           "pr_gt_score": np.asarray(
               [slam.db.scores_against_all(r[0])[r[2]] for r in rows],
               np.float64)}
    with np.load(path) as z:
        out.update({f"pr_ckpt_{k}": z[k] for k in z.files})
    return out


def proxy_reference(tmp: str) -> dict:
    """Step 12 (f): scripts/make_proxy_datasets.py at
    chip_smoke.SCRIPTS_PROXY_FRAMES frames, seed 11: every text file's
    bytes and every image's decoded sha256."""
    import chip_smoke as cs
    jmp = jax_script("make_proxy_datasets")
    root = os.path.join(tmp, "proxies")
    n = cs.SCRIPTS_PROXY_FRAMES
    jmp.make_tum(os.path.join(root, "tum_proxy"), n, 11)
    jmp.make_kitti(os.path.join(root, "kitti_proxy"), n, 11)
    jmp.make_euroc(os.path.join(root, "euroc_proxy"), n, 11)
    texts = cs.proxy_texts(root)
    images = cs.proxy_image_hashes(root)
    blob = b"".join(texts.values())
    return {"px_frames": np.int32(n),
            "px_text_names": np.asarray(list(texts)),
            "px_text_sizes": np.asarray([len(v) for v in texts.values()],
                                        np.int64),
            "px_text_bytes": np.frombuffer(blob, np.uint8),
            "px_image_names": np.asarray(list(images)),
            "px_image_sha256": np.asarray(list(images.values()))}


def debug_coop_reference() -> dict:
    """Step 12 (g): scripts/debug_coop.py's `main`, its printed lines."""
    jdc = jax_script("debug_coop")
    _, log = _stdout_of(jdc.main)
    final = [ln for ln in log.splitlines() if ln.startswith("final:")]
    probes = [ln for ln in log.splitlines() if "[probe kf" in ln]
    return {"dc_final": np.asarray(final[-1]),
            "dc_first_probe": np.asarray(probes[0] if probes else "")}


def scripts_reference(out_dir: str = ASSETS) -> None:
    """Step 12."""
    import tempfile
    arrays = {}
    with tempfile.TemporaryDirectory(prefix="coslam_scripts_") as tmp:
        for fn in (lambda: train_vocab_reference(tmp),
                   lambda: pr_quality_reference(tmp),
                   lambda: proxy_reference(tmp), debug_coop_reference):
            t0 = time.perf_counter()
            arrays.update(fn())
            print(f"({time.perf_counter() - t0:.1f} s)", flush=True)
    np.savez_compressed(os.path.join(out_dir, SCRIPTS_ASSET), **arrays)


def bench_case():
    """The tracking case of step 11 as numpy arrays in track_step's
    argument order (img, prev_uv, prev_desc (uint32), prev_valid,
    prev_level, pt_pos, T_pred)."""
    from __graft_entry__ import _cfg
    cfg = _cfg()
    cam = cfg.camera
    scene = synthetic.make_scene(800, seed=0)
    traj = synthetic.make_trajectory(8, seed=0)
    k = BENCH_CASE_FRAME
    frames = synthetic.render_sequence(cam, traj, scene)
    prev = build_frame(jnp.asarray(frames[k - 1]), cfg)
    uv = np.asarray(prev.uv_raw)
    depth = synthetic.render_depth(cam, traj.poses_cw[k - 1], scene)
    px = np.clip(np.round(uv).astype(np.int64), 0, [cam.width - 1,
                                                    cam.height - 1])
    z = depth[px[:, 1], px[:, 0]].astype(np.float64)
    valid = np.asarray(prev.valid) & (z > 0)
    T = traj.poses_cw[k - 1].astype(np.float64)
    pc = np.stack([(np.asarray(prev.uv)[:, 0] - cam.cx) / cam.fx * z,
                   (np.asarray(prev.uv)[:, 1] - cam.cy) / cam.fy * z, z], 1)
    pw = (pc - T[:3, 3]) @ T[:3, :3]
    return (frames[k], np.asarray(prev.uv), np.asarray(prev.desc), valid,
            np.asarray(prev.level), pw.astype(np.float32),
            traj.poses_cw[k].astype(np.float32))


def bench_reference() -> dict:
    """Step 11's arrays: for the example arguments ("ex_") and the tracking
    case ("case_"), the inputs, track_step's outputs, the frame's valid
    mask and the counts of bench.py's ex_step / em_step bodies."""
    from __graft_entry__ import _cfg, entry
    from coslam_tpu.ops import matching
    fn, example = entry()
    cfg = _cfg()
    step = jax.jit(fn)
    names = ("img", "prev_uv", "prev_desc", "prev_valid", "prev_level",
             "pt_pos", "T_pred")
    out = {}
    for tag, args in (("ex_", example), ("case_", bench_case())):
        img, prev_uv, prev_desc, prev_valid = args[:4]
        T, n, desc = jax.device_get(step(*args))
        f = build_frame(jnp.asarray(img), cfg)
        mm = matching.match_windowed(
            jnp.asarray(prev_desc), jnp.asarray(prev_uv), 20.0,
            jnp.asarray(prev_valid), f.desc, f.uv, f.valid, cfg.matcher,
            max_dist=cfg.matcher.th_high, mutual=True)
        out.update({tag + k: np.asarray(a) for k, a in zip(names, args)})
        out.update({tag + "T": np.asarray(T), tag + "n_inliers":
                    np.asarray(n), tag + "desc": np.asarray(desc),
                    tag + "valid": np.asarray(f.valid),
                    tag + "valid_count": np.asarray(f.valid.sum()),
                    tag + "match_count": np.asarray(mm.valid.sum())})
    return out


def main() -> int:
    os.makedirs(ASSETS, exist_ok=True)
    if "--bench-only" in sys.argv:
        p = os.path.join(ASSETS, BENCH_ASSET)
        np.savez_compressed(p, **bench_reference())
        print(f"{p}: {os.path.getsize(p)} bytes")
        return 0
    depth_only = {"--stereo-only": lambda: depth_reference("stereo"),
                  "--rgbd-only": lambda: depth_reference("rgbd"),
                  "--vocab-only": vocab_reference}
    for i, (flag, fn) in enumerate(depth_only.items()):
        if flag in sys.argv:
            fn()
            p = os.path.join(ASSETS, DEPTH_ASSETS[i])
            print(f"{p}: {os.path.getsize(p)} bytes")
            return 0
    if "--scripts-only" in sys.argv:
        scripts_reference()
        p = os.path.join(ASSETS, SCRIPTS_ASSET)
        print(f"{p}: {os.path.getsize(p)} bytes")
        return 0
    if "--datasets-only" in sys.argv:
        dataset_reference()
        p = os.path.join(ASSETS, DATASET_ASSET)
        print(f"{p}: {os.path.getsize(p)} bytes")
        return 0
    if "--coop-only" in sys.argv:
        coop_reference()
        for name in COOP_ASSETS:
            p = os.path.join(ASSETS, name)
            print(f"{p}: {os.path.getsize(p)} bytes")
        return 0
    reloc_only = "--reloc-only" in sys.argv
    loop_only = "--loop-only" in sys.argv
    if not loop_only:
        cfg = smoke_config()
        scene = synthetic.make_scene(600, seed=3)
        traj = synthetic.make_trajectory(360, seed=3)
        poses = traj.poses_cw[:MAPPING_FRAMES]
        seq = synthetic.render_sequence(cfg.camera,
                                        synthetic.Trajectory(poses), scene)
        if "--mapping-only" not in sys.argv and not reloc_only:
            map_and_localize(seq, poses)
        reloc_reference(mapping_reference(seq, poses, write=not reloc_only),
                        seq, poses)
    if loop_only or len(sys.argv) == 1:
        loop_reference()
    if len(sys.argv) == 1:
        for fn in depth_only.values():
            fn()
        coop_reference()
        dataset_reference()
        np.savez_compressed(os.path.join(ASSETS, BENCH_ASSET),
                            **bench_reference())
        scripts_reference()
    for name in ("smoke_map.npz", "smoke_expected.npz",
                 "smoke_mapping_expected.npz", "smoke_reloc_expected.npz",
                 "smoke_loop_map.npz", "smoke_loop_resume.npz",
                 "smoke_loop_expected.npz") + DEPTH_ASSETS + COOP_ASSETS \
            + (DATASET_ASSET, BENCH_ASSET, SCRIPTS_ASSET):
        p = os.path.join(ASSETS, name)
        print(f"{p}: {os.path.getsize(p)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
