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
     the database rows after the retrain.

The workload is the bench's (bench.py:140-160: 640x480, 1000 features,
max_keypoints=1024, make_scene(600, seed=3), make_trajectory(360, seed=3))
with the keyframe throttle pinned to 3 frames, so that the map does not
depend on host speed; the localization map uses the default capacity
(K=256, P=32768), the mapping run the bench's (K=64, P=16384).

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_assets.py \
        [--mapping-only | --reloc-only | --loop-only | --stereo-only |
         --rgbd-only | --vocab-only]

--mapping-only rebuilds steps 3 and 4, --reloc-only step 4 alone (it still
runs step 3's mapping, without writing its file), --loop-only step 5 alone
(~4 min), --stereo-only step 6, --rgbd-only step 7, --vocab-only step 8.
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


def main() -> int:
    os.makedirs(ASSETS, exist_ok=True)
    depth_only = {"--stereo-only": lambda: depth_reference("stereo"),
                  "--rgbd-only": lambda: depth_reference("rgbd"),
                  "--vocab-only": vocab_reference}
    for i, (flag, fn) in enumerate(depth_only.items()):
        if flag in sys.argv:
            fn()
            p = os.path.join(ASSETS, DEPTH_ASSETS[i])
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
    for name in ("smoke_map.npz", "smoke_expected.npz",
                 "smoke_mapping_expected.npz", "smoke_reloc_expected.npz",
                 "smoke_loop_map.npz", "smoke_loop_resume.npz",
                 "smoke_loop_expected.npz") + DEPTH_ASSETS:
        p = os.path.join(ASSETS, name)
        print(f"{p}: {os.path.getsize(p)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
