"""Monocular mapping end to end: `System.run_sequence` / `track_mono` from
the first frame, and resumed from a checkpoint, in both packages.

Workload: 640x480, 500 features / 512 keypoints, K=32, P=4096, keyframe
throttle 3, loop closing off, frames 0-19 of make_scene(600, seed=3) /
make_trajectory(36, seed=3).  The reference's RANSAC draws of every
initialisation attempt are recorded and injected into the port
(`System.init_draws`).  The trajectory is chosen so that the reference's
initialisation decision is not decided by float rounding: on
make_trajectory(24) and on the bench workload the winning F hypothesis
leads its runner-up by less than the f32 scoring noise (ROADMAP Queue 3).

Bars: the same initialisation and reference frames, the same tracked frame
ids, the same keyframe frames, per-frame inliers within max(3, 5%), camera
centres within 5e-3 of the reference's (the CPU port sits at ~5e-4), the
same keyframe count, no frame lost."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import map_state as jms
from coslam_tpu.models import tracking as jtr
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.utils import checkpoint as jck
from coslam_tpu.utils import geometry as jgeo
from coslam_tpu.utils import io as jio
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import tracking as ttr
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.utils import checkpoint as tck
from coslam_tpu_torch.utils import geometry as tgeo
from coslam_tpu_torch.utils import io as tio
from torch_mapping_common import (FRAMES, DrawRecorder, assert_runs_agree,
                                  mapping_cfg, sequence)

@pytest.fixture(scope="module")
def reference():
    seq = sequence()
    js = DrawRecorder(mapping_cfg(jcfg), enable_loop_closing=False)
    js.run_sequence(seq)
    return js, seq


def test_run_sequence_from_first_frame(reference, tmp_path):
    js, seq = reference
    ts = TSystem(mapping_cfg(tcfg), device="cpu", enable_loop_closing=False)
    ts.init_draws = dict(js.draws)
    ts.run_sequence(seq)
    assert ts.state == "OK"
    jid, _ = js.trajectory_poses()
    tid, _ = ts.trajectory_poses()
    assert tid[:2] == jid[:2]                  # reference + init frame
    assert sum(1 for st in js.stats if st.get("keyframe")) >= 3
    assert_runs_agree(js, ts)
    np.testing.assert_allclose(ts.db.bows, js.db.bows, atol=1e-6)
    np.testing.assert_array_equal(ts.db.has, js.db.has)
    # System's trajectory writers: the same rows and timestamps, poses
    # within the run's bars
    for name in ("save_trajectory_tum", "save_keyframe_trajectory_tum",
                 "save_trajectory_kitti"):
        jp, tp = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
        getattr(js, name)(jp)
        getattr(ts, name)(tp)
        a, b = np.loadtxt(tp, ndmin=2), np.loadtxt(jp, ndmin=2)
        assert a.shape == b.shape, name
        if "tum" in name:
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a, b, atol=1e-2, err_msg=name)
    info = ts.shutdown()
    assert info["keyframes"] == int(np.asarray(js.map.kf_valid).sum())
    assert info["map_points"] > 100


def test_track_mono_per_frame(reference):
    """The per-frame path: initialisation, tracking, `_need_keyframe` and
    `_insert_keyframe`, frame by frame."""
    js0, seq = reference
    js = JSystem(mapping_cfg(jcfg), enable_loop_closing=False)
    ts = TSystem(mapping_cfg(tcfg), device="cpu", enable_loop_closing=False)
    ts.init_draws = dict(js0.draws)
    for i in range(12):
        jT = js.track_mono(seq[i], i)
        tT = ts.track_mono(seq[i], i)
        assert (jT is None) == (tT is None), i
    assert sum(1 for st in js.stats if st.get("keyframe")) >= 1
    assert_runs_agree(js, ts)


def test_resume_mapping_from_checkpoint(reference, tmp_path):
    """load_system -> deactivate_localization_mode -> mapping continues:
    the restored point-counter mirror and database drive the inserts."""
    _, seq = reference
    path = str(tmp_path / "mid.npz")
    js0 = JSystem(mapping_cfg(jcfg), enable_loop_closing=False)
    js0.run_sequence(seq[:10])
    jck.save_system(path, js0)
    js = JSystem(mapping_cfg(jcfg), enable_loop_closing=False)
    jck.load_system(path, js)
    ts = TSystem(mapping_cfg(tcfg), device="cpu", enable_loop_closing=False)
    tck.load_system(path, ts)
    assert ts._host_n_pt == js._host_n_pt > 0
    for s in (js, ts):
        s.activate_localization_mode()
        s.deactivate_localization_mode()
    ids = list(range(10, FRAMES))
    js.run_sequence(seq[10:], frame_ids=ids)
    ts.run_sequence(seq[10:], frame_ids=ids)
    assert any(st.get("keyframe") for st in ts.stats)
    assert_runs_agree(js, ts)
    np.testing.assert_allclose(ts.db.bows, js.db.bows, atol=1e-6)


def test_chain_carry_after_insert(rng):
    C, N, K, P = 4, 512, 6, 32
    T = np.stack([np.eye(4, dtype=np.float32)] * C)
    T[:, :3, 3] = rng.normal(size=(C, 3))
    kf_pose = np.stack([np.eye(4, dtype=np.float32)] * K)
    kf_pose[:, :3, 3] = rng.normal(size=(K, 3))
    kf_obs = rng.integers(-1, P, (K, N)).astype(np.int32)
    kp_pts = rng.integers(-1, P, (C, N)).astype(np.int32)
    levels = rng.integers(0, 8, (C, N)).astype(np.int32)
    vis = rng.integers(0, 9, P).astype(np.int32)
    jm = jms.empty_map(mapping_cfg(jcfg, K))._replace(
        kf_pose=jnp.asarray(kf_pose), kf_obs_pt=jnp.asarray(kf_obs),
        pt_visible=jnp.asarray(vis), pt_found=jnp.asarray(vis // 2))
    tm = jm._asdict()
    tm = ttr.MapState(**{k: torch.from_numpy(
        np.array(v).view(np.int32) if np.asarray(v).dtype == np.uint32
        else np.array(v)) for k, v in tm.items()})
    carry = dict(T=np.eye(4, dtype=np.float32),
                 vel=np.eye(4, dtype=np.float32), has_vel=False,
                 kp_pt=kp_pts[0], level=levels[0], frames_since_kf=2,
                 ref_kf=1, pt_visible=vis, pt_found=vis)
    jc = jtr.ChunkCarry(**{k: jnp.asarray(v) for k, v in carry.items()})
    tc = ttr.ChunkCarry(**{k: torch.as_tensor(np.asarray(v))
                           for k, v in carry.items()})
    for j1, last in ((1, 1), (1, 3), (0, 2)):
        jr = jtr.chain_carry_after_insert(
            jc, jm, jnp.asarray(T), jnp.asarray(kp_pts), jnp.asarray(levels),
            jnp.int32(j1), jnp.int32(last), jnp.int32(4),
            jnp.int32(last - j1))
        tr = ttr.chain_carry_after_insert(
            tc, tm, torch.from_numpy(T), torch.from_numpy(kp_pts),
            torch.from_numpy(levels), j1, last, 4, last - j1)
        for name in jr._fields:
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)),
                                       atol=1e-5, err_msg=name)


def test_trajectory_writers_match_reference(rng, tmp_path):
    """System.save_*trajectory* write through utils/io: the same TUM and
    KITTI files as the reference for the same poses (quaternions from
    rot_to_quat within 1e-6)."""
    R = tgeo.exp_so3(torch.from_numpy(
        rng.normal(0, 1.5, (40, 3)).astype(np.float32))).numpy()
    np.testing.assert_allclose(
        tgeo.rot_to_quat(torch.from_numpy(R)).numpy(),
        np.asarray(jgeo.rot_to_quat(jnp.asarray(R))), atol=1e-6)
    poses = np.tile(np.eye(4, dtype=np.float32), (40, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = rng.normal(size=(40, 3))
    ts = np.arange(40) * 0.033
    for name, jfn, tfn, args in (
            ("tum", jio.save_trajectory_tum, tio.save_trajectory_tum,
             (ts, poses)),
            ("kitti", jio.save_trajectory_kitti, tio.save_trajectory_kitti,
             (poses,))):
        jp, tp = str(tmp_path / f"j.{name}"), str(tmp_path / f"t.{name}")
        jfn(jp, *args)
        tfn(tp, *args)
        np.testing.assert_allclose(np.loadtxt(tp), np.loadtxt(jp),
                                   atol=2e-7)
