"""The slice end to end: resume a map saved by coslam_tpu, activate
localization mode and track, in both packages, on the same frames.

The map is built in-process by the JAX System at the config of
tests/test_checkpoint_cli.py (640x480, 512 keypoints, K=32, P=4096) from
frames 0-11 of make_scene(600, seed=3) / make_trajectory(24, seed=3).

Bars, per frame: T within 1e-2; n_inliers within max(3, 5%); no frame lost
and no keyframe inserted.  `track_chunk` on one chunk: `ok` and `need_kf`
equal, and `kp_pt` equal on at least 95% of keypoints (pose-optimizer
inlier decisions near the chi2 gate may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import tracking as jtr
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.utils import checkpoint as jck
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import tracking as ttr
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.utils import checkpoint as tck

# The test run splits the cores among its xdist workers; torch's own
# intra-op pool on top of that spins against the other workers' threads.
torch.set_num_threads(1)


def _cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        mapper=mod.MapperConfig(max_keyframes=32, max_points=4096))


@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(24, seed=3)
    seq = synthetic.render_sequence(_cfg(jcfg).camera, traj, scene)
    s = JSystem(_cfg(jcfg))
    for i in range(12):
        s.track_mono(seq[i], i)
    assert s.state == "OK"
    path = str(tmp_path_factory.mktemp("map") / "map.npz")
    jck.save_system(path, s)
    return path, seq


def _systems(path):
    js = JSystem(_cfg(jcfg))
    jck.load_system(path, js)
    js.activate_localization_mode()
    ts = TSystem(_cfg(tcfg), device="cpu")
    tck.load_system(path, ts)
    ts.activate_localization_mode()
    return js, ts


def _check_frames(js, ts, n_kf):
    jid, jT = js.trajectory_poses()
    tid, tT = ts.trajectory_poses()
    assert tid == jid
    np.testing.assert_allclose(tT, jT, atol=1e-2)
    ji = np.array([s["inliers"] for s in js.stats])
    ti = np.array([s["inliers"] for s in ts.stats])
    assert (np.abs(ti - ji) <= np.maximum(3, 0.05 * ji)).all(), (ti, ji)
    for s in (js, ts):
        assert not any(st.get("lost") for st in s.stats)
        assert not any(st.get("keyframe") for st in s.stats)
    assert int(ts.map.kf_valid.sum()) == n_kf


def test_localization_run_sequence_matches_reference(saved_map):
    """Frames 12-15: one chunk of C=8 padded with copies of frame 15."""
    path, seq = saved_map
    js, ts = _systems(path)
    n_kf = int(ts.map.kf_valid.sum())
    ids = list(range(12, 16))
    js.run_sequence(seq[12:16], frame_ids=ids)
    ts.run_sequence(seq[12:16], frame_ids=ids)
    assert ts.n_frames_chunked == js.n_frames_chunked == 4
    _check_frames(js, ts, n_kf)
    assert ts.state == "OK"
    np.testing.assert_allclose(ts.last_T, js.last_T, atol=1e-2)


def test_localization_track_mono_matches_reference(saved_map):
    """The per-frame path (track_frame_built), frames 12-13."""
    path, seq = saved_map
    js, ts = _systems(path)
    n_kf = int(ts.map.kf_valid.sum())
    for i in (12, 13):
        np.testing.assert_allclose(ts.track_mono(seq[i], i),
                                   js.track_mono(seq[i], i), atol=1e-2)
    _check_frames(js, ts, n_kf)


def test_track_chunk_matches_reference(saved_map):
    path, seq = saved_map
    js, ts = _systems(path)
    imgs = seq[12:20]
    jcarry = jtr.ChunkCarry(
        T=jnp.asarray(js.last_T), vel=jnp.asarray(js.velocity),
        has_vel=jnp.asarray(True), kp_pt=jnp.asarray(js.last_kp_pt),
        level=jnp.asarray(js.last_level),
        frames_since_kf=jnp.asarray(js.frames_since_kf, jnp.int32),
        ref_kf=jnp.asarray(-1, jnp.int32), pt_visible=js.map.pt_visible,
        pt_found=js.map.pt_found)
    tcarry = ts._carry_from_host()
    jout = jtr.track_chunk(_cfg(jcfg), js.map, jnp.asarray(imgs), True, jcarry)
    tout = ttr.track_chunk(_cfg(tcfg), ts.map, torch.from_numpy(imgs), True,
                           tcarry)
    jst, tst = jout[1], tout[1]
    np.testing.assert_array_equal(tst.ok.numpy(), np.asarray(jst.ok))
    np.testing.assert_array_equal(tst.need_kf.numpy(), np.asarray(jst.need_kf))
    assert np.asarray(jst.ok).all()
    np.testing.assert_allclose(tst.T.numpy(), np.asarray(jst.T), atol=1e-2)
    jkp, tkp = np.asarray(jout[3]), tout[3].numpy()
    assert (jkp >= 0).sum() > 100
    assert (tkp == jkp).mean() >= 0.95


@pytest.mark.parametrize("case", ["tracked", "fallback", "no_reference"])
def test_chunk_body_matches_per_frame_branch(saved_map, case):
    """The chunk's branchless composition (`_chunk_track_body`, a
    torch.where over an always-computed reference-keyframe candidate)
    equals the per-frame path's `_track_body`, whose fallback is a Python
    `if` on a synced scalar, bit for bit: on a frame the motion model
    tracks (no fallback), on one it loses with a reference keyframe (the
    fallback taken) and on one it loses with none (no fallback)."""
    path, seq = saved_map
    ts = TSystem(_cfg(tcfg), device="cpu")
    tck.load_system(path, ts)
    cfg, m = _cfg(tcfg), ts.map
    frame = ttr.build_frame(torch.from_numpy(seq[12]), cfg)
    c = ts._carry_from_host()
    kp_pt = c.kp_pt if case == "tracked" else torch.full_like(c.kp_pt, -1)
    ref_kf = torch.tensor(-1 if case == "no_reference" else int(m.n_kf) - 1,
                          dtype=torch.int32)
    T_pred = torch.where(c.has_vel, c.vel @ c.T, c.T)
    radius = torch.where(c.has_vel, torch.tensor(15.0), torch.tensor(30.0))
    args = (cfg, m, frame, kp_pt, c.level, T_pred, radius)
    n1, res, m2 = ttr._track_body(*args, ref_kf=ref_kf)
    cn1, cres, cm2 = ttr._chunk_track_body(*args, ref_kf)
    assert n1.dtype == cn1.dtype and torch.equal(n1, cn1)
    for a, b in zip(res + tuple(m2), cres + tuple(cm2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    motion = ttr._motion_model(*args)
    assert (int(motion.n_inliers) >= 10) == (case == "tracked")
    assert (not torch.equal(motion.n_inliers, n1)) == (case == "fallback")
    assert int(res.n_inliers) >= (10 if case != "no_reference" else 0)


def test_unported_paths_raise():
    """What is still unported raises, naming its ROADMAP item: of the
    library nothing now; the CLI's dataset modes exit naming item 17 (their
    loaders).  The distributed layer (16) is ported: the observation-sharded
    BA is `solve_body` with a mesh axis, beside the mesh, the collective
    packet exchange and the lockstep driver.  Loop closing and the
    cooperative layer do not raise: the System builds its LoopCloser, a
    CoopAgent merges.  A frame that tracks nothing does not raise either:
    the System goes LOST and dead-reckons.  Nor do the depth sensors: a mono
    System handed depth images runs the RGB-D path's driver."""
    from coslam_tpu_torch.parallel import (exchange, mesh, multichip,
                                           sharded_ba)
    for fn in (mesh.make_mesh, mesh.launch, exchange.exchange,
               sharded_ba.solve_sharded, sharded_ba.solve_partitioned,
               multichip.lockstep_rank):
        assert callable(fn)
    ts = TSystem(_cfg(tcfg), device="cpu", enable_loop_closing=True)
    assert ts.loop_closer is not None and ts.loop_closer.db is ts.db
    assert TSystem(_cfg(tcfg), device="cpu",
                   enable_loop_closing=False).loop_closer is None
    img = np.zeros((480, 640), np.uint8)
    ts.state = "OK"
    ts.last_kp_pt = torch.full((512,), -1, dtype=torch.int32)
    ts.last_level = torch.zeros(512, dtype=torch.int32)
    T = ts.track_mono(img, 0)          # a blank frame tracks 0 inliers
    assert ts.state == "LOST" and ts.stats[-1]["lost"]
    np.testing.assert_array_equal(T, np.eye(4, dtype=np.float32))
    assert ts.velocity is None and int(ts.last_kp_pt.max()) == -1
    assert ts.shutdown()["relocalizations"] == 0
    ts.run_sequence([img], depths=[np.zeros((480, 640), np.float32)])
    assert ts.state == "LOST" and ts.stats[-1]["lost"]
