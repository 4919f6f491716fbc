"""Port loop closing against coslam_tpu on one small JAX-built map with a
revisit: the 1.25-lap cylinder sequence of tests/test_loop_closing.py at
640x480 with 500 features, K=64, P=8192 (that test's 320x240 / 400-feature
configuration loses track on this sequence once the keyframe cadence is
pinned, in either package; this one does not).

The JAX System runs the sequence once per module with loop closing on,
through the recording LoopCloser of scripts/make_torch_smoke_assets.py: it
keeps the map handed to the `on_keyframe` call that closed the loop, the
inputs of the three calls before it, and the Sim3 draws.  The run is split
at frame 80, before the revisit, where its checkpoint is taken.  Every
function of the port is then held against the JAX function on the closing
call's map, carried across by the checkpoint file, and the port's System
resumes the frame-80 checkpoint; tolerances are stated per test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import keyframe_db as jkdb
from coslam_tpu.models import loop_closing as jlc
from coslam_tpu.utils import checkpoint as jckpt
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import keyframe_db as tkdb
from coslam_tpu_torch.models import loop_closing as tlc
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.utils import checkpoint as tckpt
from coslam_tpu_torch.utils import evaluation

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

FRAMES = 115
SPLIT = 80            # the revisit begins at frame 92


def _cfg(mod, **loop_kw):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        mapper=mod.MapperConfig(max_keyframes=64, max_points=8192),
        loop=mod.LoopConfig(**loop_kw),
        tracker=mod.TrackerConfig(mapper_latency_frames=3))


JC, TC = _cfg(jcfg), _cfg(tcfg)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX run, its closing call, and that call's map on both sides."""
    scene = synthetic.make_cylinder_scene(700, seed=5)
    traj = synthetic.make_loop_trajectory(FRAMES, seed=5, frac=1.25)
    seq = synthetic.render_sequence(JC.camera, traj, scene)
    js = assets.DrawRecordingSystem(JC, enable_loop_closing=True)
    js.loop_closer = assets.RecordingLoopCloser(JC, js.db)
    js.run_sequence(seq[:SPLIT])
    assert js.state == "OK" and js.n_loops_closed == 0
    tmp = tmp_path_factory.mktemp("loop")
    resume = str(tmp / "resume.npz")
    jckpt.save_system(resume, js)
    at_split = dict(trajectory=list(js.trajectory),
                    last_ref_kf=js.last_ref_kf,
                    n_frames_tracked=js.n_frames_tracked)
    js.run_sequence(seq[SPLIT:], frame_ids=list(range(SPLIT, FRAMES)))
    js.shutdown()
    c = js.loop_closer.closing
    assert js.n_loops_closed >= 1 and c is not None
    assert not any(st.get("lost") for st in js.stats)
    path = str(tmp / "map.npz")
    jckpt.save_map(path, c["map"])
    tm, _ = tckpt.load_map(path, device="cpu")
    return dict(js=js, seq=seq, traj=traj, c=c, jm=c["map"], tm=tm,
                recent=list(js.loop_closer.recent), path=path,
                vocab=np.asarray(js.db.vocab), resume=resume,
                at_split=at_split)


def _tdb(ref, rec):
    """A port database in the state the JAX one had before `rec`'s call."""
    db = tkdb.KeyFrameDatabase(TC, vocab=ref["vocab"], device="cpu")
    db.bows, db.has = rec["db_bows"].copy(), rec["db_has"].copy()
    db._consistent_groups = (rec["cg_groups"], rec["cg_counts"]) \
        if rec["cg_groups"].shape[0] else []
    return db


def _tmap(ref, jm, name):
    path = os.path.join(os.path.dirname(ref["path"]), name)
    jckpt.save_map(path, jm)
    return tckpt.load_map(path, device="cpu")[0]


def _pairs(ref):
    c = ref["c"]
    k1, k2 = int(c["kf_id"]), int(c["candidate"])
    return k1, k2, jlc.match_pair_points(JC, ref["jm"], k1, k2), \
        tlc.match_pair_points(TC, ref["tm"], k1, k2)


def test_detect_loop_candidates_over_consecutive_keyframes(ref):
    """The database's detector over the last consecutive keyframes up to the
    closing one, starting from the JAX database's consistency groups: the
    same candidate lists, the same groups carried forward."""
    recs = [r for r in ref["recent"] if "bow_cands" in r]
    assert len(recs) >= 3
    db = _tdb(ref, recs[0])
    for i, rec in enumerate(recs):
        db.bows, db.has = rec["db_bows"].copy(), rec["db_has"].copy()
        db._version += 1
        tm = ref["tm"] if rec is ref["c"] or i == len(recs) - 1 \
            else _tmap(ref, rec["map"], f"m{i}.npz")
        if i:
            np.testing.assert_array_equal(db._consistent_groups[0],
                                          rec["cg_groups"])
            np.testing.assert_array_equal(db._consistent_groups[1],
                                          rec["cg_counts"])
        got = db.detect_loop_candidates(tm, rec["kf_id"], rec["covis_row"])
        assert got == rec["bow_cands"], (i, got, rec["bow_cands"])
    assert ref["c"]["candidate"] in got
    # scores_against_all is the JAX database's on the same rows
    jdb = jkdb.KeyFrameDatabase(JC, vocab=ref["vocab"])
    jdb.bows, jdb.has = rec["db_bows"].copy(), rec["db_has"].copy()
    np.testing.assert_allclose(db.scores_against_all(rec["kf_id"]),
                               jdb.scores_against_all(rec["kf_id"]),
                               atol=1e-7)
    db.remap(np.arange(len(db.has)), len(db.has))
    assert db._consistent_groups == []


def test_match_counts(ref):
    """match_counts_subset and match_counts_all: equal integers."""
    k1 = int(ref["c"]["kf_id"])
    cands = np.asarray(sorted({int(ref["c"]["candidate"]), 0, 2, 5, k1 - 1}),
                       np.int32)
    j = np.asarray(jlc.match_counts_subset(JC, ref["jm"], jnp.asarray(k1),
                                           jnp.asarray(cands)))
    t = tlc.match_counts_subset(TC, ref["tm"], k1, torch.tensor(cands))
    np.testing.assert_array_equal(t.numpy(), j)
    assert j.max() >= JC.loop.sim3_min_bow_matches
    ja = np.asarray(jlc.match_counts_all(JC, ref["jm"], k1))
    ta = tlc.match_counts_all(TC, ref["tm"], k1).numpy()
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta[cands], j)


def test_match_pair_points(ref):
    """Equal index arrays (where valid) and equal validity."""
    _, _, jp, tp = _pairs(ref)
    ok = np.asarray(jp[3])
    assert ok.sum() >= 8
    np.testing.assert_array_equal(tp[3].numpy(), ok)
    for j, t in zip(jp[:3], tp[:3]):
        np.testing.assert_array_equal(t.numpy()[ok], np.asarray(j)[ok])


def test_sim3_between_expand_and_refine(ref):
    """The verification chain on the closing pair with the JAX draws
    injected: RANSAC (inliers within 2 pairs, s / R / t within 1e-3), the
    expansion under the JAX similarity (equal arrays), the polish (inliers
    within 1 pair, s / R / t within 1e-3)."""
    c = ref["c"]
    k1, k2, jp, tp = _pairs(ref)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(42), k1),
                             k2)
    jres = jlc.sim3_between(JC, ref["jm"], k1, k2, *jp, key)
    draws = torch.tensor(c["draws"][(k1, k2)].astype(np.int64))
    tres = tlc.sim3_between(TC, ref["tm"], k1, k2, *tp, samples=draws)
    assert (tres.inliers.numpy() != np.asarray(jres.inliers)).sum() <= 2
    assert abs(float(tres.s) - float(jres.s)) < 1e-3
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-3)

    je = jlc.expand_sim3_matches(JC, ref["jm"], jnp.asarray(k1),
                                 jnp.asarray(k2), jres.s, jres.R, jres.t)
    te = tlc.expand_sim3_matches(
        TC, ref["tm"], k1, k2, torch.tensor(np.asarray(jres.s)),
        torch.tensor(np.asarray(jres.R)), torch.tensor(np.asarray(jres.t)))
    ok = np.asarray(je[3])
    assert ok.sum() > int(jres.n_inliers)          # the expansion grew it
    np.testing.assert_array_equal(te[3].numpy(), ok)
    np.testing.assert_array_equal(te[1].numpy(), np.asarray(je[1]))
    for j, t in ((je[0], te[0]), (je[2], te[2])):
        np.testing.assert_array_equal(t.numpy()[ok], np.asarray(j)[ok])

    jr = jlc.sim3_refine_pairs(JC, ref["jm"], jnp.asarray(k1),
                               jnp.asarray(k2), *je, jres.s, jres.R, jres.t)
    tr = tlc.sim3_refine_pairs(
        TC, ref["tm"], k1, k2, *te, torch.tensor(np.asarray(jres.s)),
        torch.tensor(np.asarray(jres.R)), torch.tensor(np.asarray(jres.t)))
    assert abs(int(tr.n_inliers) - int(jr.n_inliers)) <= 1
    assert int(jr.n_inliers) == c["n_inliers"]
    assert abs(float(tr.s) - float(jr.s)) < 1e-3
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)


def _correct_both(ref, sparse: bool):
    c = ref["c"]
    jc = _cfg(jcfg, sparse_essential_graph=sparse)
    tc = _cfg(tcfg, sparse_essential_graph=sparse)
    k1, k2 = int(c["kf_id"]), int(c["candidate"])
    # the accepted pair set, recomputed on the JAX side
    jp = jlc.match_pair_points(JC, ref["jm"], k1, k2)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(42), k1),
                             k2)
    res = jlc.sim3_between(JC, ref["jm"], k1, k2, *jp, key)
    je = jlc.expand_sim3_matches(JC, ref["jm"], jnp.asarray(k1),
                                 jnp.asarray(k2), res.s, res.R, res.t)
    jr = jlc.sim3_refine_pairs(JC, ref["jm"], jnp.asarray(k1),
                               jnp.asarray(k2), *je, res.s, res.R, res.t)
    pair_ok = je[3] & jr.inliers
    L = JC.loop.max_loop_edges
    prev = np.zeros((L, 2), np.int32)
    prev_valid = np.zeros(L, bool)
    prev[0], prev_valid[0] = (k1 - 4, 3), True     # an earlier loop edge
    jout = jlc.correct_loop(jc, ref["jm"], jnp.asarray(k1), jnp.asarray(k2),
                            jr.s, jr.R, jr.t, je[1], je[2], pair_ok,
                            prev_loops=jnp.asarray(prev),
                            prev_loops_valid=jnp.asarray(prev_valid))
    tout = tlc.correct_loop(
        tc, ref["tm"], k1, k2, torch.tensor(np.asarray(jr.s)),
        torch.tensor(np.asarray(jr.R)), torch.tensor(np.asarray(jr.t)),
        torch.tensor(np.asarray(je[1])), torch.tensor(np.asarray(je[2])),
        torch.tensor(np.asarray(pair_ok)), prev_loops=torch.tensor(prev),
        prev_loops_valid=torch.tensor(prev_valid))
    return jout, tout


@pytest.mark.parametrize("sparse", [True, False])
def test_correct_loop(ref, sparse):
    """Both edge-set modes (sparse list with the PCG solver, dense upper
    triangle with the direct solver), with one earlier loop edge: keyframe
    poses within 1e-3, valid points within 1e-3 relative to the map's
    extent, `kf_obs_pt` and `pt_valid` equal."""
    jout, tout = _correct_both(ref, sparse)
    kfv = np.asarray(ref["jm"].kf_valid)
    moved = np.abs(np.asarray(jout.kf_pose) - np.asarray(ref["jm"].kf_pose))
    assert moved[kfv].max() > 1e-2                 # the correction did work
    np.testing.assert_allclose(tout.kf_pose.numpy()[kfv],
                               np.asarray(jout.kf_pose)[kfv], atol=1e-3)
    np.testing.assert_array_equal(tout.kf_obs_pt.numpy(),
                                  np.asarray(jout.kf_obs_pt))
    ptv = np.asarray(jout.pt_valid)
    np.testing.assert_array_equal(tout.pt_valid.numpy(), ptv)
    assert ptv.sum() < np.asarray(ref["jm"].pt_valid).sum()   # fused pairs
    jp = np.asarray(jout.pt_pos)[ptv]
    extent = np.linalg.norm(jp - jp.mean(0), axis=1).max()
    err = np.linalg.norm(tout.pt_pos.numpy()[ptv] - jp, axis=1)
    assert err.max() <= 1e-3 * extent, (err.max(), extent)


def test_global_ba(ref):
    """global_ba on the corrected map: the summed keyframe-centre spread is
    restored to 1e-4 relative (the monocular gauge), poses within 1e-3,
    the same observations dropped as outliers to within 0.5 %."""
    jm = ref["c"]["corrected"]
    tm = _tmap(ref, jm, "corrected.npz")
    jout = jlc.global_ba(JC, jm)
    tout = tlc.global_ba(TC, tm)
    kfv = np.asarray(jm.kf_valid)
    np.testing.assert_allclose(tout.kf_pose.numpy()[kfv],
                               np.asarray(jout.kf_pose)[kfv], atol=1e-3)

    def spread(m):
        c = tms.kf_centers(m)
        return float((m.kf_valid.float()
                      * torch.linalg.vector_norm(c - c[0], dim=1)).sum())

    assert abs(spread(tout) / spread(tm) - 1.0) < 1e-4
    ptv = np.asarray(jm.pt_valid)
    np.testing.assert_allclose(tout.pt_pos.numpy()[ptv],
                               np.asarray(jout.pt_pos)[ptv], atol=5e-3)
    diff = (tout.kf_obs_pt.numpy() != np.asarray(jout.kf_obs_pt)).sum()
    n_obs = (np.asarray(jm.kf_obs_pt) >= 0).sum()
    assert diff <= 0.005 * n_obs, (diff, n_obs)
    assert (tout.kf_obs_pt.numpy() != tm.kf_obs_pt.numpy()).any()


def test_loop_closer_on_keyframe(ref):
    """`LoopCloser.on_keyframe` end to end on the closing call's inputs with
    the JAX draws injected: the same accepted candidate and `loop_edges`, the
    corrected map within the bars of test_correct_loop, a pending global BA;
    then `remap` after a compaction renumbers the edge and the cooldown."""
    c = ref["c"]
    db = _tdb(ref, c)
    closer = tlc.LoopCloser(TC, db)
    closer.last_loop_kf = int(c["last_loop_kf"])
    closer.sim3_draws.update(c["draws"])
    k1 = int(c["kf_id"])
    m2, closed = closer.on_keyframe(ref["tm"], k1, covis_row=c["covis_row"])
    assert closed
    assert closer.loop_edges == [(k1, int(c["candidate"]))]
    assert closer.last_loop_kf == k1 and closer.pending_gba == k1
    assert abs(closer.last_closure["n_inliers"] - c["n_inliers"]) <= 1
    assert abs(float(closer.last_closure["s"]) - float(c["s"])) < 1e-3
    assert 5 <= closer.n_host_syncs <= 4 + 3 * 3
    jout = c["corrected"]
    kfv = np.asarray(jout.kf_valid)
    np.testing.assert_allclose(m2.kf_pose.numpy()[kfv],
                               np.asarray(jout.kf_pose)[kfv], atol=2e-3)
    assert abs(int(m2.pt_valid.sum()) - int(np.asarray(jout.pt_valid).sum())) \
        <= 1
    # inside the cooldown the next keyframe is not examined
    assert closer.on_keyframe(m2, k1 + 1, covis_row=c["covis_row"])[1] is False
    # the deferred global BA runs once
    m3 = closer.maybe_run_gba(m2)
    assert m3 is not m2 and closer.pending_gba is None
    assert closer.maybe_run_gba(m3) is m3
    # compaction culled slot 2: later slots move down by one
    K = kfv.shape[0]
    kf_map = np.arange(K) - (np.arange(K) > 2)
    kf_map[2] = -1
    closer.remap(kf_map, lambda i: int(kf_map[i]))
    assert closer.loop_edges == [(k1 - 1, int(kf_map[c["candidate"]]))]
    assert closer.last_loop_kf == k1 - 1
    closer.loop_edges = [(2, 0)]
    closer.remap(kf_map, lambda i: int(kf_map[i]))
    assert closer.loop_edges == []                 # a culled endpoint


def test_system_closes_the_loop(ref):
    """The port's System resumes the JAX run's checkpoint of frame 80 (map,
    tracking state, database; the trajectory log handed over beside it) and
    runs the revisit with loop closing on: no lost frame, the loop closed on
    the same frame by the same keyframe against the same candidate as the
    JAX run, the expanded inliers within max(3, 5 %), ATE over the whole
    trajectory within 0.01 of the JAX run's, and the deferred global BA run
    by the next keyframe or by shutdown."""
    js, traj = ref["js"], ref["traj"]
    jid, jT = js.trajectory_poses()
    ate_j = evaluation.ate_rmse(
        evaluation.trajectory_xyz(jT),
        evaluation.trajectory_xyz(traj.poses_cw[np.asarray(jid)]))
    ts = TSystem(TC, device="cpu", enable_loop_closing=True)
    tckpt.load_system(ref["resume"], ts)
    ts.trajectory = [(f, r, np.asarray(T)) for f, r, T
                     in ref["at_split"]["trajectory"]]
    ts.last_ref_kf = ref["at_split"]["last_ref_kf"]
    ts.n_frames_tracked = ref["at_split"]["n_frames_tracked"]
    ts.run_sequence(ref["seq"][SPLIT:], frame_ids=list(range(SPLIT, FRAMES)))
    out = ts.shutdown()
    assert ts.state == "OK"
    assert not any(st.get("lost") for st in ts.stats)
    assert ts.n_loops_closed == js.n_loops_closed == out["loops_closed"]
    assert ts.loop_closer.pending_gba is None      # the global BA has run
    assert ts.loop_closer.loop_edges == js.loop_closer.loop_edges
    j_frames = [st["frame"] for st in js.stats if st.get("loop_closed")]
    t_frames = [st["frame"] for st in ts.stats if st.get("loop_closed")]
    assert t_frames == j_frames
    n_j = ref["c"]["n_inliers"]
    assert abs(ts.loop_closer.last_closure["n_inliers"] - n_j) \
        <= max(3, 0.05 * n_j)
    tid, tT = ts.trajectory_poses()
    assert tid == list(jid)
    ate_t = evaluation.ate_rmse(
        evaluation.trajectory_xyz(tT),
        evaluation.trajectory_xyz(traj.poses_cw[np.asarray(tid)]))
    assert abs(ate_t - ate_j) <= 0.01, (ate_t, ate_j)
    assert all(t.device.type == "cpu" for t in ts.map)
    # reset rebuilds the closer against the new database
    ts.reset()
    assert ts.loop_closer.db is ts.db and ts.loop_closer.loop_edges == []
    assert ts.n_loops_closed == 0
    assert ts.loop_closer.sim3_draws is ts.sim3_draws
