"""models/local_mapping (+ map_state's covisibility functions and
loop_closing.fuse_landmarks): each backend stage of the port against its
coslam_tpu counterpart on the same map.

The map is built in-process by the JAX System from the first 20 frames of
make_scene(600, seed=3) / make_trajectory(36, seed=3) at 640x480, 500
features / 512 keypoints, K=32, P=4096, keyframe throttle 3, loop closing
off; every stage then runs on it in both packages.

Bars: integer outputs exact (observation tables, valid flags, covisibility,
slot counters, descriptors); point positions / normals / scale ranges
within 1e-4, absolute and relative (the triangulation and geometry
stages); local BA poses within
1e-4, points within 1e-3, observation rows differing in at most 0.5% of the
slots; the whole backend insert: poses within 1e-3, observation rows in at
most 0.5%, BoW row within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import local_mapping as jlm
from coslam_tpu.models import loop_closing as jlc
from coslam_tpu.models import map_state as jms
from coslam_tpu.models import tracking as jtr
from coslam_tpu.models.frame import build_frame as jbuild
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import local_mapping as tlm
from coslam_tpu_torch.models import loop_closing as tlc
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.models.frame import Frame as TFrame
from coslam_tpu_torch.ops import bow as tbow

# The test run splits the cores among its xdist workers; torch's own
# intra-op pool on top of that spins against the other workers' threads.
torch.set_num_threads(1)

FLOATS = ("kf_pose", "kf_uv", "kf_angle", "pt_pos", "pt_normal",
          "pt_max_dist")


def _cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        tracker=mod.TrackerConfig(mapper_latency_frames=3),
        mapper=mod.MapperConfig(max_keyframes=32, max_points=4096))


JC, TC = _cfg(jcfg), _cfg(tcfg)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def to_torch(jmap):
    return tms.MapState(**{k: _t(v) for k, v in jmap._asdict().items()})


def assert_maps(tm, jm, atol=1e-4, obs_frac=0.0, skip=()):
    for k, tv in tm._asdict().items():
        if k in skip:
            continue
        jv = np.asarray(getattr(jm, k))
        if jv.dtype == np.uint32:
            jv = jv.view(np.int32)
        tv = tv.numpy()
        if k in FLOATS:
            np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=atol,
                                       err_msg=k)
        elif k == "kf_obs_pt" and obs_frac:
            assert (tv != jv).mean() <= obs_frac, (k, (tv != jv).mean())
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=k)


@pytest.fixture(scope="module")
def world():
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(36, seed=3)
    seq = synthetic.render_sequence(JC.camera, traj, scene)
    s = JSystem(JC, enable_loop_closing=False)
    s.run_sequence(seq[:20])
    assert s.state == "OK" and int(s.map.n_kf) >= 5
    return s, seq


def test_covisibility_and_observations(world):
    s, _ = world
    jm, tm = s.map, to_torch(s.map)
    np.testing.assert_array_equal(tms.covisibility(tm).numpy(),
                                  np.asarray(jms.covisibility(jm)))
    k = int(jm.n_kf) - 1
    np.testing.assert_array_equal(tms.covisibility_row(tm, k).numpy(),
                                  np.asarray(jms.covisibility_row(jm, k)))
    np.testing.assert_array_equal(
        tms.covisibility_row(tm, torch.tensor(k, dtype=torch.int32)).numpy(),
        np.asarray(jms.covisibility_row(jm, k)))
    ks = np.array([0, 2, k], np.int32)
    np.testing.assert_array_equal(
        tms.covisibility_rows(tm, torch.from_numpy(ks)).numpy(),
        np.asarray(jms.covisibility_rows(jm, jnp.asarray(ks))))
    for a, b in zip(tms.observation_coo(tm), jms.observation_coo(jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tms.kf_centers(tm).numpy(),
                               np.asarray(jms.kf_centers(jm)), atol=1e-6)


def test_nanmedian_is_the_reference_definition(rng):
    """jnp.nanmedian averages the two middle values on an even count;
    torch.nanmedian would return the lower one."""
    for n in (8, 9, 1):
        x = rng.normal(size=(3, n)).astype(np.float32)
        x[0, : n // 2] = np.nan
        x[2, :] = np.nan
        got = tlm.nanmedian(torch.from_numpy(x)).numpy()
        want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
        np.testing.assert_array_equal(got, want)
    even = torch.tensor([4.0, 1.0, float("nan"), 3.0, 2.0])
    assert float(tlm.nanmedian(even)) == 2.5
    assert float(torch.nanmedian(even)) == 2.0


def test_scatter_collisions_keep_the_last_source(rng):
    """A planted collision: XLA's scatter keeps the last source."""
    base = np.full(6, -1, np.int32)
    idx = np.array([2, 4, 2, 6, 4, 2], np.int32)    # 6 = the drop slot
    vals = np.arange(10, 16, dtype=np.int32)
    want = np.asarray(jnp.asarray(np.append(base, -1)).at[idx].set(vals))[:6]
    got = tms.scatter_set(torch.from_numpy(base), torch.from_numpy(idx),
                          torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 15 and got[4] == 14
    # fuse_landmarks with two pairs naming one pt_from
    jc = jcfg.SystemConfig(mapper=jcfg.MapperConfig(max_keyframes=4,
                                                    max_points=16),
                           extractor=jcfg.ExtractorConfig(max_keypoints=8))
    tc = tcfg.SystemConfig(mapper=tcfg.MapperConfig(max_keyframes=4,
                                                    max_points=16),
                           extractor=tcfg.ExtractorConfig(max_keypoints=8))
    jm = jms.empty_map(jc)
    obs = rng.integers(-1, 16, (4, 8)).astype(np.int32)
    jm = jm._replace(kf_obs_pt=jnp.asarray(obs),
                     pt_valid=jnp.ones(16, bool))
    pf = np.array([3, 5, 3, 7], np.int32)
    pt = np.array([9, 1, 11, 2], np.int32)
    ok = np.array([True, True, True, False])
    jr = jlc.fuse_landmarks(jc, jm, jnp.asarray(pf), jnp.asarray(pt),
                            jnp.asarray(ok))
    tr = tlc.fuse_landmarks(tc, to_torch(jm), torch.from_numpy(pf),
                            torch.from_numpy(pt), torch.from_numpy(ok))
    np.testing.assert_array_equal(tr.kf_obs_pt.numpy(),
                                  np.asarray(jr.kf_obs_pt))
    np.testing.assert_array_equal(tr.pt_valid.numpy(),
                                  np.asarray(jr.pt_valid))


@pytest.mark.parametrize("stage", ["create_map_points", "fuse_into_neighbors",
                                   "fuse_map_into_keyframe",
                                   "cull_keyframes", "cull_points",
                                   "refresh_point_geometry"])
def test_backend_stage_matches_reference(world, stage):
    s, _ = world
    jm = s.map
    k = int(jm.n_kf) - 1
    kt = torch.tensor(k, dtype=torch.int32)
    if stage == "cull_points":
        jr = jlm.cull_points(JC, jm)
        tr = tlm.cull_points(TC, to_torch(jm))
    elif stage == "refresh_point_geometry":
        jr = jlm.refresh_point_geometry(JC, jm)
        tr = tlm.refresh_point_geometry(TC, to_torch(jm))
    elif stage == "fuse_map_into_keyframe":
        jr = jlm.fuse_map_into_keyframe(JC, jm, jnp.int32(k))
        tr = tlm.fuse_map_into_keyframe(TC, to_torch(jm), kt)
    else:
        jr = getattr(jlm, stage)(JC, jm, jnp.int32(k))
        tr = getattr(tlm, stage)(TC, to_torch(jm), kt)
    assert_maps(tr, jr)
    if stage == "create_map_points":
        assert int(jr.n_pt) > int(jm.n_pt)      # it triangulated


def test_medoid_descriptors(world):
    s, _ = world
    jm = s.map
    tm = to_torch(jm)
    _, jpt, _, _, jok = jms.observation_coo(jm)
    _, tpt, _, _, tok = tms.observation_coo(tm)
    jd, jh = jlm._medoid_descriptors(jm, jpt, jok)
    td, th = tlm._medoid_descriptors(tm, tpt, tok)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(td.numpy(),
                                  np.asarray(jd).view(np.int32))
    assert int(th.sum()) > 50


def test_local_ba_matches_reference(world):
    s, _ = world
    jm = s.map
    k = int(jm.n_kf) - 1
    jr = jax.jit(jlm.local_ba_body, static_argnums=(0, 3))(
        JC, jm, jnp.int32(k), 4)
    tr = tlm.local_ba_body(TC, to_torch(jm), torch.tensor(k), 4)
    np.testing.assert_allclose(tr.kf_pose.numpy(), np.asarray(jr.kf_pose),
                               atol=1e-4)
    np.testing.assert_allclose(tr.pt_pos.numpy(), np.asarray(jr.pt_pos),
                               atol=1e-3)
    assert_maps(tr, jr, atol=1e-3, obs_frac=0.005)


def test_insert_and_backend_insert_match_reference(world):
    """A new keyframe from frame 20, tracked by the JAX tracker: the slot
    write alone, then the whole fused backend with its BoW row."""
    s, seq = world
    jm = s.map
    jf = jbuild(jnp.asarray(seq[20]), JC)
    T_pred = jnp.asarray(s.velocity @ s.last_T)
    _n1, res, jm = jtr.track_frame_built(
        JC, jm, jf, s.last_kp_pt, s.last_level, T_pred, jnp.float32(15.0),
        ref_kf=jnp.asarray(s.last_ref_kf, jnp.int32))
    assert int(res.n_inliers) > 30
    tf = TFrame(*[_t(a) for a in jf])
    T = _t(res.T)
    kp = _t(res.kp_pt)
    jr, jk = jlm.insert_keyframe(JC, jm, jf, res.T, jnp.int32(20), res.kp_pt)
    tr, tk = tlm.insert_keyframe(TC, to_torch(jm), tf, T, 20, kp)
    assert int(tk) == int(jk)
    assert_maps(tr, jr, atol=0)

    vocab = jnp.asarray(tbow.load_pretrained_vocabulary())
    jr, jk, jaux = jlm.backend_insert(JC, jm, jf, res.T, jnp.int32(20),
                                      res.kp_pt, False, None, vocab)
    tr, tk, taux = tlm.backend_insert(TC, to_torch(jm), tf, T, 20, kp,
                                      False, None, _t(vocab))
    assert int(tk) == int(jk)
    np.testing.assert_allclose(tr.kf_pose.numpy(), np.asarray(jr.kf_pose),
                               atol=1e-3)
    assert_maps(tr, jr, atol=1e-2, obs_frac=0.005,
                skip=("pt_desc", "pt_valid", "pt_ref_kf", "pt_max_dist",
                      "pt_normal", "pt_pos"))
    both = tr.pt_valid.numpy() & np.asarray(jr.pt_valid)
    assert (tr.pt_valid.numpy() != np.asarray(jr.pt_valid)).mean() <= 0.005
    np.testing.assert_allclose(tr.pt_pos.numpy()[both],
                               np.asarray(jr.pt_pos)[both], atol=1e-2)
    np.testing.assert_allclose(taux["bow_row"].numpy(),
                               np.asarray(jaux["bow_row"]), atol=1e-6)
    np.testing.assert_array_equal(taux["covis_row"].numpy(),
                                  np.asarray(jaux["covis_row"]))
    assert int(taux["n_pt"]) == int(jaux["n_pt"])
