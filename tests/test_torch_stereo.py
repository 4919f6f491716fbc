"""Stereo and RGB-D below the System (port of coslam_tpu/ops/stereo.py,
`camera.backproject`, `local_mapping.add_depth_points` and the depth
branches of `backend_insert` and `tracking.track_chunk`) against
coslam_tpu on the same inputs; the workload is tests/torch_depth_common.py's.

Bars: integer and exact paths bit-equal (descriptor matches, depth lookup,
slot allocation); `_sad_subpixel` u_right within 1e-3 where both pick the
same shift, at most 1% of keypoints picking another (an argmin over float
SADs summed in another order); the chunk: keyframe flags equal, poses
within 1e-3, inliers within max(3, 5%), per-keypoint depth equal (RGB-D) or
within 1e-3 relative on 99% (stereo); its backend insert: observation
tables within 0.5%, poses within 1e-3 (RGB-D; stereo: see
test_local_ba_on_a_stereo_keyframe)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coslam_tpu import config as jcfg
from coslam_tpu.models import local_mapping as jlm
from coslam_tpu.models import map_state as jms
from coslam_tpu.models import tracking as jtr
from coslam_tpu.models.frame import build_frame as jbuild
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.ops import orb as jorb
from coslam_tpu.ops import stereo as jst
from coslam_tpu.utils import camera as jcam
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import local_mapping as tlm
from coslam_tpu_torch.models import tracking as ttr
from coslam_tpu_torch.models.frame import Frame as TFrame
from coslam_tpu_torch.ops import stereo as tst
from coslam_tpu_torch.utils import camera as tcam

from torch_depth_common import (BASELINE, FRAMES, _cfg, _t, _tkps, _tmap,
                                depth_world, world_aux)


@pytest.fixture(scope="module")
def world():
    return depth_world()


@pytest.fixture(scope="module")
def kps(world):
    """The reference's keypoints of frame 0, both views."""
    ecfg = _cfg(jcfg).extractor
    return (jorb.extract(jnp.asarray(world["left"][0]), ecfg),
            jorb.extract(jnp.asarray(world["right"][0]), ecfg))


def test_backproject(rng):
    cam = _cfg(jcfg).camera
    uv = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    d = rng.uniform(0.1, 20.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        tcam.backproject(_cfg(tcfg).camera, _t(uv), _t(d)).numpy(),
        np.asarray(jcam.backproject(cam, jnp.asarray(uv), jnp.asarray(d))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bf", [400 * BASELINE, 0.0])
def test_rgbd_depth(world, kps, bf):
    """Nearest-pixel lookup with holes (the renderer's background is 0) and
    keypoints pushed past the image edge; the virtual right coordinate only
    where bf > 0."""
    kl = kps[0]
    uv = np.asarray(kl["uv"]).copy()
    uv[:8] += np.float32(700.0)                      # clipped to the edge
    valid = np.asarray(kl["valid"])
    d = world["depth"][0]
    js = jst.rgbd_depth(_cfg(jcfg, bf=bf).camera, jnp.asarray(uv),
                        jnp.asarray(valid), jnp.asarray(d))
    ts = tst.rgbd_depth(_cfg(tcfg, bf=bf).camera, _t(uv), _t(valid), _t(d))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.depth.numpy(), np.asarray(js.depth))
    np.testing.assert_allclose(ts.u_right.numpy(), np.asarray(js.u_right),
                               rtol=1e-6)
    assert 0 < int(js.valid.sum()) < int(valid.sum())   # holes hit
    if bf == 0.0:
        assert (ts.u_right.numpy() == -1.0).all()


def test_match_stereo_without_images(kps):
    """Descriptor matching alone is exact: the same matches, u_right and
    depth."""
    kl, kr = kps
    c = _cfg(jcfg)
    js = jst.match_stereo(c.camera, c.extractor, c.matcher, kl, kr)
    t = _cfg(tcfg)
    ts = tst.match_stereo(t.camera, t.extractor, t.matcher, _tkps(kl),
                          _tkps(kr))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.u_right.numpy(), np.asarray(js.u_right))
    np.testing.assert_allclose(ts.depth.numpy(), np.asarray(js.depth),
                               rtol=1e-6)
    assert int(js.valid.sum()) > 150


def _flips(tu, ju, both):
    return both & (np.abs(tu - ju) > 1e-3)


def test_match_stereo_with_images(world, kps):
    """With the SAD refinement: the valid sets differ in at most 1% of the
    keypoints; u_right within 1e-3 and depth within 1e-3 relative wherever
    both are valid and pick the same shift, which is all but 1% of the
    matches."""
    kl, kr = kps
    L, R = world["left"][0], world["right"][0]
    c = _cfg(jcfg)
    js = jst.match_stereo(c.camera, c.extractor, c.matcher, kl, kr,
                          jnp.asarray(L), jnp.asarray(R))
    t = _cfg(tcfg)
    ts = tst.match_stereo(t.camera, t.extractor, t.matcher, _tkps(kl),
                          _tkps(kr), _t(L), _t(R))
    jv, tv = np.asarray(js.valid), ts.valid.numpy()
    assert (jv != tv).mean() <= 0.01
    both = jv & tv
    flip = _flips(ts.u_right.numpy(), np.asarray(js.u_right), both)
    assert flip.sum() <= 0.01 * both.sum(), (flip.sum(), both.sum())
    same = both & ~flip
    np.testing.assert_allclose(ts.depth.numpy()[same],
                               np.asarray(js.depth)[same], rtol=1e-3)


def test_sad_subpixel(world, rng):
    """The SAD window + parabola on its own, at disparities round the true
    ones and at keypoints near every border (window origins clipped): at
    most 1% flips, the rest within 1e-3."""
    n = 2000
    L = world["left"][3].astype(np.float32)
    R = world["right"][3].astype(np.float32)
    uv = np.stack([rng.uniform(-3, 643, n), rng.uniform(-3, 483, n)],
                  1).astype(np.float32)
    uR = (uv[:, 0] - rng.uniform(0, 30, n)).astype(np.float32)
    ju = np.asarray(jst._sad_subpixel(jnp.asarray(L), jnp.asarray(R),
                                      jnp.asarray(uv), jnp.asarray(uR)))
    tu = tst._sad_subpixel(_t(L), _t(R), _t(uv), _t(uR)).numpy()
    flip = _flips(tu, ju, np.ones(n, bool))
    assert flip.sum() <= 0.01 * n, flip.sum()


@pytest.mark.parametrize("close_only", [True, False])
def test_add_depth_points(world, kps, close_only):
    """A keyframe inserted into an empty map, then landmarks from its
    depth: initialisation takes every positive depth, later keyframes only
    those under bf / fx * 35 = 4.2 m; half the keypoints already bound."""
    c, t = _cfg(jcfg, "rgbd"), _cfg(tcfg, "rgbd")
    jf = jbuild(jnp.asarray(world["left"][2]), c)
    tf = TFrame(*[_t(a) for a in jf])
    sd = jst.rgbd_depth(c.camera, jf.uv, jf.valid,
                        jnp.asarray(world["depth"][2]))
    T = np.asarray(world["gt"][2], np.float32)
    N = jf.uv.shape[0]
    kp = np.where(np.arange(N) % 2 == 0, np.arange(N) % 64, -1) \
        .astype(np.int32)
    jm = jms.empty_map(c)
    jm = jm._replace(pt_valid=jm.pt_valid.at[:64].set(True),
                     n_pt=jnp.int32(64))
    jm, jk = jlm.insert_keyframe(c, jm, jf, jnp.asarray(T), jnp.int32(2),
                                 jnp.asarray(kp))
    tm = _tmap(jm)
    jout = jlm.add_depth_points(c, jm, jk, sd.depth, close_only)
    tout = tlm.add_depth_points(t, tm, _t(jk), _t(sd.depth), close_only)
    for k, tv in tout._asdict().items():
        jv = np.asarray(getattr(jout, k))
        if jv.dtype == np.uint32:
            jv = jv.view(np.int32)
        if jv.dtype == np.float32:
            np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=k)
    added = int(jout.n_pt) - 64
    assert added > 20
    far = np.asarray(sd.depth) >= 4.2
    assert (far & np.asarray(sd.valid)).any()


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_track_chunk_with_depth(world, sensor):
    """One chunk (frames 4-11) from the reference's per-frame state after
    frame 3, on its map, with the sensor's images as `aux_imgs`: the same
    keyframe flags and per-keypoint depth, poses within 1e-3, inliers
    within max(3, 5%)."""
    c, t = _cfg(jcfg, sensor), _cfg(tcfg, sensor)
    aux = world_aux(world, sensor)
    js = JSystem(c, enable_loop_closing=False)
    step = js.track_rgbd if sensor == "rgbd" else js.track_stereo
    for i in range(4):
        step(world["left"][i], aux[i], i)
    assert js.velocity is not None
    jcarry = jtr.ChunkCarry(
        T=jnp.asarray(js.last_T), vel=jnp.asarray(js.velocity),
        has_vel=jnp.asarray(True), kp_pt=jnp.asarray(js.last_kp_pt),
        level=jnp.asarray(js.last_level),
        frames_since_kf=jnp.asarray(js.frames_since_kf, jnp.int32),
        ref_kf=jnp.asarray(js.last_ref_kf, jnp.int32),
        pt_visible=js.map.pt_visible, pt_found=js.map.pt_found)
    tcarry = ttr.ChunkCarry(*[_t(a) for a in jcarry])
    imgs, ax = world["left"][4:], aux[4:]
    jout = jtr.track_chunk(c, js.map, jnp.asarray(imgs), True, jcarry,
                           jnp.asarray(ax))
    tout = ttr.track_chunk(t, _tmap(js.map), _t(imgs), True, tcarry, _t(ax))
    jst_, tst_ = jout[1], tout[1]
    np.testing.assert_array_equal(tst_.ok.numpy(), np.asarray(jst_.ok))
    np.testing.assert_array_equal(tst_.need_kf.numpy(),
                                  np.asarray(jst_.need_kf))
    np.testing.assert_allclose(tst_.T.numpy(), np.asarray(jst_.T), atol=1e-3)
    ji, ti = np.asarray(jst_.n_inliers), tst_.n_inliers.numpy()
    assert (np.abs(ti - ji) <= np.maximum(3, 0.05 * ji)).all(), (ti, ji)
    jd, td = np.asarray(jout[6]), tout[6].numpy()
    if sensor == "rgbd":
        np.testing.assert_array_equal(td, jd)
    else:
        assert ((jd > 0) != (td > 0)).mean() <= 0.01
        both = (jd > 0) & (td > 0)
        assert (np.abs(td - jd) <= 1e-3 * jd)[both].mean() >= 0.99

    # the chunk's last frame as a depth keyframe, through the whole backend
    # (insert, landmarks from depth, triangulation, fuse, local BA, culling)
    j = FRAMES - 5
    jf = jax.tree.map(lambda a: a[j], jout[2])
    jm, jk, jaux = jlm.backend_insert(c, js.map, jf, jst_.T[j],
                                      jnp.int32(4 + j), jout[3][j], True,
                                      jout[6][j], None)
    tm, tk, taux = tlm.backend_insert(t, _tmap(js.map),
                                      TFrame(*[_t(a) for a in jf]),
                                      _t(jst_.T[j]), 4 + j, _t(jout[3][j]),
                                      True, _t(jout[6][j]), None)
    assert int(tk) == int(jk)
    assert int(jaux["n_pt"]) > int(js.map.n_pt)
    assert abs(int(taux["n_pt"]) - int(jaux["n_pt"])) \
        <= 0.01 * int(jaux["n_pt"])
    jo, to = np.asarray(jm.kf_obs_pt), tm.kf_obs_pt.numpy()
    assert (jo != to).sum() <= 0.005 * (jo >= 0).sum()
    if sensor == "rgbd":
        kfv = np.asarray(jm.kf_valid)
        np.testing.assert_allclose(tm.kf_pose.numpy()[kfv],
                                   np.asarray(jm.kf_pose)[kfv], atol=1e-3)


def test_local_ba_on_a_stereo_keyframe(world):
    """Local BA right after a stereo keyframe's insert: the reference's BA
    has no stereo term, so a landmark made from depth and seen by its
    keyframe alone has no constraint along its ray; its 3x3 block is
    singular up to the LM damping, and the two f32 solves can part (by
    4.8 cm in the new keyframe's translation on test_track_chunk_with_depth's
    stereo keyframe).  Without those single-view observations the problem
    is well posed and the two agree within 1e-4 (ROADMAP Queue 3)."""
    c, t = _cfg(jcfg, "stereo"), _cfg(tcfg, "stereo")
    js = JSystem(c, enable_loop_closing=False)
    for i in range(FRAMES):
        js.track_stereo(world["left"][i], world["right"][i], i)
    jf = jbuild(jnp.asarray(world["left"][FRAMES - 1]), c)
    kpsR = jorb.extract(jnp.asarray(world["right"][FRAMES - 1]),
                        c.extractor)
    sd = jst.match_stereo(c.camera, c.extractor, c.matcher,
                          {"uv": jf.uv, "level": jf.level, "desc": jf.desc,
                           "valid": jf.valid}, kpsR,
                          jnp.asarray(world["left"][FRAMES - 1]),
                          jnp.asarray(world["right"][FRAMES - 1]))
    jm, jk = jlm.insert_keyframe(c, js.map, jf, jnp.asarray(js.last_T),
                                 jnp.int32(FRAMES - 1), js.last_kp_pt)
    jm = jlm.add_depth_points(c, jm, jk, sd.depth)
    obs = np.asarray(jm.kf_obs_pt)[: int(jm.n_kf)]
    cnt = np.bincount(obs[obs >= 0], minlength=jm.pt_pos.shape[0])
    row = obs[int(jk)]
    single = (row >= 0) & (cnt[np.maximum(row, 0)] == 1)
    assert single.sum() > 20
    shared = np.where(single, -1, row).astype(np.int32)
    jm = jm._replace(kf_obs_pt=jm.kf_obs_pt.at[jk].set(shared))
    jout = jlm.local_ba_body(c, jm, jk, 4)
    tout = tlm.local_ba_body(t, _tmap(jm), _t(jk), 4)
    np.testing.assert_allclose(tout.kf_pose.numpy()[: int(jm.n_kf)],
                               np.asarray(jout.kf_pose)[: int(jm.n_kf)],
                               atol=1e-4)
