"""The remaining public helpers of the port's utils/camera.py (
`intrinsics_matrix`, `distort_normalized`, `project`, `in_image`,
`projection_matrix`) and utils/geometry.py (`se3_identity`, `apply_se3`,
`log_se3`, `triangulate_dlt`, `slerp`) against coslam_tpu's on the same
inputs, mirroring tests/test_camera_eval.py and tests/test_geometry.py.
float32 on both sides: rtol / atol 1e-5 unless a test says otherwise;
exact where the two compute the same comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.utils import camera as jcam
from coslam_tpu.utils import geometry as jgeo
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.utils import camera as tcam
from coslam_tpu_torch.utils import geometry as tgeo

TOL = dict(rtol=1e-5, atol=1e-5)
PRESETS = ["tum_fr1_config", "euroc_config", "kitti_config"]


def _cams(preset):
    return getattr(jcfg, preset)().camera, getattr(tcfg, preset)().camera


def _poses(rng, n):
    xi = np.concatenate([rng.normal(0, 1, (n, 3)), rng.normal(0, 0.8, (n, 3))],
                        1).astype(np.float32)
    xi[0, 3:] = 1e-6          # the small-angle series branches
    return xi, np.array(jgeo.exp_se3(jnp.asarray(xi)))


@pytest.mark.parametrize("preset", PRESETS)
def test_intrinsics_and_distortion(rng, preset):
    jc, tc = _cams(preset)
    np.testing.assert_array_equal(tcam.intrinsics_matrix(tc).numpy(),
                                  np.asarray(jcam.intrinsics_matrix(jc)))
    xn = rng.uniform(-0.4, 0.4, (300, 2)).astype(np.float32)
    j = np.asarray(jcam.distort_normalized(jc, jnp.asarray(xn)))
    t = tcam.distort_normalized(tc, torch.from_numpy(xn)).numpy()
    np.testing.assert_allclose(t, j, **TOL)
    # the port's own round trip, as tests/test_camera_eval.py holds the JAX
    # package's
    back = tcam.undistort_normalized(tc, torch.from_numpy(t), iters=12)
    np.testing.assert_allclose(back.numpy(), xn, atol=1e-4)


@pytest.mark.parametrize("distort", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_project_and_in_image(rng, preset, distort):
    jc, tc = _cams(preset)
    pts = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-2, 2, 400),
                    rng.uniform(0.5, 12, 400)], 1).astype(np.float32)
    pts[0, 2] = 0.0           # the divide-by-zero guard
    ju, jz = jcam.project(jc, jnp.asarray(pts), distort=distort)
    tu, tz = tcam.project(tc, torch.from_numpy(pts), distort=distort)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(tu.numpy()[1:], np.asarray(ju)[1:], **TOL)
    np.testing.assert_allclose(tu.numpy()[0], np.asarray(ju)[0], rtol=1e-5)
    for margin in (0.0, 19.0):
        np.testing.assert_array_equal(
            tcam.in_image(tc, tu, margin).numpy(),
            np.asarray(jcam.in_image(jc, ju, margin)))
    if not distort:
        back = tcam.backproject(tc, tu[1:], tz[1:]).numpy()
        np.testing.assert_allclose(back, pts[1:], atol=1e-4)


def test_projection_matrix(rng):
    jc, tc = _cams("tum_fr1_config")
    _, T = _poses(rng, 6)
    j = np.asarray(jcam.projection_matrix(jc, jnp.asarray(T)))
    t = tcam.projection_matrix(tc, torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(t, j, **TOL)
    assert t.shape == (6, 3, 4)


def test_se3_identity_and_apply(rng):
    np.testing.assert_array_equal(tgeo.se3_identity().numpy(),
                                  np.asarray(jgeo.se3_identity()))
    assert tgeo.se3_identity(torch.float64).dtype == torch.float64
    _, T = _poses(rng, 16)
    p = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
    j = np.asarray(jgeo.apply_se3(jnp.asarray(T), jnp.asarray(p)))
    t = tgeo.apply_se3(torch.from_numpy(T), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(t, j, **TOL)


def test_log_se3(rng):
    """Against the JAX function, and exp -> log round trip as in
    tests/test_geometry.py (atol 5e-4 there)."""
    xi, T = _poses(rng, 32)
    j = np.asarray(jgeo.log_se3(jnp.asarray(T)))
    t = tgeo.log_se3(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    small = rng.standard_normal((32, 6)).astype(np.float32)
    small[:, 3:] *= 0.5
    back = tgeo.log_se3(tgeo.exp_se3(torch.from_numpy(small))).numpy()
    np.testing.assert_allclose(back, small, atol=5e-4)


def test_triangulate_dlt(rng):
    """tests/test_geometry.py's two-point case, then a batch of 64 points
    seen from two random poses: the port's DLT against the JAX one (the
    SVD's null vector is unique up to sign, which the division removes)."""
    jc, tc = _cams("tum_fr1_config")
    pts = np.stack([rng.uniform(-1.5, 1.5, 64), rng.uniform(-1, 1, 64),
                    rng.uniform(4, 10, 64)], 1).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jgeo.exp_se3(jnp.asarray([0.5, 0, 0, 0, 0.05, 0],
                                             jnp.float32)))
    P = [np.asarray(jcam.projection_matrix(jc, jnp.asarray(T)))
         for T in (T1, T2)]
    uv = [np.asarray(jcam.project(jc, jgeo.transform_points(
        jnp.asarray(T), jnp.asarray(pts)))[0]) for T in (T1, T2)]
    B = lambda a: np.broadcast_to(a, (64,) + a.shape).copy()  # noqa: E731
    j = np.asarray(jgeo.triangulate_dlt(jnp.asarray(B(P[0])),
                                        jnp.asarray(B(P[1])),
                                        jnp.asarray(uv[0]),
                                        jnp.asarray(uv[1])))
    t = tgeo.triangulate_dlt(torch.from_numpy(B(P[0])),
                             torch.from_numpy(B(P[1])),
                             torch.from_numpy(uv[0]),
                             torch.from_numpy(uv[1])).numpy()
    np.testing.assert_allclose(t, pts, atol=1e-2)
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)


def test_slerp(rng):
    """Random pairs (half with a negative dot product), an identical pair
    (the small-angle branch) and the end points."""
    q0 = rng.standard_normal((32, 4)).astype(np.float32)
    q1 = rng.standard_normal((32, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q1[-1] = q0[-1]
    u = rng.uniform(0, 1, (32, 1)).astype(np.float32)
    for uu in (u, np.float32(0.0), np.float32(1.0)):
        j = np.asarray(jgeo.slerp(jnp.asarray(q0), jnp.asarray(q1),
                                  jnp.asarray(uu)))
        t = tgeo.slerp(torch.from_numpy(q0), torch.from_numpy(q1),
                       torch.as_tensor(uu)).numpy()
        np.testing.assert_allclose(t, j, **TOL)
    t = tgeo.slerp(torch.from_numpy(q0), torch.from_numpy(q1), 0.25).numpy()
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-6)
