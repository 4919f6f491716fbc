"""Port geometry and camera functions against coslam_tpu on the same inputs
(allclose at rtol 1e-5 / atol 1e-5: float32 on both sides, summation order
differs)."""

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


def _both(fn_name, *arrays):
    j = np.asarray(getattr(jgeo, fn_name)(*[jnp.asarray(a) for a in arrays]))
    t = getattr(tgeo, fn_name)(*[torch.tensor(a) for a in arrays]).numpy()
    return j, t


def _poses(rng, n):
    xi = np.concatenate([rng.normal(0, 1, (n, 3)), rng.normal(0, 0.8, (n, 3))],
                        1).astype(np.float32)
    xi[0, 3:] = 1e-6          # the small-angle series branch
    return np.asarray(jgeo.exp_se3(jnp.asarray(xi)))


@pytest.mark.parametrize("fn_name", ["hat", "exp_so3"])
def test_so3(rng, fn_name):
    w = rng.normal(0, 1, (64, 3)).astype(np.float32)
    w[0] = 1e-6
    j, t = _both(fn_name, w)
    np.testing.assert_allclose(t, j, **TOL)


def test_exp_se3(rng):
    xi = rng.normal(0, 1, (64, 6)).astype(np.float32)
    xi[0, 3:] = 1e-6
    j, t = _both("exp_se3", xi)
    np.testing.assert_allclose(t, j, **TOL)


def test_se3_inverse_and_project(rng):
    T = _poses(rng, 32)
    j, t = _both("se3_inverse", T)
    np.testing.assert_allclose(t, j, **TOL)
    noisy = (T + rng.normal(0, 1e-3, T.shape)).astype(np.float32)
    j, t = _both("project_se3", noisy)
    np.testing.assert_allclose(t, j, **TOL)
    j, t = _both("project_so3", noisy[:, :3, :3].copy())
    np.testing.assert_allclose(t, j, **TOL)


def test_transform_points(rng):
    T = _poses(rng, 1)[0]
    X = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    j, t = _both("transform_points", T, X)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("preset", ["tum_fr1_config", "kitti_config"])
def test_undistort_pixels(rng, preset):
    jc = getattr(jcfg, preset)().camera
    tc = getattr(tcfg, preset)().camera
    uv = np.stack([rng.uniform(0, jc.width, 400),
                   rng.uniform(0, jc.height, 400)], 1).astype(np.float32)
    j = np.asarray(jcam.undistort_pixels(jc, jnp.asarray(uv)))
    t = tcam.undistort_pixels(tc, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(t, j, **TOL)


def _sim3s(rng, n):
    """n random similarities as numpy (s, R, t); the first is near the
    identity (the series branches)."""
    xi = np.concatenate([rng.normal(0, 1, (n, 3)), rng.normal(0, 0.6, (n, 3)),
                         rng.normal(0, 0.3, (n, 1))], 1).astype(np.float32)
    xi[0, 3:] = 1e-6
    S = jgeo.exp_sim3(jnp.asarray(xi))
    return xi, {k: np.asarray(v) for k, v in S.items()}


def _tsim(S):
    return {k: torch.tensor(v) for k, v in S.items()}


def _jsim(S):
    return {k: jnp.asarray(v) for k, v in S.items()}


@pytest.mark.parametrize("fn_name", ["vee", "log_so3", "project_to_so3"])
def test_so3_inverse_maps(rng, fn_name):
    """vee, log_so3 and the SVD projection against the JAX functions (the
    SVD's singular vectors differ between LAPACK builds, their product does
    not: 1e-5)."""
    R = _poses(rng, 32)[:, :3, :3].copy()
    if fn_name == "project_to_so3":
        R = (R + rng.normal(0, 1e-2, R.shape)).astype(np.float32)
    j, t = _both(fn_name, R)
    np.testing.assert_allclose(t, j, **TOL)


def test_sim3_algebra(rng):
    """sim3_apply / compose / inverse / from_se3 / to_se3 / identity, 1e-5."""
    _, A = _sim3s(rng, 16)
    _, B = _sim3s(rng, 16)
    X = rng.uniform(-3, 3, (16, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.sim3_apply(_tsim(A), torch.tensor(X)).numpy(),
        np.asarray(jgeo.sim3_apply(_jsim(A), jnp.asarray(X))), **TOL)
    jc = jgeo.sim3_compose(_jsim(A), _jsim(B))
    tc = tgeo.sim3_compose(_tsim(A), _tsim(B))
    ji = jgeo.sim3_inverse(_jsim(A))
    ti = tgeo.sim3_inverse(_tsim(A))
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), **TOL)
    np.testing.assert_allclose(
        tgeo.sim3_to_se3(_tsim(A)).numpy(),
        np.asarray(jgeo.sim3_to_se3(_jsim(A))), **TOL)
    T = _poses(rng, 4)
    jf, tf = jgeo.sim3_from_se3(jnp.asarray(T)), \
        tgeo.sim3_from_se3(torch.tensor(T))
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), **TOL)
    ident = tgeo.sim3_identity("cpu")
    assert float(ident["s"]) == 1.0
    np.testing.assert_array_equal(ident["R"].numpy(), np.eye(3))
    np.testing.assert_array_equal(ident["t"].numpy(), np.zeros(3))
    np.testing.assert_array_equal(
        tgeo.sim3(2.0, ident["R"], ident["t"])["s"].numpy(), np.float32(2))


def test_exp_log_sim3(rng):
    """exp_sim3 and log_sim3 against JAX, and log(exp(xi)) == xi, to 1e-5
    (relative, on twists of norm ~1)."""
    xi, S = _sim3s(rng, 64)
    te = tgeo.exp_sim3(torch.tensor(xi))
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(te[k].numpy(), S[k], **TOL)
    jl = np.asarray(jgeo.log_sim3(_jsim(S)))
    tl = tgeo.log_sim3(_tsim(S)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=2e-5)
    # the round trip holds away from the series branch of row 0, whose
    # 1e-6 rotation is below float32's resolution of the trace
    np.testing.assert_allclose(tl[1:], xi[1:], rtol=1e-5, atol=2e-5)
