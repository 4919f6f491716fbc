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
