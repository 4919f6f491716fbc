"""Kernel K3's plain twin and the port's `optimize_pose` against coslam_tpu on
a pose-recovery problem with planted outliers.

Bars: the twin against the Pallas `pose_opt_lm` (interpret mode): T within
1e-3 (f32 reductions in another order), inlier masks differ in at most 5 of
N.  The port's `optimize_pose` (kernel route) against the reference's XLA
formulation `_optimize_pose_xla_testonly`: T within 1e-2, at most 5 of N
inliers differ, and the true pose recovered within 5e-3 — the bars of
tests/test_pallas_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.ops import pallas_kernels as pk
from coslam_tpu.optim import pose_opt as jpo
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.optim import pose_opt as tpo
from coslam_tpu_torch.utils import geometry as tgeo

CAM = dict(fx=500., fy=500., cx=320., cy=240., width=640, height=480)


def _problem(rng, n=512, n_out=60):
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    Rg = tgeo.exp_so3(torch.tensor([0.03, -0.02, 0.05])).numpy()
    Tgt = np.eye(4, dtype=np.float32)
    Tgt[:3, :3] = Rg
    Tgt[:3, 3] = [0.1, -0.05, 0.08]
    pc = X @ Rg.T + Tgt[:3, 3]
    uv = np.stack([pc[:, 0] / pc[:, 2] * 500 + 320,
                   pc[:, 1] / pc[:, 2] * 500 + 240], 1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    isg = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    return X, uv, isg, valid, Tgt, out_idx


@pytest.mark.parametrize("n", [512, 1000])
def test_twin_against_pallas_kernel(rng, n):
    X, uv, isg, valid, Tgt, out_idx = _problem(rng, n)
    isg_m = np.where(valid, isg, 0).astype(np.float32)
    cfg = jcfg.TrackerConfig()
    pad = (-n) % 128       # the Pallas kernel wants a multiple of 128
    Xp = np.concatenate([X, np.ones((pad, 3), np.float32)])
    uvp = np.concatenate([uv, np.zeros((pad, 2), np.float32)])
    wp = np.concatenate([isg_m, np.zeros(pad, np.float32)])
    kw = dict(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"],
              rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters,
              chi2_th=cfg.chi2_mono)
    Tj, ij = pk.pose_opt_lm(jnp.eye(4), jnp.asarray(Xp), jnp.asarray(uvp),
                            jnp.asarray(wp), **kw)
    Tt, it = ck.pose_opt_lm(torch.eye(4), torch.from_numpy(X),
                            torch.from_numpy(uv), torch.from_numpy(isg_m), **kw)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3)
    assert int((it.numpy() != np.asarray(ij)[:n]).sum()) <= 5
    assert not it.numpy()[out_idx].any()


def test_optimize_pose_against_xla_reference(rng):
    n = 512
    X, uv, isg, valid, Tgt, out_idx = _problem(rng, n)
    res_j = jpo._optimize_pose_xla_testonly(
        jcfg.CameraConfig(**CAM), jnp.eye(4), jnp.asarray(X), jnp.asarray(uv),
        jnp.asarray(valid), jnp.asarray(isg), jcfg.TrackerConfig())
    res_t = tpo.optimize_pose(
        tcfg.CameraConfig(**CAM), torch.eye(4), torch.from_numpy(X),
        torch.from_numpy(uv), torch.from_numpy(valid), torch.from_numpy(isg),
        tcfg.TrackerConfig())
    Tt = res_t.T.numpy()
    assert float(np.abs(Tt - Tgt).max()) < 5e-3
    assert float(np.abs(Tt - np.asarray(res_j.T)).max()) < 1e-2
    assert int((res_t.inliers.numpy() != np.asarray(res_j.inliers)).sum()) <= 5
    assert int(res_t.n_inliers) == int(res_t.inliers.sum())
    assert not res_t.inliers.numpy()[out_idx].any()
    assert not res_t.inliers.numpy()[~valid].any()
    # the port's copy of the XLA formulation agrees too
    res_x = tpo._optimize_pose_xla_testonly(
        tcfg.CameraConfig(**CAM), torch.eye(4), torch.from_numpy(X),
        torch.from_numpy(uv), torch.from_numpy(valid), torch.from_numpy(isg),
        tcfg.TrackerConfig())
    assert float(np.abs(res_x.T.numpy() - np.asarray(res_j.T)).max()) < 1e-3
    assert int((res_x.inliers.numpy() != np.asarray(res_j.inliers)).sum()) <= 5


def test_chol_solve6(rng):
    A = rng.normal(0, 1, (6, 6)).astype(np.float32)
    H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    np.testing.assert_allclose(
        tpo.chol_solve6(torch.from_numpy(H), torch.from_numpy(b)).numpy(),
        np.asarray(jpo.chol_solve6(jnp.asarray(H), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)
