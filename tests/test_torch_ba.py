"""optim/ba: the dense-Schur LM (`solve_dense`, `solve_dense_compact`), the
matrix-free PCG solver (`solve`, `solve_body`) and their helpers, the port
against coslam_tpu on the same problem.

Bars: residuals / Jacobians within 1e-4 relative; poses within 1e-4,
points within 1e-3, `obs_inlier` differing in at most 0.5% of the
observations, final cost within 1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.optim import ba as jba
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.optim import ba as tba

CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480)


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _problem(seed, K=8, P=240, obs_per_kf=200):
    """Cameras along a line looking at a point cloud; noisy poses and
    points, 0.5 px pixel noise, 5% gross outliers, 10% invalid slots."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                  rng.uniform(6, 12, P)], 1)
    poses, obs = [], []
    for k in range(K):
        T = np.eye(4)
        T[:3, :3] = _rot(rng.normal(0, 0.02, 3) + 1e-9)
        T[:3, 3] = [-0.3 * k, 0.02 * rng.normal(), 0.0]
        poses.append(T)
        pts = rng.choice(P, obs_per_kf, replace=False)
        pc = X[pts] @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([pc[:, 0] / pc[:, 2] * CAM["fx"] + CAM["cx"],
                       pc[:, 1] / pc[:, 2] * CAM["fy"] + CAM["cy"]], 1)
        uv += rng.normal(0, 0.5, uv.shape)
        bad = rng.uniform(size=obs_per_kf) < 0.05
        uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
        obs.append((np.full(obs_per_kf, k), pts, uv))
    poses = np.stack(poses)
    noisy = poses.copy()
    for k in range(2, K):
        d = np.eye(4)
        d[:3, :3] = _rot(rng.normal(0, 0.005, 3))
        d[:3, 3] = rng.normal(0, 0.03, 3)
        noisy[k] = d @ poses[k]
    obs_kf = np.concatenate([o[0] for o in obs]).astype(np.int32)
    obs_pt = np.concatenate([o[1] for o in obs]).astype(np.int32)
    obs_uv = np.concatenate([o[2] for o in obs]).astype(np.float32)
    level = rng.integers(0, 4, obs_kf.size)
    arrays = dict(
        poses=noisy.astype(np.float32),
        points=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
        obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=obs_uv,
        obs_w=(1.0 / 1.44 ** level).astype(np.float32),
        obs_valid=rng.uniform(size=obs_kf.size) > 0.1,
        kf_fixed=np.arange(K) < 2)
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jp, tp


def _compare(jr, tr):
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses),
                               atol=1e-4)
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points),
                               atol=1e-3)
    diff = (tr.obs_inlier.numpy() != np.asarray(jr.obs_inlier)).mean()
    assert diff <= 0.005, diff
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_dense_matches_reference(seed):
    jp, tp = _problem(seed)
    jr = jba.solve_dense(jcfg.CameraConfig(**CAM), jp, 6)
    tr = tba.solve_dense(tcfg.CameraConfig(**CAM), tp, 6)
    _compare(jr, tr)
    # the solve did work: the free cameras moved, outliers were flagged
    assert float(tr.cost) < 0.5 * float(tba.solve_dense(
        tcfg.CameraConfig(**CAM), tp, 0).cost)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_matches_reference(seed):
    """The matrix-free PCG solver against `coslam_tpu.optim.ba.solve` on
    the well-observed problem (poses 1e-4, points 1e-3), and against the
    port's own `solve_dense`: same optimum, truncated PCG against an exact
    solve (poses 2e-3, points 2e-2, cost within 1 %)."""
    jp, tp = _problem(seed)
    jr = jba.solve(jcfg.CameraConfig(**CAM), jp, 6, 30)
    tr = tba.solve(tcfg.CameraConfig(**CAM), tp, 6, 30)
    _compare(jr, tr)
    td = tba.solve_dense(tcfg.CameraConfig(**CAM), tp, 6)
    np.testing.assert_allclose(tr.poses.numpy(), td.poses.numpy(), atol=2e-3)
    np.testing.assert_allclose(tr.points.numpy(), td.points.numpy(),
                               atol=2e-2)
    np.testing.assert_allclose(float(tr.cost), float(td.cost), rtol=1e-2)
    # fixed cameras did not move
    np.testing.assert_allclose(tr.poses.numpy()[:2], tp.poses.numpy()[:2],
                               atol=1e-6)


def test_solve_body_is_solve_and_sharding_waits():
    """`solve` is `solve_body` with no mesh axis; the sharded branch raises,
    naming its ROADMAP item."""
    _, tp = _problem(4)
    cam = tcfg.CameraConfig(**CAM)
    a = tba.solve(cam, tp, 2, 10)
    b = tba.solve_body(cam, tp, 2, 10, 5.991, True, None)
    np.testing.assert_array_equal(a.poses.numpy(), b.poses.numpy())
    with pytest.raises(NotImplementedError, match="item 16"):
        tba.solve_body(cam, tp, 2, 10, 5.991, True, "obs")


@pytest.mark.parametrize("p_local", [512, 200])
def test_solve_dense_compact_matches_reference(p_local):
    """p_local >= observed points (exact compaction) and < (overflow
    observations masked out, the reference's known behaviour)."""
    jp, tp = _problem(2)
    jr = jba.solve_dense_compact(jcfg.CameraConfig(**CAM), jp, p_local, 6)
    tr = tba.solve_dense_compact(tcfg.CameraConfig(**CAM), tp, p_local, 6)
    _compare(jr, tr)


def test_helpers_match_reference(rng):
    jp, tp = _problem(3)
    jr = jba._proj_residuals(jcfg.CameraConfig(**CAM), jp.poses, jp.points,
                             jp)
    tr = tba._proj_residuals(tcfg.CameraConfig(**CAM), tp.poses, tp.points,
                             tp)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-3)
    chi2 = rng.uniform(0, 20, 1000).astype(np.float32)
    for fn in ("_robust_weight", "_robust_cost"):
        np.testing.assert_allclose(
            getattr(tba, fn)(torch.from_numpy(chi2), 5.991, True).numpy(),
            np.asarray(getattr(jba, fn)(jnp.asarray(chi2), 5.991, True)),
            rtol=1e-6)
    M = rng.normal(size=(50, 3, 3)).astype(np.float32)
    M = M @ np.swapaxes(M, 1, 2) + np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tba._inv3(torch.from_numpy(M)).numpy(),
                               np.asarray(jba._inv3(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-6)
    B = rng.normal(size=(4, 6, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tba._block_diag_dense(torch.from_numpy(B)).numpy(),
        np.asarray(jba._block_diag_dense(jnp.asarray(B))))
    x = rng.normal(size=(100, 3)).astype(np.float32)
    idx = rng.integers(0, 7, 100).astype(np.int32)
    np.testing.assert_allclose(
        tba._seg_sum(torch.from_numpy(x), torch.from_numpy(idx), 7).numpy(),
        np.asarray(jba._seg_sum(jnp.asarray(x), jnp.asarray(idx), 7)),
        atol=1e-5)
