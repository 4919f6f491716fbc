"""`ops/sim3.horn_sim3` and `ops/pnp.ransac_pnp` against coslam_tpu on the
same numpy inputs, on the CPU.

Bars.  horn_sim3: s, R, t within 1e-5 (one 4x4 `eigh` and a few f32 sums
apart).  ransac_pnp with the reference's draws injected: the EPnP null
vector comes from an `eigh` of a 12x12 f32 Gram matrix, so single
hypotheses on weak samples differ between LAPACKs and are held loosely (the
median hypothesis within 1e-2, every hypothesis' inlier count within 5 for
9 in 10).  Near-equal counts can crown different hypotheses in the two
packages, so the raw winner is held to its inlier set (masks differing in
at most 5, count within 5) and to 0.2 in T, and the winner after
`optimize_pose`, which is what relocalization uses, tightly: T within
1e-3, inlier masks differing in at most 5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.ops import pnp as jpnp
from coslam_tpu.ops import sim3 as jsim3
from coslam_tpu.optim import pose_opt as jpose
from coslam_tpu.utils import geometry as jgeo
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.ops import pnp as tpnp
from coslam_tpu_torch.ops import sim3 as tsim3
from coslam_tpu_torch.optim import pose_opt as tpose
from coslam_tpu_torch.utils import geometry as tgeo

CAM = dict(fx=450, fy=450, cx=320, cy=240, width=640, height=480)


def _rigid_pairs(rng, batch, n, scale):
    x1 = rng.uniform(-3, 3, batch + (n, 3)).astype(np.float32)
    xi = rng.uniform(-0.6, 0.6, batch + (6,)).astype(np.float32)
    T = np.asarray(jgeo.exp_se3(jnp.asarray(xi)))
    s = rng.uniform(0.5, 2.0, batch).astype(np.float32) if scale \
        else np.ones(batch, np.float32)
    x2 = s[..., None, None] * (x1 @ np.swapaxes(T[..., :3, :3], -1, -2)) \
        + T[..., None, :3, 3]
    x2 = x2 + rng.normal(0, 1e-3, x2.shape)
    return x1, x2.astype(np.float32), s, T


@pytest.mark.parametrize("batch,fix_scale,weighted", [
    ((), False, False), ((7,), False, True), ((4, 3), True, False)])
def test_horn_sim3(rng, batch, fix_scale, weighted):
    x1, x2, s_gt, T_gt = _rigid_pairs(rng, batch, 12, not fix_scale)
    w = rng.uniform(0.2, 1.0, batch + (12,)).astype(np.float32) \
        if weighted else None
    js, jR, jt = jsim3.horn_sim3(jnp.asarray(x1), jnp.asarray(x2),
                                 None if w is None else jnp.asarray(w),
                                 fix_scale=fix_scale)
    ts, tR, tt = tsim3.horn_sim3(torch.from_numpy(x1), torch.from_numpy(x2),
                                 None if w is None else torch.from_numpy(w),
                                 fix_scale=fix_scale)
    assert tR.shape == batch + (3, 3) and tt.shape == batch + (3,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), T_gt[..., :3, :3], atol=5e-3)
    np.testing.assert_allclose(ts.numpy(), s_gt, atol=5e-3)


def test_quat_to_rot(rng):
    q = rng.normal(size=(9, 4)).astype(np.float32)
    R = tgeo.quat_to_rot(torch.from_numpy(q))
    np.testing.assert_allclose(R.numpy(), np.asarray(jgeo.quat_to_rot(
        jnp.asarray(q))), atol=1e-6)
    torch.testing.assert_close(tgeo.quat_to_rot(torch.from_numpy(-q)), R)
    torch.testing.assert_close(
        tgeo.quat_to_rot(tgeo.rot_to_quat(R)), R, atol=1e-5, rtol=0)


def _pnp_scenario(rng, n=200):
    """tests/test_pnp_reloc.py::test_ransac_pnp_recovers_pose."""
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    T_gt = np.asarray(jgeo.exp_se3(jnp.asarray(
        [0.3, -0.2, 0.1, 0.05, -0.08, 0.12], jnp.float32)))
    pc = X @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv = np.stack([pc[:, 0] / pc[:, 2] * CAM["fx"] + CAM["cx"],
                   pc[:, 1] / pc[:, 2] * CAM["fy"] + CAM["cy"]], 1)
    uv += rng.normal(0, 0.3, uv.shape)
    out = rng.random(n) < 0.3
    uv[out] += rng.uniform(-100, 100, (int(out.sum()), 2))
    valid = rng.random(n) < 0.9
    return X, uv.astype(np.float32), valid, out, T_gt


def _jax_draws(key, valid, iters=512):
    p = jnp.asarray(valid, jnp.float32)
    p = p / (p.sum() + 1e-9)
    return np.array(jax.random.choice(key, valid.shape[0], shape=(iters, 6),
                                      replace=True, p=p))


def test_ransac_pnp_with_the_reference_draws(rng):
    X, uv, valid, out, T_gt = _pnp_scenario(rng)
    jcam, tcam = jcfg.CameraConfig(**CAM), tcfg.CameraConfig(**CAM)
    key = jax.random.PRNGKey(0)
    jres = jpnp.ransac_pnp(jcam, jnp.asarray(X), jnp.asarray(uv),
                           jnp.asarray(valid), key)
    samples = _jax_draws(key, valid)
    assert valid[samples].all()
    tX, tuv, tvalid = (torch.from_numpy(a) for a in (X, uv, valid))
    tres = tpnp.ransac_pnp(tcam, tX, tuv, tvalid, torch.from_numpy(samples))

    # the winner
    assert int(tres.n_inliers) == int(tres.inliers.sum())
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 5
    assert int((tres.inliers.numpy() != np.asarray(jres.inliers)).sum()) <= 5
    np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T), atol=0.2)
    assert not tres.inliers.numpy()[~valid].any()
    assert tres.inliers.numpy()[valid & ~out].mean() > 0.9
    assert tres.inliers.numpy()[out].mean() < 0.1

    # and after the refinement the caller runs
    isg = np.ones(len(X), np.float32)
    jopt = jpose.optimize_pose(jcam, jres.T, jnp.asarray(X), jnp.asarray(uv),
                               jnp.asarray(valid) & jres.inliers,
                               jnp.asarray(isg), jcfg.TrackerConfig())
    topt = tpose.optimize_pose(tcam, tres.T, tX, tuv, tvalid & tres.inliers,
                               torch.from_numpy(isg), tcfg.TrackerConfig())
    np.testing.assert_allclose(topt.T.numpy(), np.asarray(jopt.T), atol=1e-3)
    np.testing.assert_allclose(topt.T.numpy(), T_gt, atol=2e-2)
    assert int((topt.inliers.numpy() != np.asarray(jopt.inliers)).sum()) <= 5


def test_epnp_hypotheses_loosely(rng):
    X, uv, valid, _out, _T = _pnp_scenario(rng)
    samples = _jax_draws(jax.random.PRNGKey(1), valid, iters=128)
    uvn = np.stack([(uv[:, 0] - CAM["cx"]) / CAM["fx"],
                    (uv[:, 1] - CAM["cy"]) / CAM["fy"]], 1)
    jR, jt = jax.vmap(lambda i: jpnp._epnp_minimal(
        jnp.asarray(X)[i], jnp.asarray(uvn)[i]))(jnp.asarray(samples))
    tR, tt = tpnp._epnp_minimal(torch.from_numpy(X)[samples],
                                torch.from_numpy(uvn)[samples])
    assert tR.shape == (128, 3, 3) and tt.shape == (128, 3)
    d = np.abs(tR.numpy() - np.asarray(jR)).reshape(128, -1).max(1)
    assert np.median(d) <= 1e-2, np.median(d)

    def count(R, t):
        pc = X @ np.swapaxes(R, -1, -2) + t[:, None]
        e2 = ((pc[..., :2] / pc[..., 2:] * CAM["fx"]
               + [CAM["cx"], CAM["cy"]] - uv) ** 2).sum(-1)
        return (valid & (pc[..., 2] > 0) & (e2 < 5.991 * 4)).sum(-1)

    near = np.abs(count(tR.numpy(), tt.numpy())
                  - count(np.asarray(jR), np.asarray(jt))) <= 5
    assert near.mean() >= 0.9, near.mean()


def test_ransac_pnp_ties_and_degenerate_draws():
    """Every draw the same degenerate sample: every hypothesis scores alike,
    the first wins, nothing raises, no inlier is reported among invalid
    points; and draws from a generator with no valid point still come."""
    tcam = tcfg.CameraConfig(**CAM)
    g = np.random.default_rng(5)
    X = torch.from_numpy(g.uniform(1, 5, (50, 3)).astype(np.float32))
    uv = torch.from_numpy(g.uniform(0, 600, (50, 2)).astype(np.float32))
    valid = torch.zeros(50, dtype=torch.bool)
    res = tpnp.ransac_pnp(tcam, X, uv, valid,
                          torch.zeros((16, 6), dtype=torch.int64))
    assert res.T.shape == (4, 4) and int(res.n_inliers) == 0
    gen = torch.Generator().manual_seed(3)
    s = tpnp.draw_samples(valid, gen, iters=16)
    assert s.shape == (16, 6) and int(s.min()) >= 0 and int(s.max()) < 50
    valid[10:20] = True
    s = tpnp.draw_samples(valid, gen)
    assert s.shape == (tpnp.RANSAC_ITERS, 6)
    assert int(s.min()) >= 10 and int(s.max()) < 20
