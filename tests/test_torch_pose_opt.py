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


def _lm_recomputing(T_init, X, uv, isg, *, fx, fy, cx, cy, rounds, iters,
                    chi2_th):
    """The two-pass form of the kernel's LM: every step linearises anew at
    the current pose and evaluates the cost at the trial pose in a second
    pass (the form of the Pallas kernel body).  Returns the per-step trace
    [(P, lam, improved)]."""
    delta = float(np.sqrt(chi2_th))
    valid = isg > 0
    U, V = uv[:, 0], uv[:, 1]

    def resid(P):
        pc = X @ P[:, :3].T + P[:, 3]
        pcx, pcy, pcz = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = torch.where(pcz.abs() < 1e-6, torch.full_like(pcz, 1e-6), pcz)
        iz = 1.0 / zs
        ru = fx * pcx * iz + cx - U
        rv = fy * pcy * iz + cy - V
        return pcx, pcy, iz, ru, rv, pcz <= 0.05, (ru * ru + rv * rv) * isg

    def robust_per(chi2, robust):
        if not robust:
            return chi2
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        return torch.where(e > delta, delta * (2.0 * e - delta), chi2)

    trace = []
    P = T_init[:3, :4].to(torch.float32)
    active = valid
    for rnd in range(rounds):
        robust = rnd < 2
        lam = torch.tensor(1e-3, dtype=torch.float32)
        for _ in range(iters):
            pcx, pcy, iz, ru, rv, behind, chi2 = resid(P)
            ok = active & ~behind
            e = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_rob = torch.where(e > delta, delta / e, 1.0) if robust \
                else torch.ones_like(e)
            w = torch.where(ok, isg * w_rob, 0.0)
            cost = torch.where(ok, robust_per(chi2, robust), 0.0).sum()
            iz2 = iz * iz
            zero = torch.zeros_like(iz)
            Ju = torch.stack([fx * iz, zero, -fx * pcx * iz2,
                              -fx * pcx * pcy * iz2,
                              fx * (1.0 + pcx * pcx * iz2), -fx * pcy * iz], 1)
            Jv = torch.stack([zero, fy * iz, -fy * pcy * iz2,
                              -fy * (1.0 + pcy * pcy * iz2),
                              fy * pcx * pcy * iz2, fy * pcx * iz], 1)
            H = (Ju * w[:, None]).T @ Ju + (Jv * w[:, None]).T @ Jv
            b = (Ju * (w * ru)[:, None]).sum(0) \
                + (Jv * (w * rv)[:, None]).sum(0)
            diag = torch.arange(6)
            H[diag, diag] = torch.diagonal(H) * (1.0 + lam) + 1e-9
            dx = -ck.chol_solve6(H, b)
            Rd, td = ck._exp_se3_twist(dx)
            Pn = Rd @ P
            Pn = torch.cat([Pn[:, :3], (Pn[:, 3] + td)[:, None]], 1)
            _, _, _, _, _, behind_n, chi2_n = resid(Pn)
            cost_n = torch.where(active & ~behind_n,
                                 robust_per(chi2_n, robust), 0.0).sum()
            improved = cost_n < cost
            P = torch.where(improved, Pn, P)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                              1e-6, 1e3)
            trace.append((P, lam, improved))
        _, _, _, _, _, behind, chi2 = resid(P)
        active = valid & ~behind & (chi2 < chi2_th)
    return trace, active


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_carried_linearisation_equals_recomputing_form(seed):
    """One pass per LM step (H, b and cost carried over an accepted step,
    kept over a rejected one) takes the same 40 steps as linearising anew
    every step: pose within 1e-6, damping and accept decisions equal."""
    rng = np.random.default_rng(100 + seed)
    n = 300 + 100 * seed
    X, uv, isg, valid, _, _ = _problem(rng, n, n_out=40)
    isg_m = torch.from_numpy(np.where(valid, isg, 0).astype(np.float32))
    cfg = tcfg.TrackerConfig()
    kw = dict(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"],
              rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters,
              chi2_th=cfg.chi2_mono)
    args = (torch.eye(4), torch.from_numpy(X), torch.from_numpy(uv), isg_m)
    carried = []
    T, inl = ck.pose_opt_lm_plain(*args, **kw, trace=carried)
    recomputed, inl_r = _lm_recomputing(*args, **kw)
    assert len(carried) == len(recomputed) == 40
    for (Pc, lc, ic), (Pr, lr, ir) in zip(carried, recomputed):
        np.testing.assert_allclose(Pc.numpy(), Pr.numpy(), atol=1e-6, rtol=0)
        assert float(lc) == float(lr)
        assert bool(ic) == bool(ir)
    accepted = sum(bool(i) for _, _, i in carried)
    assert 0 < accepted < 40          # both branches were taken
    np.testing.assert_array_equal(inl.numpy(), inl_r.numpy())
    np.testing.assert_allclose(T[:3].numpy(), carried[-1][0].numpy(), atol=0)
