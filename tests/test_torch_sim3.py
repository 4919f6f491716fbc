"""Port Sim3 RANSAC and LM polish against coslam_tpu on the same inputs.

The draws are injected: the JAX side's `jax.random.choice` indices are
recomputed here with the same key and handed to the port.  Single
hypotheses go through a 4x4 `eigh` on a rank-deficient matrix (3 points) and
may differ between LAPACK builds; the refined winner is held tightly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.config import CameraConfig as JCam
from coslam_tpu.ops import sim3 as jsim3
from coslam_tpu.utils import geometry as jgeo
from coslam_tpu_torch.config import CameraConfig as TCam
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops import sim3 as tsim3
from coslam_tpu_torch.utils import kernel_cases as kc

KW = dict(fx=450, fy=450, cx=320, cy=240, width=640, height=480)
JC, TC = JCam(**KW), TCam(**KW)


def _problem(rng, n=200, outliers=0.3):
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], 1).astype(np.float32)
    s_gt = 1.4
    R_gt = np.asarray(jgeo.exp_so3(jnp.asarray([0.1, -0.2, 0.15],
                                               jnp.float32)))
    t_gt = np.array([0.5, -0.3, 0.8], np.float32)
    X2 = (s_gt * X1 @ R_gt.T + t_gt).astype(np.float32)
    bad = rng.random(n) < outliers
    X2[bad] += rng.uniform(1, 3, (bad.sum(), 3)).astype(np.float32)

    def proj(X):
        return np.stack([X[:, 0] / X[:, 2] * KW["fx"] + KW["cx"],
                         X[:, 1] / X[:, 2] * KW["fy"] + KW["cy"]],
                        1).astype(np.float32)

    # pixel noise, so that the polish has something to do
    uv1 = proj(X1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    uv2 = proj(s_gt * X1 @ R_gt.T + t_gt) \
        + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return X1, X2, uv1, uv2, valid, bad, (s_gt, R_gt, t_gt)


def _t(*a):
    return [torch.tensor(x) for x in a]


def test_ransac_sim3_with_outliers(rng):
    """30 % wrong pairs, injected draws: the same inlier set to within 2
    pairs, s / R / t within 1e-3."""
    X1, X2, uv1, uv2, valid, bad, (s_gt, R_gt, _) = _problem(rng)
    key = jax.random.PRNGKey(1)
    p = valid.astype(np.float32)
    p = jnp.asarray(p) / (jnp.asarray(p).sum() + 1e-9)
    draws = np.asarray(jax.random.choice(key, X1.shape[0], shape=(300, 3),
                                         replace=True, p=p))
    jres = jsim3.ransac_sim3(JC, *[jnp.asarray(a) for a in (X1, X2, uv1, uv2)],
                             300, False, valid=jnp.asarray(valid), key=key,
                             chi2_th=9.21)
    tres = tsim3.ransac_sim3(TC, *_t(X1, X2, uv1, uv2), 300, False,
                             valid=torch.tensor(valid),
                             samples=torch.tensor(draws), chi2_th=9.21)
    assert abs(float(jres.s) - s_gt) < 0.02       # the problem is solvable
    jin, tin = np.asarray(jres.inliers), tres.inliers.numpy()
    assert int(jres.n_inliers) > 100
    assert (jin != tin).sum() <= 2
    assert int(tres.n_inliers) == tin.sum()
    assert abs(float(tres.s) - float(jres.s)) < 1e-3
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-3)
    assert not tin[~valid].any()


def test_ransac_sim3_draws_from_generator(rng):
    """Without injected draws the generator's own recover the similarity,
    and the same seed gives the same answer."""
    X1, X2, uv1, uv2, valid, bad, (s_gt, R_gt, _) = _problem(rng)
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        out.append(tsim3.ransac_sim3(TC, *_t(X1, X2, uv1, uv2), 300, False,
                                     valid=torch.tensor(valid), generator=g))
    assert abs(float(out[0].s) - s_gt) < 0.02
    np.testing.assert_allclose(out[0].R.numpy(), R_gt, atol=5e-3)
    assert torch.equal(out[0].inliers, out[1].inliers)
    inl = out[0].inliers.numpy()
    assert inl[~bad & valid].mean() > 0.9 and inl[bad].mean() < 0.1


def _start(rng):
    s0 = np.float32(1.3)
    R0 = np.asarray(jgeo.exp_so3(jnp.asarray([0.12, -0.17, 0.13],
                                             jnp.float32)))
    t0 = np.array([0.45, -0.25, 0.7], np.float32)
    return s0, R0, t0


def test_refine_sim3(rng):
    """The LM polish from a perturbed start: s / R / t within 1e-4 of the
    JAX result, the same pruned inlier mask (within 1 pair at the gate)."""
    X1, X2, uv1, uv2, valid, bad, (s_gt, _, _) = _problem(rng, outliers=0.1)
    s0, R0, t0 = _start(rng)
    js, jR, jt, jok = jsim3.refine_sim3(
        JC, *[jnp.asarray(a) for a in (X1, X2, uv1, uv2)], jnp.asarray(s0),
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(valid), chi2_th=9.21)
    ts, tR, tt, tok = tsim3.refine_sim3(
        TC, *_t(X1, X2, uv1, uv2), torch.tensor(s0), torch.tensor(R0),
        torch.tensor(t0), torch.tensor(valid), chi2_th=9.21)
    assert abs(float(js) - s_gt) < 0.01           # the polish converged
    assert abs(float(ts) - float(js)) < 1e-4
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert (tok.numpy() != np.asarray(jok)).sum() <= 1


def test_refine_sim3_fixed_scale(rng):
    """fix_scale freezes sigma: the scale stays, R / t agree to 1e-4."""
    X1, X2, uv1, uv2, valid, bad, _ = _problem(rng, outliers=0.0)
    s0, R0, t0 = _start(rng)
    s0 = np.float32(1.4)
    js, jR, jt, _ = jsim3.refine_sim3(
        JC, *[jnp.asarray(a) for a in (X1, X2, uv1, uv2)], jnp.asarray(s0),
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(valid), fix_scale=True)
    ts, tR, tt, _ = tsim3.refine_sim3(
        TC, *_t(X1, X2, uv1, uv2), torch.tensor(s0), torch.tensor(R0),
        torch.tensor(t0), torch.tensor(valid), fix_scale=True)
    assert float(ts) == float(s0) == float(js)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_residual_jacobian_matches_jacfwd(rng, fix_scale):
    """The per-pair (4, 7) Jacobian of the polish's residual at delta = 0 —
    the closed form the polish uses, and torch's forward mode through the
    residual — against `jax.jacfwd` of the same residual, relative 1e-4.
    One pair sits at a clamped depth, where the depth carries no tangent."""
    X1, X2, uv1, uv2, valid, bad, _ = _problem(rng, n=64, outliers=0.0)
    s0, R0, t0 = _start(rng)
    X1[3] = (R0.T @ (np.array([0.2, 0.1, 0.0], np.float32) - t0)) / s0

    def jres(delta, s, R, t):
        dR = jgeo.exp_so3(delta[:3])
        Rn = dR @ R
        tn = t + delta[3:6]
        sn = s * (1.0 if fix_scale else jnp.exp(delta[6]))
        x2p = sn * jnp.einsum("ij,nj->ni", Rn, X1) + tn
        x1p = jnp.einsum("ji,nj->ni", Rn, X2 - tn) / jnp.maximum(sn, 1e-9)

        def project(pts):
            z = jnp.where(jnp.abs(pts[..., 2]) < 1e-6, 1e-6, pts[..., 2])
            return jnp.stack([pts[..., 0] / z * JC.fx + JC.cx,
                              pts[..., 1] / z * JC.fy + JC.cy], -1)
        return jnp.concatenate([project(x1p) - uv1, project(x2p) - uv2], -1)

    with jax.default_matmul_precision("highest"):
        Jj = np.asarray(jax.jacfwd(jres)(jnp.zeros(7, jnp.float32),
                                         jnp.asarray(s0), jnp.asarray(R0),
                                         jnp.asarray(t0)))
    args = _t(X1, X2, uv1, uv2)
    sRt = _t(s0, R0, t0)
    Jt = torch.func.jacfwd(
        lambda d: tsim3.sim3_residuals(TC, *args, d[None], *sRt, fix_scale)
    )(torch.zeros(7)).numpy()
    r, Jc = tsim3.sim3_residuals_jac(TC, *args, *sRt, fix_scale)
    assert Jj.shape == Jt.shape == tuple(Jc.shape) == (64, 4, 7)
    # the clamped pair's depth column is dead in all three, the others' not
    x2p = s0 * X1 @ R0.T + t0
    assert abs(x2p[3, 2]) < 1e-6 and (np.abs(x2p[:, 2]) > 1e-2).sum() == 63
    ok = np.arange(64) != 3      # 1e6-px residuals there: compared apart
    for J in (Jt, Jc.numpy()):
        np.testing.assert_allclose(J[ok], Jj[ok], rtol=1e-4,
                                   atol=1e-4 * np.abs(Jj[ok]).max())
        np.testing.assert_allclose(J[3], Jj[3], rtol=1e-3,
                                   atol=1e-3 * np.abs(Jj[3]).max())
    assert (Jc.numpy()[:, :, 6] == 0).all() == fix_scale
    np.testing.assert_allclose(
        r.numpy(), tsim3.sim3_residuals(TC, *args, torch.zeros(1, 7), *sRt,
                                        fix_scale).numpy(), atol=1e-4)


@pytest.mark.parametrize("case", [2, 3, 6])
def test_refine_sim3_cpu_takes_the_plain_version(case):
    """On CPU tensors `refine_sim3` is its plain version, bit for bit, and
    launches no kernel (K4, `ck.sim3_refine_lm`, is for CUDA tensors; its
    card test is in tests/test_torch_cuda_kernels.py)."""
    name, n, n_valid, fix_scale, s_gt = kc.SIM3_CASES[case]
    cam, args, kw = kc.sim3_inputs(np.random.default_rng([kc.SIM3_SEED, case]),
                                   "cpu", n, n_valid, fix_scale, s_gt)
    before = dict(ck.LAUNCHES)
    got = tsim3.refine_sim3(cam, *args, **kw)
    assert ck.LAUNCHES == before
    ref = tsim3.refine_sim3_plain(cam, *args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # the case's polish has work to do and keeps the gate's pairs
    err, far, n_diff = kc.sim3_gaps(tsim3, cam, args, kw, got, ref)
    assert err == 0.0 and far == n_diff == 0
    assert float((got[2] - args[6]).abs().max()) > 1e-3
    assert 0 < int(got[3].sum()) <= n_valid
    assert not bool(got[3][~args[7]].any())


def test_sim3_refine_lm_rejects_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: the dispatch is
    `refine_sim3`'s, with no fallback inside the wrapper."""
    cam, args, kw = kc.sim3_inputs(np.random.default_rng(0), "cpu", 64, 20)
    before = dict(ck.LAUNCHES)
    with pytest.raises(ValueError, match="refine_sim3_plain"):
        ck.sim3_refine_lm(*args, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                          iters1=5, iters2=10, **kw)
    assert ck.LAUNCHES == before
