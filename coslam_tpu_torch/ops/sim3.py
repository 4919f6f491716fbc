"""Sim3 estimation from 3D-3D correspondences: Horn closed form, RANSAC and
LM polish (port of coslam_tpu/ops/sim3.py, whole).

The reference Sim3Solver's sequential RANSAC loop (ORB_SLAM2/src/
Sim3Solver.cc: iterate :140, 3-point minimal sets, mutual-reprojection
inlier check :340) is one batch over all hypotheses, as in ops/pnp.py; the
closed form (ComputeSim3 :226, Horn 1987) is a batched `eigh`.  EPnP aligns
its camera-frame points with `horn_sim3` too.

RANSAC draws: the reference draws `jax.random.choice(key, n, (iters, 3),
p=valid / sum)`; here the (iters, 3) sample indices are an argument
(`samples`), or come from a `torch.Generator` by the same rule
(`twoview.draw_samples`: uniform over the valid pairs, over all pairs where
none is valid).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.utils import geometry as geo


class Sim3Result(NamedTuple):
    s: torch.Tensor        # () scale
    R: torch.Tensor        # (3, 3)
    t: torch.Tensor        # (3,)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def horn_sim3(x1, x2, w=None, fix_scale: bool = False):
    """Closed-form similarity x2 ~ s R x1 + t from paired points (..., n, 3).

    Horn's quaternion method: R from the dominant eigenvector of the 4x4 N
    matrix of the weighted correlation (a batched `eigh`; the eigenvector's
    sign is free and `quat_to_rot` does not see it), then the least-squares
    scale.  Returns (s (...), R (..., 3, 3), t (..., 3))."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    wn = w / (w.sum(-1, keepdim=True) + 1e-12)
    c1 = (x1 * wn[..., None]).sum(-2)
    c2 = (x2 * wn[..., None]).sum(-2)
    a = x1 - c1[..., None, :]
    b = x2 - c2[..., None, :]
    M = (a * wn[..., None]).transpose(-1, -2) @ b        # sum w a b^T
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, vecs = torch.linalg.eigh(N)
    R = geo.quat_to_rot(vecs[..., :, 3])   # largest eigenvalue: (w, x, y, z)
    Ra = a @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones(M.shape[:-2], dtype=x1.dtype, device=x1.device)
    else:
        s = (wn * (b * Ra).sum(-1)).sum(-1) / (
            (wn * (Ra * Ra).sum(-1)).sum(-1) + 1e-12)
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return s, R, t


def _project(cam: CameraConfig, pts):
    pz = pts[..., 2]
    z = torch.where(pz.abs() < 1e-6, 1e-6, pz)
    return torch.stack([pts[..., 0] / z * cam.fx + cam.cx,
                        pts[..., 1] / z * cam.fy + cam.cy], -1)


def ransac_sim3(cam: CameraConfig, x1c, x2c, uv1, uv2, iters: int = 300,
                fix_scale: bool = False, valid=None, samples=None,
                generator: Optional[torch.Generator] = None,
                chi2_th: float = 10.0) -> Sim3Result:
    """RANSAC Sim3 between two keyframes' matched landmarks.

    x1c, x2c: (N, 3) matched points in each keyframe's *camera* frame;
    uv1, uv2: their observed pixels; samples: (iters, 3) indices of the
    minimal sets (drawn from `generator` when absent).  Inlier check mirrors
    Sim3Solver::CheckInliers (Sim3Solver.cc:340): mutual reprojection error
    in both frames under (S21, S21^-1) below chi2_th px^2."""
    n = x1c.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=x1c.device)
    if samples is None:
        from coslam_tpu_torch.ops import twoview
        samples = twoview.draw_samples(valid, iters, generator, size=3)
    samples = samples.long()

    def score(s, R, t):
        """(..., N) inlier mask for batched (s (...), R (..., 3, 3),
        t (..., 3))."""
        x2_pred = s[..., None, None] * (x1c @ R.transpose(-1, -2)) \
            + t[..., None, :]
        x1_pred = ((x2c - t[..., None, :]) @ R) \
            / torch.clamp(s, min=1e-9)[..., None, None]
        e2 = ((_project(cam, x2_pred) - uv2) ** 2).sum(-1)
        e1 = ((_project(cam, x1_pred) - uv1) ** 2).sum(-1)
        # cheirality: a mapped point must sit in FRONT of the target
        # camera — negative-depth projections can accidentally land near
        # observed pixels and "verify" a mirrored/degenerate similarity
        return valid & (e1 < chi2_th) & (e2 < chi2_th) \
            & (x2_pred[..., 2] > 0.0) & (x1_pred[..., 2] > 0.0)

    ss, Rs, ts = horn_sim3(x1c[samples], x2c[samples], fix_scale=fix_scale)
    # a minimal set of near-coincident points yields an arbitrary (often
    # enormous) scale whose reprojections can still pass the chi2 gate when
    # translation is small relative to scene depth — such hypotheses must
    # not win the vote
    s_ok = (ss > 1.0 / 16.0) & (ss < 16.0)
    counts = torch.where(s_ok, score(ss, Rs, ts).sum(-1), -1)
    best = torch.argmax(counts).reshape(1)      # first index among ties
    s = ss.index_select(0, best)[0]
    R = Rs.index_select(0, best)[0]
    t = ts.index_select(0, best)[0]
    ok = score(s, R, t)
    # refine on all inliers (one weighted Horn pass, then re-classify)
    s2, R2, t2 = horn_sim3(x1c, x2c, w=ok.to(torch.float32),
                           fix_scale=fix_scale)
    ok2 = score(s2, R2, t2)
    better = ok2.sum() >= ok.sum()
    s = torch.where(better, s2, s)
    R = torch.where(better, R2, R)
    t = torch.where(better, t2, t)
    ok = torch.where(better, ok2, ok)
    # iterative LM refinement with forward+inverse projection edge pairs and
    # inlier pruning between rounds (reference Optimizer::OptimizeSim3,
    # Optimizer.cc:1046: 5 its -> prune -> 10 its) — the marginal loop
    # candidates depend on this polish
    s, R, t, ok = refine_sim3(cam, x1c, x2c, uv1, uv2, s, R, t, ok,
                              fix_scale=fix_scale, chi2_th=chi2_th)
    return Sim3Result(s=s, R=R, t=t, inliers=ok, n_inliers=ok.sum())


def sim3_residuals(cam: CameraConfig, x1c, x2c, uv1, uv2, delta, s, R, t,
                   fix_scale: bool = False):
    """(N, 4) reprojection residuals [r1 | r2] of both directions under the
    perturbed similarity R <- exp(delta[:3]) R, t <- t + delta[3:6],
    s <- s * exp(delta[6]); delta is (1, 7) (see geo.jacfwd_rows)."""
    Rn = geo.exp_so3(delta[:, :3])[0] @ R
    tn = t + delta[0, 3:6]
    sn = s.reshape(1) * (1.0 if fix_scale else torch.exp(delta[:, 6]))
    x2_pred = sn * (x1c @ Rn.T) + tn
    x1_pred = ((x2c - tn) @ Rn) / torch.clamp(sn, min=1e-9)
    r2 = _project(cam, x2_pred) - uv2
    r1 = _project(cam, x1_pred) - uv1
    return torch.cat([r1, r2], -1)


def sim3_residuals_jac(cam: CameraConfig, x1c, x2c, uv1, uv2, s, R, t,
                       fix_scale: bool = False):
    """(r (N, 4), J (N, 4, 7)): `sim3_residuals` at delta = 0 and its
    Jacobian there, in closed form.  It is what forward mode gives through
    the same code, branch for branch (tests hold it to `jax.jacfwd`):
    d exp(omega) = hat(d omega) at 0, a depth clamped by `_project` carries
    no tangent, nor does a scale at its floor, nor sigma when the scale is
    fixed.  With a = s R x1 and q = x2 - t:
        d x2_pred = [-hat(a) | I | a],  d x1_pred = [R^T hat(q) / s | -R^T / s
        | -x1_pred]."""
    a = s * (x1c @ R.T)
    q = x2c - t
    sc = torch.clamp(s, min=1e-9)
    x2_pred = a + t
    x1_pred = (q @ R) / sc
    eye = torch.eye(3, dtype=x1c.dtype, device=x1c.device).expand(
        x1c.shape[0], 3, 3)
    sig_on = 0.0 if fix_scale else 1.0
    d2 = torch.cat([-geo.hat(a), eye, (sig_on * a)[..., None]], -1)
    live = (s > 1e-9).to(x1c.dtype) * sig_on
    d1 = torch.cat([(R.T @ geo.hat(q)) / sc, (-R.T / sc).expand(eye.shape),
                    (-live * x1_pred)[..., None]], -1)     # (N, 3, 7)

    def proj_jac(pts):
        pz = pts[:, 2]
        clamped = pz.abs() < 1e-6
        z = torch.where(clamped, 1e-6, pz)
        dz = torch.where(clamped, 0.0, 1.0)
        zero = torch.zeros_like(z)
        return torch.stack([
            torch.stack([cam.fx / z, zero, -cam.fx * pts[:, 0] / (z * z) * dz],
                        -1),
            torch.stack([zero, cam.fy / z, -cam.fy * pts[:, 1] / (z * z) * dz],
                        -1)], -2)                          # (N, 2, 3)

    r = torch.cat([_project(cam, x1_pred) - uv1,
                   _project(cam, x2_pred) - uv2], -1)
    J = torch.cat([proj_jac(x1_pred) @ d1, proj_jac(x2_pred) @ d2], -2)
    return r, J


def refine_sim3(cam: CameraConfig, x1c, x2c, uv1, uv2, s0, R0, t0, valid,
                fix_scale: bool = False, chi2_th: float = 10.0,
                iters1: int = 5, iters2: int = 10):
    """LM polish of a Sim3 S21 over matched pairs (`refine_sim3_plain`):
    for CUDA tensors one launch of kernel K4 (`ck.sim3_refine_lm`), for CPU
    tensors the plain version.  Returns (s, R, t, inliers)."""
    if not ck._on_cuda("sim3_refine_lm", x1c, x2c, uv1, uv2, s0, R0, t0,
                       valid):
        return refine_sim3_plain(cam, x1c, x2c, uv1, uv2, s0, R0, t0, valid,
                                 fix_scale, chi2_th, iters1, iters2)
    return ck.sim3_refine_lm(x1c, x2c, uv1, uv2, s0, R0, t0, valid,
                             fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                             fix_scale=fix_scale, chi2_th=chi2_th,
                             iters1=iters1, iters2=iters2)


def refine_sim3_plain(cam: CameraConfig, x1c, x2c, uv1, uv2, s0, R0, t0,
                      valid, fix_scale: bool = False, chi2_th: float = 10.0,
                      iters1: int = 5, iters2: int = 10):
    """Levenberg-Marquardt polish of a Sim3 S21 over matched camera-frame
    landmark pairs, minimizing BOTH projection directions (the reference's
    EdgeSim3ProjectXYZ + EdgeInverseSim3ProjectXYZ pairs, Optimizer.cc:
    1094-1133) with Huber robustification; outliers are pruned after the
    first round and the remainder re-optimized (Optimizer.cc:1149-1177).

    Parameterization: delta = (omega, nu, sigma) applied as
    R <- exp(omega) R,  t <- t + nu,  s <- s * exp(sigma) (sigma frozen when
    fix_scale).  The reference takes the Jacobian by forward-mode autodiff
    at delta = 0; `sim3_residuals_jac` is that Jacobian in closed form (a
    tenth of the kernel launches of `geo.jacfwd_rows` over the residual).
    Accept/reject is `where`-masked: no value is read back to the host."""
    delta_huber2 = chi2_th  # Huber at the chi2 threshold (deltaHuber^2)
    dev = x1c.device
    f32 = torch.float32
    z7 = torch.zeros((1, 7), dtype=f32, device=dev)
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def residuals(delta, s, R, t):
        return sim3_residuals(cam, x1c, x2c, uv1, uv2, delta, s, R, t,
                              fix_scale)

    def lm_rounds(s, R, t, w_in, n_iters):
        lam = torch.full((), 1e-3, dtype=f32, device=dev)
        for _ in range(n_iters):
            r, J = sim3_residuals_jac(cam, x1c, x2c, uv1, uv2, s, R, t,
                                      fix_scale)       # (N, 4), (N, 4, 7)
            chi2 = (r * r).sum(-1)
            wrob = torch.where(
                chi2 > delta_huber2,
                torch.sqrt(delta_huber2 / torch.clamp(chi2, min=1e-12)),
                1.0) * w_in
            Jw = J * wrob[:, None, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            g = torch.einsum("nij,ni->j", Jw, r)
            H = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-6))
            if fix_scale:
                keep = torch.ones(7, dtype=f32, device=dev)
                keep[6] = 0.0
                H = H * keep[:, None] * keep[None, :] \
                    + torch.diag(1.0 - keep)
                g = g * keep
            d = -torch.linalg.solve_ex(H + 1e-9 * eye7, g[:, None])[0][:, 0]
            r_new = residuals(d[None], s, R, t)
            c_old = (wrob * chi2).sum()
            c_new = (wrob * (r_new * r_new).sum(-1)).sum()
            accept = c_new < c_old
            if not fix_scale:
                s = torch.where(accept, s * torch.exp(d[6]), s)
            R = torch.where(accept, geo.exp_so3(d[:3]) @ R, R)
            t = torch.where(accept, t + d[3:6], t)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-6, 1e4)
        return s, R, t

    def gate(s, R, t):
        r = residuals(z7, s, R, t)
        return valid & ((r[:, :2] ** 2).sum(-1) < chi2_th) \
            & ((r[:, 2:] ** 2).sum(-1) < chi2_th)

    s, R, t = lm_rounds(s0, R0, t0, valid.to(f32), iters1)
    # prune: mutual reprojection gate at the current estimate
    ok = gate(s, R, t)
    s, R, t = lm_rounds(s, R, t, ok.to(f32), iters2)
    return s, R, t, gate(s, R, t)
