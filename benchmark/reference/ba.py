"""Windowed local bundle adjustment (what the keyframe backend's
`solve_dense` computes): `iters` Levenberg-Marquardt steps over the
window's poses and points, Huber-robust, the 3x3 point blocks eliminated
by a Schur complement and the reduced camera system solved by Cholesky,
fixed keyframes held, a step kept only where it lowers the robust cost.
A copy of the program's plain formulation, computed in float64 (the check)
or with every stage rounded to bfloat16 (the control; torch factorises
nothing in bfloat16, so the Cholesky runs in float32 on rounded input).

It follows the program from the program's own state: the problem is the
call's input, as the program built it from its map."""

from __future__ import annotations

import torch

EPS = 1e-12


def rounder(dtype):
    """(working dtype, rounding after each stage) for a reference dtype."""
    if dtype == torch.bfloat16:
        return torch.float32, lambda x: x.to(torch.bfloat16).to(torch.float32)
    return dtype, lambda x: x


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def exp_se3(xi):
    """(..., 6) twist [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t2 = (phi * phi).sum(-1)
    th = torch.sqrt(t2 + EPS)
    small = t2 < 1e-8
    W = hat(phi)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / (t2 + EPS))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - a) / (t2 + EPS))
    WW = W @ W
    R = I + a[..., None, None] * W + b[..., None, None] * WW
    V = I + b[..., None, None] * W + c[..., None, None] * WW
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def inv3(M):
    """Batched closed-form 3x3 inverse, the determinant held off zero."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < EPS, torch.full_like(det, EPS), det)
    inv = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return inv / det[..., None, None]


def project(fx, fy, cx, cy, poses, points, kf, pt):
    """(uv (O, 2), depth (O,)) of each observation's point in its
    keyframe."""
    T = poses[kf]
    pc = torch.einsum("oij,oj->oi", T[:, :3, :3], points[pt]) + T[:, :3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.stack([pc[:, 0] / zs * fx + cx, pc[:, 1] / zs * fy + cy],
                       1), z


def solve(cam, prob, iters: int = 10, chi2_th: float = 5.991,
          robust: bool = True, dtype=torch.float64):
    """(poses (K, 4, 4), points (P, 3)) after `iters` LM steps."""
    work, q = rounder(dtype)
    fx, fy, cx, cy = (float(getattr(cam, k)) for k in ("fx", "fy", "cx",
                                                       "cy"))
    K, P = prob.poses.shape[0], prob.points.shape[0]
    dev = prob.points.device
    kf, pt = prob.obs_kf.long(), prob.obs_pt.long()
    uv = q(prob.obs_uv.to(work))
    w_obs = q(prob.obs_w.to(work))
    valid = prob.obs_valid.bool()
    free = ~prob.kf_fixed.bool()
    delta = chi2_th ** 0.5

    def residuals(poses, points):
        T = poses[kf]
        R = T[:, :3, :3]
        pc = q(torch.einsum("oij,oj->oi", R, points[pt]) + T[:, :3, 3])
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        iz = 1.0 / zs
        r = q(torch.stack([x * iz * fx + cx, y * iz * fy + cy], 1) - uv)
        iz2 = iz * iz
        zero = torch.zeros_like(z)
        Juv = q(torch.stack([torch.stack([fx * iz, zero, -fx * x * iz2], 1),
                             torch.stack([zero, fy * iz, -fy * y * iz2], 1)],
                            1))
        Jc = q(torch.cat([Juv, -torch.einsum("oij,ojk->oik", Juv, hat(pc))],
                         2))
        Jp = q(torch.einsum("oij,ojk->oik", Juv, R))
        return r, Jc, Jp, z <= 0.05

    def robust_parts(chi2):
        e = torch.sqrt(torch.clamp(chi2, min=EPS))
        over = (chi2 > chi2_th) & robust
        return (torch.where(over, delta / e, torch.ones_like(e)),
                torch.where(over, delta * (2 * e - delta), chi2))

    def cost(poses, points):
        r, _, _, behind = residuals(poses, points)
        chi2 = (r * r).sum(1) * w_obs
        ok = valid & ~behind
        return torch.where(ok, robust_parts(chi2)[1],
                           torch.zeros_like(chi2)).sum()

    def seg(x, idx, n):
        out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=dev)
        return q(out.index_add(0, idx, x))

    poses = q(prob.poses.to(work))
    points = q(prob.points.to(work))
    lam = torch.tensor(1e-4, dtype=work, device=dev)
    free6 = free.repeat_interleave(6)
    eye = torch.eye(6 * K, dtype=work, device=dev)
    for _ in range(iters):
        r, Jc, Jp, behind = residuals(poses, points)
        chi2 = (r * r).sum(1) * w_obs
        ok = valid & ~behind
        w = torch.where(ok, w_obs * robust_parts(chi2)[0],
                        torch.zeros_like(chi2))
        Jcw, Jpw = q(Jc * w[:, None, None]), q(Jp * w[:, None, None])
        Hcc = seg(torch.einsum("oij,oik->ojk", Jcw, Jc), kf, K)
        Hpp = seg(torch.einsum("oij,oik->ojk", Jpw, Jp), pt, P)
        bc = seg(torch.einsum("oij,oi->oj", Jcw, r), kf, K)
        bp = seg(torch.einsum("oij,oi->oj", Jpw, r), pt, P)
        lamc = lam * torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6)
        lamp = lam * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
        Hpp_inv = q(inv3(Hpp + torch.diag_embed(lamp)))
        Y = seg(torch.einsum("oij,oik->ojk", Jcw, Jp), kf * P + pt, K * P) \
            .reshape(K, P, 6, 3)
        YH = q(torch.einsum("kpij,pjl->kpil", Y, Hpp_inv))
        S = -(YH.permute(0, 2, 1, 3).reshape(6 * K, 3 * P)
              @ Y.permute(0, 2, 1, 3).reshape(6 * K, 3 * P).T)
        S = q(S + torch.block_diag(*(Hcc + torch.diag_embed(lamc)).unbind(0)))
        g = q(-bc + torch.einsum("kpij,pj->ki", YH, bp))
        S = torch.where(free6[:, None] & free6[None, :], S, eye)
        g = torch.where(free6, g.reshape(-1), torch.zeros_like(g.reshape(-1)))
        L, info = torch.linalg.cholesky_ex(S + 1e-8 * eye)
        dc = torch.cholesky_solve(g[:, None], L)[:, 0].reshape(K, 6)
        # a system that is not positive definite gives a NaN step, which
        # the cost test rejects
        dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
        dc = q(torch.where(free[:, None], dc, torch.zeros_like(dc)))
        dp = q(torch.einsum("pij,pj->pi", Hpp_inv,
                            -bp - torch.einsum("kpij,ki->pj", Y, dc)))
        poses_new = q(exp_se3(dc) @ poses)
        points_new = q(points + dp)
        accept = cost(poses_new, points_new) < cost(poses, points)
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0), 1e-8,
                          1e4)
    return poses, points


def cost(cam, prob, poses, points, chi2_th: float = 5.991) -> float:
    """The robust cost the LM minimises, in float64, of (poses, points) on
    the call's observations."""
    f = tuple(float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy"))
    uv, z = project(*f, poses.to(torch.float64), points.to(torch.float64),
                    prob.obs_kf.long(), prob.obs_pt.long())
    r = uv - prob.obs_uv.to(torch.float64)
    chi2 = (r * r).sum(1) * prob.obs_w.to(torch.float64)
    e = torch.sqrt(torch.clamp(chi2, min=EPS))
    d = chi2_th ** 0.5
    per = torch.where(chi2 > chi2_th, d * (2 * e - d), chi2)
    ok = prob.obs_valid.bool() & (z > 0.05)
    return float(torch.where(ok, per, torch.zeros_like(per)).sum())


def cost_excess_pct(call: dict, dtype=torch.float64, against=None) -> float:
    """How far, in percent of the reference's, the robust cost of the
    program's solution lies above that of the reference's solution from
    the same start (negative where the program's is lower).  A cost and
    not the positions: a point seen at low parallax moves along its ray
    at almost no cost, so two sound solutions may place it far apart.
    `against` replaces the program's (poses, points); the control passes
    its own."""
    cam, prob = call["args"][:2]
    kw = call["kw"]
    poses_ref, points_ref = solve(cam, prob, dtype=dtype, **kw)
    if against is None:
        poses_p, points_p = call["out"].poses, call["out"].points
    else:
        poses_p, points_p = against
    th = kw.get("chi2_th", 5.991)
    ref = cost(cam, prob, poses_ref, points_ref, th)
    return 100.0 * (cost(cam, prob, poses_p, points_p, th) - ref) \
        / max(ref, 1e-9)
