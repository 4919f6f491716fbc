"""The Sim3 polish (what `refine_sim3` computes for every Sim3 that loop
closing verifies): Levenberg-Marquardt on the reprojection errors of
matched landmark pairs in both directions under S21, Huber-robust at the
gate, five steps, the pairs pruned by the mutual gate, ten more steps.  A copy of the program's plain formulation with its
closed-form Jacobian, computed in float64 (the check) or with every stage
rounded to bfloat16 (the control; the 7x7 solve in float32 on rounded
input).

It follows the program from the program's own state: the pairs and the
starting Sim3 are the call's input, as the program made them."""

from __future__ import annotations

import torch

from benchmark.reference.ba import EPS, hat, rounder


def exp_so3(w):
    t2 = (w * w).sum(-1)
    th = torch.sqrt(t2 + EPS)
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / (t2 + EPS))
    W = hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _project(cam, pts):
    pz = pts[..., 2]
    z = torch.where(pz.abs() < 1e-6, torch.full_like(pz, 1e-6), pz)
    return torch.stack([pts[..., 0] / z * cam.fx + cam.cx,
                        pts[..., 1] / z * cam.fy + cam.cy], -1)


def _residuals(cam, x1c, x2c, uv1, uv2, s, R, t):
    """(N, 4) [r1 | r2]: x1 mapped back through S21^-1 into image 1, x1
    through S21 into image 2."""
    x2_pred = s * (x1c @ R.T) + t
    x1_pred = ((x2c - t) @ R) / torch.clamp(s, min=1e-9)
    return torch.cat([_project(cam, x1_pred) - uv1,
                      _project(cam, x2_pred) - uv2], -1)


def _residuals_jac(cam, x1c, x2c, uv1, uv2, s, R, t, fix_scale):
    a = s * (x1c @ R.T)
    qv = x2c - t
    sc = torch.clamp(s, min=1e-9)
    x2_pred = a + t
    x1_pred = (qv @ R) / sc
    eye = torch.eye(3, dtype=x1c.dtype, device=x1c.device).expand(
        x1c.shape[0], 3, 3)
    sig_on = 0.0 if fix_scale else 1.0
    d2 = torch.cat([-hat(a), eye, (sig_on * a)[..., None]], -1)
    live = (s > 1e-9).to(x1c.dtype) * sig_on
    d1 = torch.cat([(R.T @ hat(qv)) / sc, (-R.T / sc).expand(eye.shape),
                    (-live * x1_pred)[..., None]], -1)

    def proj_jac(pts):
        pz = pts[:, 2]
        clamped = pz.abs() < 1e-6
        z = torch.where(clamped, torch.full_like(pz, 1e-6), pz)
        dz = torch.where(clamped, torch.zeros_like(pz), torch.ones_like(pz))
        zero = torch.zeros_like(z)
        return torch.stack([
            torch.stack([cam.fx / z, zero, -cam.fx * pts[:, 0] / (z * z) * dz],
                        -1),
            torch.stack([zero, cam.fy / z, -cam.fy * pts[:, 1] / (z * z) * dz],
                        -1)], -2)

    r = torch.cat([_project(cam, x1_pred) - uv1,
                   _project(cam, x2_pred) - uv2], -1)
    J = torch.cat([proj_jac(x1_pred) @ d1, proj_jac(x2_pred) @ d2], -2)
    return r, J


def refine(cam, x1c, x2c, uv1, uv2, s0, R0, t0, valid, fix_scale=False,
           chi2_th=10.0, iters1=5, iters2=10, dtype=torch.float64):
    """(s, R, t, inliers) in the working precision of `dtype`."""
    work, q = rounder(dtype)
    x1c, x2c, uv1, uv2 = (q(v.to(work)) for v in (x1c, x2c, uv1, uv2))
    s, R, t = (q(v.to(work)) for v in (s0, R0, t0))
    valid = valid.bool()
    dev = x1c.device
    eye7 = torch.eye(7, dtype=work, device=dev)
    keep = torch.ones(7, dtype=work, device=dev)
    if fix_scale:
        keep[6] = 0.0

    def rounds(s, R, t, w_in, n_iters):
        lam = torch.tensor(1e-3, dtype=work, device=dev)
        for _ in range(n_iters):
            r, J = _residuals_jac(cam, x1c, x2c, uv1, uv2, s, R, t, fix_scale)
            r, J = q(r), q(J)
            chi2 = (r * r).sum(-1)
            wrob = torch.where(chi2 > chi2_th,
                               torch.sqrt(chi2_th / torch.clamp(chi2,
                                                                min=EPS)),
                               torch.ones_like(chi2)) * w_in
            Jw = q(J * wrob[:, None, None])
            H = q(torch.einsum("nij,nik->jk", Jw, J))
            g = q(torch.einsum("nij,ni->j", Jw, r))
            H = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-6))
            if fix_scale:
                H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
                g = g * keep
            d = q(-torch.linalg.solve_ex(H + 1e-9 * eye7, g[:, None])[0][:, 0])
            Rn = q(exp_so3(d[:3]) @ R)
            tn = q(t + d[3:6])
            sn = s if fix_scale else q(s * torch.exp(d[6]))
            r_new = q(_residuals(cam, x1c, x2c, uv1, uv2, sn, Rn, tn))
            accept = (wrob * (r_new * r_new).sum(-1)).sum() \
                < (wrob * chi2).sum()
            s = torch.where(accept, sn, s)
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-6, 1e4)
        return s, R, t

    def gate(s, R, t):
        r = _residuals(cam, x1c, x2c, uv1, uv2, s, R, t)
        return valid & ((r[:, :2] ** 2).sum(-1) < chi2_th) \
            & ((r[:, 2:] ** 2).sum(-1) < chi2_th)

    s, R, t = rounds(s, R, t, valid.to(work), iters1)
    ok = gate(s, R, t)
    s, R, t = rounds(s, R, t, ok.to(work), iters2)
    return s, R, t, gate(s, R, t)


def _kw(call):
    """The call's arguments by name."""
    names = ("cam", "x1c", "x2c", "uv1", "uv2", "s0", "R0", "t0", "valid",
             "fix_scale", "chi2_th", "iters1", "iters2")
    return {**dict(zip(names, call["args"])), **call["kw"]}


def gap_px(call: dict, dtype=torch.float64, against=None):
    """Largest distance in pixels between where the program's Sim3 and the
    reference's map the reference's inlier pairs, in both images (None
    where the reference keeps no pair).  `against` replaces the program's
    (s, R, t); the control passes its own."""
    kw = _kw(call)
    s_r, R_r, t_r, ok = refine(**kw, dtype=dtype)
    s_p, R_p, t_p = (call["out"][:3] if against is None else against)
    if not bool(ok.any()):
        return None
    f64 = torch.float64
    cam = kw["cam"]
    x1c, x2c = kw["x1c"].to(f64), kw["x2c"].to(f64)
    zero = torch.zeros_like(kw["uv1"].to(f64))
    a = _residuals(cam, x1c, x2c, zero, zero, s_p.to(f64), R_p.to(f64),
                   t_p.to(f64))
    b = _residuals(cam, x1c, x2c, zero, zero, s_r.to(f64), R_r.to(f64),
                   t_r.to(f64))
    d = torch.maximum(torch.linalg.vector_norm(a[:, :2] - b[:, :2], dim=1),
                      torch.linalg.vector_norm(a[:, 2:] - b[:, 2:], dim=1))
    return float(d[ok].max())


def inliers(call: dict) -> int:
    """Pairs the program's polish kept."""
    return int(call["out"][3].sum())
