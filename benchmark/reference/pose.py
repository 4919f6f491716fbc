"""Motion-only pose optimisation (what kernel K3 computes): four rounds of
ten Levenberg-Marquardt steps on the reprojection error, Huber-robust in
the first two, outliers dropped by chi2 between rounds.  A copy of the
program's plain formulation, computed in `dtype` (float64 for the check,
bfloat16 for the control)."""

from __future__ import annotations

import math

import torch


def _chol_solve6(H, b):
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _exp_se3(dx):
    w = dx[3:]
    t2 = (w * w).sum()
    th = torch.sqrt(t2 + 1e-12)
    small = t2 < 1e-8
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(th)) / (t2 + 1e-12))
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - A) / (t2 + 1e-12))
    z = torch.zeros_like(t2)
    W = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    W2 = W @ W
    I = torch.eye(3, dtype=dx.dtype, device=dx.device)
    return I + A * W + B * W2, (I + B * W + C * W2) @ dx[:3]


def optimize(T_init, X, uv, isg, *, fx, fy, cx, cy, rounds, iters, chi2_th,
             dtype=torch.float64):
    """(T (4, 4), inliers (N,)) in `dtype`."""
    X, uv, isg = (t.to(dtype) for t in (X, uv, isg))
    delta = math.sqrt(chi2_th)
    valid = isg > 0
    U, V = uv[:, 0], uv[:, 1]
    diag = torch.arange(6, device=X.device)

    def resid(P):
        pc = X @ P[:, :3].T + P[:, 3]
        pcx, pcy, pcz = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = torch.where(pcz.abs() < 1e-6, torch.full_like(pcz, 1e-6), pcz)
        iz = 1.0 / zs
        ru = fx * pcx * iz + cx - U
        rv = fy * pcy * iz + cy - V
        return pcx, pcy, iz, ru, rv, pcz <= 0.05, (ru * ru + rv * rv) * isg

    def linearise(P, active, robust):
        pcx, pcy, iz, ru, rv, behind, chi2 = resid(P)
        ok = active & ~behind
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        over = (e > delta) if robust else torch.zeros_like(ok)
        w = torch.where(ok, isg * torch.where(over, delta / e, 1.0), 0.0)
        per = torch.where(over, delta * (2.0 * e - delta), chi2)
        cost = torch.where(ok, per, 0.0).sum()
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        Ju = torch.stack([fx * iz, zero, -fx * pcx * iz2,
                          -fx * pcx * pcy * iz2,
                          fx * (1.0 + pcx * pcx * iz2), -fx * pcy * iz], 1)
        Jv = torch.stack([zero, fy * iz, -fy * pcy * iz2,
                          -fy * (1.0 + pcy * pcy * iz2),
                          fy * pcx * pcy * iz2, fy * pcx * iz], 1)
        H = (Ju * w[:, None]).T @ Ju + (Jv * w[:, None]).T @ Jv
        b = (Ju * (w * ru)[:, None]).sum(0) + (Jv * (w * rv)[:, None]).sum(0)
        return H, b, cost

    P = T_init[:3, :4].to(dtype)
    active = valid
    for rnd in range(rounds):
        robust = rnd < 2
        lam = torch.tensor(1e-3, dtype=dtype, device=X.device)
        H, b, cost = linearise(P, active, robust)
        for _ in range(iters):
            Hd = H.clone()
            Hd[diag, diag] = torch.diagonal(H) * (1.0 + lam) + 1e-9
            dx = -_chol_solve6(Hd, b)
            Rd, td = _exp_se3(dx)
            Pn = Rd @ P
            Pn = torch.cat([Pn[:, :3], (Pn[:, 3] + td)[:, None]], 1)
            Hn, bn, cost_n = linearise(Pn, active, robust)
            improved = cost_n < cost
            P = torch.where(improved, Pn, P)
            H = torch.where(improved, Hn, H)
            b = torch.where(improved, bn, b)
            cost = torch.where(improved, cost_n, cost)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                              1e-6, 1e3)
        _, _, _, _, _, behind, chi2 = resid(P)
        active = valid & ~behind & (chi2 < chi2_th)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype,
                          device=X.device)
    return torch.cat([P, bottom]), active


def gap_px(call: dict, dtype=torch.float64, against=None) -> float:
    """Largest distance in pixels between where the program's pose and the
    reference's put each observed point (points in front of both).
    `against` replaces the program's pose (the control passes its own)."""
    T_init, X, uv, isg = call["args"][:4]
    kw = call["kw"]
    T_ref, _ = optimize(T_init, X, uv, isg, dtype=torch.float64, **kw)
    T_prog = call["out"][0] if against is None else against
    X64 = X.to(torch.float64)

    def proj(T):
        T = T.to(torch.float64)
        pc = X64 @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        return (torch.stack([kw["fx"] * pc[:, 0] / z + kw["cx"],
                             kw["fy"] * pc[:, 1] / z + kw["cy"]], 1), z)

    a, za = proj(T_prog)
    b, zb = proj(T_ref)
    keep = (isg > 0) & (za > 0.05) & (zb > 0.05)
    if not bool(keep.any()):
        return 0.0
    return float(torch.linalg.vector_norm(a - b, dim=1)[keep].max())
