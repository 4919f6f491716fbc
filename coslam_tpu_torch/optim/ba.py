"""Bundle adjustment: Schur-complement Levenberg-Marquardt (port of
coslam_tpu/optim/ba.py, whole).

Residuals and Jacobians are batched over observations; the 3x3 point
blocks are inverted in closed form.  Two solvers of the reduced camera
system S = Hcc - Y Hpp^-1 Y^T:

  * `solve_dense` / `solve_dense_compact` (windowed local BA) assemble the
    (6K, 6K) matrix from the dense (K, P, 6, 3) camera-point block and solve
    it by Cholesky (`torch.linalg`, as the reference solves it outside any
    Pallas kernel);
  * `solve` / `solve_body` (global BA) never materialize it: PCG runs on it
    matrix-free, each matvec being two observation-indexed segment sums
    (`index_add_`), with a block-Jacobi (6x6) preconditioner.  On the GPU the
    order of those sums is not fixed, so two runs agree to float rounding.

LM accept/reject is by total robust cost, `where`-masked, so a solve never
reads a value back to the host.  Gauge: `kf_fixed` keyframes contribute
measurements but receive no update.  `solve_body`'s `axis_name` (the
observation-sharded solve over a device mesh) waits for the distributed
slice (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.utils import geometry as geo


class BAProblem(NamedTuple):
    poses: torch.Tensor       # (K, 4, 4) Tcw
    points: torch.Tensor      # (P, 3) world
    obs_kf: torch.Tensor      # (O,) int keyframe index
    obs_pt: torch.Tensor      # (O,) int point index
    obs_uv: torch.Tensor      # (O, 2) undistorted pixel observations
    obs_w: torch.Tensor       # (O,) information (inv sigma^2 per octave)
    obs_valid: torch.Tensor   # (O,) bool
    kf_fixed: torch.Tensor    # (K,) bool — gauge/fixed cameras


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) bool chi2 < threshold at the solution
    cost: torch.Tensor        # final robust cost


def _proj_residuals(cam: CameraConfig, poses, points, p: BAProblem):
    T = poses[p.obs_kf.long()]                # (O, 4, 4)
    X = points[p.obs_pt.long()]               # (O, 3)
    R = T[:, :3, :3]
    pc = torch.einsum("oij,oj->oi", R, X) + T[:, :3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    u = x * iz * cam.fx + cam.cx
    v = y * iz * cam.fy + cam.cy
    r = torch.stack([u, v], 1) - p.obs_uv
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    J_uv = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], 1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], 1),
    ], 1)                                     # (O, 2, 3)
    Jc = torch.cat([
        J_uv,
        -torch.einsum("oij,ojk->oik", J_uv, geo.hat(pc))], 2)   # (O, 2, 6)
    Jp = torch.einsum("oij,ojk->oik", J_uv, R)                  # (O, 2, 3)
    behind = z <= 0.05
    return r, Jc, Jp, behind


def _robust_weight(chi2, delta2, robust: bool):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = delta2 ** 0.5
    return torch.where((chi2 > delta2) & robust, d / e, 1.0)


def _robust_cost(chi2, delta2, robust: bool):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = delta2 ** 0.5
    return torch.where((chi2 > delta2) & robust, d * (2 * e - d), chi2)


def _inv3(M):
    """Batched closed-form 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    inv = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return inv / det[..., None, None]


def _block_diag_dense(blocks):
    """(K, B, B) diagonal blocks -> (K*B, K*B) dense block-diagonal."""
    return torch.block_diag(*blocks.unbind(0))


def _seg_sum(x, idx, n: int):
    """Segment sum of x over the (O,) index idx into n rows."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add(0, idx.long(), x)


def solve(cam: CameraConfig, prob: BAProblem, iters: int = 10,
          pcg_iters: int = 40, chi2_th: float = 5.991,
          robust: bool = True) -> BAResult:
    """Run `iters` LM steps with the matrix-free PCG solver.  Cost of one
    step is O(observations) + PCG matvecs."""
    return solve_body(cam, prob, iters, pcg_iters, chi2_th, robust, None)


def solve_dense(cam: CameraConfig, prob: BAProblem, iters: int = 10,
                chi2_th: float = 5.991, robust: bool = True) -> BAResult:
    """`iters` LM steps with the reduced camera system materialized and
    solved exactly (g2o's BlockSolver_6_3 + direct solve, reference
    Optimizer.cc:56-62).  Memory: K*P*18 floats for the camera-point
    block."""
    K = prob.poses.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    delta2 = chi2_th
    free = ~prob.kf_fixed
    obs_kf = prob.obs_kf.long()
    obs_pt = prob.obs_pt.long()
    eye6K = torch.eye(6 * K, dtype=torch.float32, device=dev)

    def total_cost(poses, points):
        r, _, _, behind = _proj_residuals(cam, poses, points, prob)
        chi2 = (r * r).sum(1) * prob.obs_w
        ok = prob.obs_valid & ~behind
        return torch.where(ok, _robust_cost(chi2, delta2, robust), 0.0).sum()

    poses, points = prob.poses, prob.points
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    free6 = free.repeat_interleave(6)
    for _ in range(iters):
        r, Jc, Jp, behind = _proj_residuals(cam, poses, points, prob)
        chi2 = (r * r).sum(1) * prob.obs_w
        ok = prob.obs_valid & ~behind
        w = torch.where(ok, prob.obs_w * _robust_weight(chi2, delta2, robust),
                        0.0)
        Jcw = Jc * w[:, None, None]
        Jpw = Jp * w[:, None, None]

        Hcc = _seg_sum(torch.einsum("oij,oik->ojk", Jcw, Jc), obs_kf, K)
        Hpp = _seg_sum(torch.einsum("oij,oik->ojk", Jpw, Jp), obs_pt, P)
        bc = _seg_sum(torch.einsum("oij,oi->oj", Jcw, r), obs_kf, K)
        bp = _seg_sum(torch.einsum("oij,oi->oj", Jpw, r), obs_pt, P)

        lamc = lam * torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6)
        lamp = lam * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
        Hpp_inv = _inv3(Hpp + torch.diag_embed(lamp))

        # dense camera-point block Y: (K, P, 6, 3) via one scatter-add
        Yblk = torch.zeros((K * P, 6, 3), dtype=torch.float32, device=dev) \
            .index_add(0, obs_kf * P + obs_pt,
                       torch.einsum("oij,oik->ojk", Jcw, Jp)) \
            .reshape(K, P, 6, 3)
        YH = torch.einsum("kpij,pjl->kpil", Yblk, Hpp_inv)     # (K, P, 6, 3)
        Yr = Yblk.permute(0, 2, 1, 3).reshape(6 * K, 3 * P)
        YHr = YH.permute(0, 2, 1, 3).reshape(6 * K, 3 * P)
        Sd = -(YHr @ Yr.T)                                     # (6K, 6K)
        Sd = Sd + _block_diag_dense(Hcc + torch.diag_embed(lamc))
        # reduced gradient g = -bc + Y Hpp^-1 bp
        g = -bc + torch.einsum("kpij,pj->ki", YH, bp)
        # gauge: zero rows/cols of fixed cameras, identity on their diagonal
        Sd = torch.where(free6[:, None] & free6[None, :], Sd, eye6K)
        gd = torch.where(free6, g.reshape(-1), 0.0)
        L, info = torch.linalg.cholesky_ex(Sd + 1e-8 * eye6K)
        dc = torch.cholesky_solve(gd[:, None], L)[:, 0].reshape(K, 6)
        # a non-positive-definite system gives a NaN step, which the cost
        # test below rejects (the reference's Cholesky solve does the same)
        dc = torch.where(info == 0, dc, float("nan"))
        dc = torch.where(free[:, None], dc, 0.0)

        # back-substitute: dp = Hpp^-1 (-bp - Y^T dc)
        Ytdc = torch.einsum("kpij,ki->pj", Yblk, dc)
        dp = torch.einsum("pij,pj->pi", Hpp_inv, -bp - Ytdc)

        poses_new = geo.exp_se3(dc) @ poses
        points_new = points + dp
        cost_old = total_cost(poses, points)
        cost_new = total_cost(poses_new, points_new)
        accept = cost_new < cost_old
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0),
                          1e-8, 1e4)

    r, _, _, behind = _proj_residuals(cam, poses, points, prob)
    chi2 = (r * r).sum(1) * prob.obs_w
    inlier = prob.obs_valid & ~behind & (chi2 < chi2_th)
    return BAResult(poses=geo.project_se3(poses), points=points,
                    obs_inlier=inlier, cost=total_cost(poses, points))


def solve_dense_compact(cam: CameraConfig, prob: BAProblem, p_local: int,
                        iters: int = 10, chi2_th: float = 5.991,
                        robust: bool = True) -> BAResult:
    """`solve_dense` on a point-compacted subproblem: the observed point ids
    are ranked into `p_local` slots (stable sort + first-occurrence
    cumsum), the solver runs at P=p_local, and the updated positions
    scatter back.  Observations of points beyond the p_local capacity are
    masked out (they keep their positions)."""
    P = prob.points.shape[0]
    if p_local >= P:
        return solve_dense(cam, prob, iters, chi2_th, robust)
    dev = prob.points.device
    O = prob.obs_pt.shape[0]
    pt_key = torch.where(prob.obs_valid, prob.obs_pt.long(), P)    # (O,)
    order = torch.argsort(pt_key, stable=True)
    sorted_pt = pt_key[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sorted_pt[1:] != sorted_pt[:-1]])
    first = first & (sorted_pt < P)
    rank = torch.cumsum(first.to(torch.int64), 0) - 1              # (O,)
    # local slot -> global point id (capacity p_local, overflow dropped)
    slot_pt = torch.full((p_local + 1,), P, dtype=torch.int64, device=dev)
    slot_pt[torch.where(first & (rank < p_local), rank, p_local)] = sorted_pt
    slot_pt = slot_pt[:p_local]
    # per-observation local id, undoing the sort
    loc_sorted = torch.where((sorted_pt < P) & (rank < p_local), rank, p_local)
    loc = torch.zeros(O, dtype=torch.int64, device=dev)
    loc[order] = loc_sorted
    ok = prob.obs_valid & (loc < p_local)
    slot_safe = torch.clamp(slot_pt, max=P - 1)
    sub = prob._replace(points=prob.points[slot_safe],
                        obs_pt=torch.clamp(loc, max=p_local - 1),
                        obs_valid=ok)
    res = solve_dense(cam, sub, iters, chi2_th, robust)
    live = slot_pt < P
    points = torch.cat([prob.points, prob.points.new_zeros((1, 3))])
    points[torch.where(live, slot_pt, P)] = torch.where(
        live[:, None], res.points, 0.0)
    return res._replace(points=points[:P])


def solve_body(cam: CameraConfig, prob: BAProblem, iters: int,
               pcg_iters: int, chi2_th: float, robust: bool,
               axis_name) -> BAResult:
    """Matrix-free solver body.  Every cross-observation reduction goes
    through `_seg_sum`; with `axis_name` the reference all-reduces them
    over a mesh axis (observations sharded, poses / points replicated) —
    that branch belongs to the distributed slice."""
    if axis_name is not None:
        raise NotImplementedError(
            "the observation-sharded BA (solve_body with axis_name) is not "
            "ported yet (ROADMAP Queue 1 item 16); pass axis_name=None")
    K = prob.poses.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    delta2 = chi2_th
    free = ~prob.kf_fixed                      # (K,)
    free_c = free[:, None]
    obs_kf = prob.obs_kf.long()
    obs_pt = prob.obs_pt.long()
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def total_cost(poses, points):
        r, _, _, behind = _proj_residuals(cam, poses, points, prob)
        chi2 = (r * r).sum(1) * prob.obs_w
        ok = prob.obs_valid & ~behind
        return torch.where(ok, _robust_cost(chi2, delta2, robust), 0.0).sum()

    poses, points = prob.poses, prob.points
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r, Jc, Jp, behind = _proj_residuals(cam, poses, points, prob)
        chi2 = (r * r).sum(1) * prob.obs_w
        ok = prob.obs_valid & ~behind
        w = torch.where(ok, prob.obs_w * _robust_weight(chi2, delta2, robust),
                        0.0)
        Jcw = Jc * w[:, None, None]
        Jpw = Jp * w[:, None, None]
        # diagonal blocks
        Hcc = _seg_sum(torch.einsum("oij,oik->ojk", Jcw, Jc), obs_kf, K)
        Hpp = _seg_sum(torch.einsum("oij,oik->ojk", Jpw, Jp), obs_pt, P)
        bc = _seg_sum(torch.einsum("oij,oi->oj", Jcw, r), obs_kf, K)
        bp = _seg_sum(torch.einsum("oij,oi->oj", Jpw, r), obs_pt, P)

        lamc = lam * torch.clamp(torch.diagonal(Hcc, dim1=1, dim2=2), min=1e-6)
        lamp = lam * torch.clamp(torch.diagonal(Hpp, dim1=1, dim2=2), min=1e-6)
        Hpp_inv = _inv3(Hpp + torch.diag_embed(lamp))              # (P, 3, 3)

        def Yt_x(x):
            """Y^T x aggregated per point: (K, 6) -> (P, 3)."""
            u = torch.einsum("oij,oj->oi", Jc, x[obs_kf])          # (O, 2)
            return _seg_sum(torch.einsum("oij,oi->oj", Jpw, u), obs_pt, P)

        def Y_y(y):
            """Y y aggregated per camera: (P, 3) -> (K, 6)."""
            v = torch.einsum("oij,oj->oi", Jp, y[obs_pt])          # (O, 2)
            return _seg_sum(torch.einsum("oij,oi->oj", Jcw, v), obs_kf, K)

        def S_mv(x):
            x = torch.where(free_c, x, 0.0)
            u = torch.einsum("oij,oj->oi", Jc, x[obs_kf])
            hcc_x = _seg_sum(torch.einsum("oij,oi->oj", Jcw, u), obs_kf, K) \
                + lamc * x
            sx = hcc_x - Y_y(torch.einsum("pij,pj->pi", Hpp_inv, Yt_x(x)))
            return torch.where(free_c, sx, 0.0)

        # reduced gradient: g = -bc + Y Hpp^-1 bp  (solving S dc = g)
        g = -bc + Y_y(torch.einsum("pij,pj->pi", Hpp_inv, bp))
        g = torch.where(free_c, g, 0.0)

        # block-Jacobi preconditioner on Hcc + damping
        Mc_inv = torch.linalg.inv_ex(
            Hcc + torch.diag_embed(lamc) + 1e-8 * eye6)[0]
        Mc_inv = torch.where(free[:, None, None], Mc_inv, eye6[None])

        def precond(v):
            return torch.einsum("kij,kj->ki", Mc_inv, v)

        x = torch.zeros_like(g)
        rr = g
        z = precond(rr)
        pdir = z
        rz = (rr * z).sum()
        for _ in range(pcg_iters):
            Ap = S_mv(pdir)
            alpha = rz / ((pdir * Ap).sum() + 1e-20)
            x = x + alpha * pdir
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            beta = rz_new / (rz + 1e-20)
            pdir = z + beta * pdir
            rz = rz_new
        dc = torch.where(free_c, x, 0.0)

        # back-substitute points: dp = Hpp^-1 (-bp - Y^T dc)
        dp = torch.einsum("pij,pj->pi", Hpp_inv, -bp - Yt_x(dc))

        poses_new = geo.exp_se3(dc) @ poses
        points_new = points + dp
        cost_old = total_cost(poses, points)
        cost_new = total_cost(poses_new, points_new)
        accept = cost_new < cost_old
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lam = torch.clamp(torch.where(accept, lam * 0.4, lam * 5.0),
                          1e-8, 1e4)

    r, _, _, behind = _proj_residuals(cam, poses, points, prob)
    chi2 = (r * r).sum(1) * prob.obs_w
    inlier = prob.obs_valid & ~behind & (chi2 < chi2_th)
    # project rotations back to SO(3): exp-update composition drift would
    # otherwise compound through downstream pose algebra (geo.project_so3)
    return BAResult(poses=geo.project_se3(poses), points=points,
                    obs_inlier=inlier, cost=total_cost(poses, points))
