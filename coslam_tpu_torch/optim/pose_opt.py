"""Motion-only (pose-only) bundle adjustment (port of coslam_tpu/optim/
pose_opt.py).

4 rounds x 10 Levenberg-Marquardt iterations over one SE3 pose with unary
reprojection edges, Huber delta = sqrt(5.991) in rounds 1-2, chi2 outlier
re-classification between rounds (reference Optimizer.cc:239-451).
`optimize_pose` runs kernel K3 (ops/cuda_kernels.pose_opt_lm) — its plain
twin for CPU tensors — on every device, the route the reference takes on
the TPU, through `cuda_graph.host_launch`: inside the chunk tracker's
segmented graph each replay launches it from the host.
`_optimize_pose_xla_testonly` is the reference's XLA formulation, kept as
the independent reference for tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.config import CameraConfig, TrackerConfig
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops.cuda_kernels import chol_solve6  # noqa: F401
from coslam_tpu_torch.utils import cuda_graph
from coslam_tpu_torch.utils import geometry as geo


class PoseOptResult(NamedTuple):
    T: torch.Tensor          # (4, 4) optimized Tcw
    inliers: torch.Tensor    # (N,) bool final chi2 classification
    n_inliers: torch.Tensor  # () int64 count


def optimize_pose(cam: CameraConfig, T_init, X, uv, valid, inv_sigma2,
                  cfg: TrackerConfig = TrackerConfig()) -> PoseOptResult:
    """X: (N, 3) world points; uv: (N, 2) observed (undistorted) pixels;
    valid: (N,) bool; inv_sigma2: (N,) per-observation information."""
    isg_m = torch.where(valid, inv_sigma2, 0.0).to(torch.float32)
    T, inl = cuda_graph.host_launch(
        ck, "pose_opt_lm",
        T_init.to(torch.float32), X.to(torch.float32).contiguous(),
        uv.to(torch.float32).contiguous(), isg_m,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters,
        chi2_th=cfg.chi2_mono)
    inliers = inl & valid
    return PoseOptResult(T=geo.project_se3(T), inliers=inliers,
                         n_inliers=inliers.sum())


def _residuals_jac(cam: CameraConfig, T, X, uv):
    """Reprojection residuals (N, 2) and Jacobians (N, 2, 6) w.r.t. a left
    se3 perturbation of Tcw."""
    pc = geo.transform_points(T, X)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / zs
    u = x * iz * cam.fx + cam.cx
    v = y * iz * cam.fy + cam.cy
    r = torch.stack([u, v], 1) - uv
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    J_uv = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], 1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], 1),
    ], 1)                                                  # (N, 2, 3)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(X.shape[0], 3, 3)
    J_pc = torch.cat([eye, -geo.hat(pc)], 2)               # (N, 3, 6)
    return r, J_uv @ J_pc, z <= 0.05


def _optimize_pose_xla_testonly(cam: CameraConfig, T_init, X, uv, valid,
                                inv_sigma2, cfg: TrackerConfig
                                ) -> PoseOptResult:
    """The reference's XLA LM (cached linearization, generic 6x6 solve), the
    independent reference the kernel route is tested against."""
    chi2_th = cfg.chi2_mono
    delta = float(chi2_th) ** 0.5

    def cost_of(r, behind, active, robust):
        chi2 = (r * r).sum(1) * inv_sigma2
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        rob = delta * (2 * e - delta)
        per = torch.where((e > delta) & robust, rob, chi2)
        return torch.where(active & ~behind, per, 0.0).sum()

    T = T_init
    r, J, behind = _residuals_jac(cam, T, X, uv)
    active = valid
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for rnd in range(cfg.pose_opt_rounds):
        robust = rnd < 2
        lam = torch.tensor(1e-3, dtype=torch.float32, device=T.device)
        for _ in range(cfg.pose_opt_iters):
            chi2 = (r * r).sum(1) * inv_sigma2
            e = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_rob = torch.where((e > delta) & robust, delta / e, 1.0)
            w = torch.where(active & ~behind, inv_sigma2 * w_rob, 0.0)
            Jw = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            b = torch.einsum("nij,ni->j", Jw, r)
            cost = cost_of(r, behind, active, robust)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = -torch.linalg.solve(Hd, b)
            T_new = geo.exp_se3(dx) @ T
            r2, J2, behind2 = _residuals_jac(cam, T_new, X, uv)
            improved = cost_of(r2, behind2, active, robust) < cost
            T = torch.where(improved, T_new, T)
            r = torch.where(improved, r2, r)
            J = torch.where(improved, J2, J)
            behind = torch.where(improved, behind2, behind)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                              1e-6, 1e3)
        chi2 = torch.where(valid & ~behind, (r * r).sum(1) * inv_sigma2,
                           torch.inf)
        active = valid & (chi2 < chi2_th)
    return PoseOptResult(T=geo.project_se3(T), inliers=active,
                         n_inliers=active.sum())
