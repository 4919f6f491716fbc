"""Trajectory evaluation: Umeyama alignment, ATE RMSE, RPE.

The reference has no built-in evaluation — its de-facto test is exporting
TUM/KITTI trajectory files (reference ORB_SLAM2/src/System.cc:325-470) for
external tooling.  Here evaluation is a first-class subsystem so integration
tests assert ATE bounds directly.  Pure numpy (host-side, float64): this is
offline analysis, not a TPU compute path.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3).  Returns (s, R, t) minimizing ||dst - (s R src + t)||^2
    (Umeyama 1991).  `with_scale=True` for monocular (scale-ambiguous)
    trajectories, False for stereo/RGB-D.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1.0
    R = u @ s_mat @ vt
    if with_scale:
        var_s = (sc ** 2).sum() / src.shape[0]
        scale = float((d * np.diag(s_mat)).sum() / (var_s + 1e-300))
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def ate_rmse(est_xyz, gt_xyz, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after similarity alignment (meters)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = s * est @ R.T + t
    err = aligned - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over frame pairs (i, i+delta).

    est_poses, gt_poses: (N, 4, 4) world-to-camera (Tcw).  Returns
    (trans_rmse, rot_rmse_deg).
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = est.shape[0] - delta
    terrs, rerrs = [], []
    for i in range(n):
        de = est[i] @ np.linalg.inv(est[i + delta])
        dg = gt[i] @ np.linalg.inv(gt[i + delta])
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        cos_t = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.degrees(np.arccos(cos_t)))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))


def trajectory_xyz(poses_cw):
    """Camera centers from world-to-camera poses: C = -R^T t."""
    poses_cw = np.asarray(poses_cw, np.float64)
    R = poses_cw[..., :3, :3]
    t = poses_cw[..., :3, 3]
    return -np.einsum("...ji,...j->...i", R, t)
