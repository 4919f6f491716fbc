"""Trajectory accuracy against the renderer's ground truth: Umeyama's
similarity alignment and the ATE RMSE of camera centres (float64)."""

from __future__ import annotations

import numpy as np


def centres(poses_cw) -> np.ndarray:
    """Camera centres C = -R^T t of (F, 4, 4) world-to-camera poses."""
    T = np.asarray(poses_cw, np.float64)
    return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


def umeyama(src, dst):
    """(s, R, t) minimising ||dst - (s R src + t)||^2 (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(dc.T @ sc / len(src))
    S = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        S[2, 2] = -1.0
    R = u @ S @ vt
    s = float((d * np.diag(S)).sum() / ((sc ** 2).sum() / len(src) + 1e-300))
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_xyz, gt_xyz) -> float:
    """RMS of centre errors after the similarity alignment (metres)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    s, R, t = umeyama(est, gt)
    err = s * est @ R.T + t - gt
    return float(np.sqrt((err ** 2).sum(1).mean()))
