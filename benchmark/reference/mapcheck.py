"""The keyframe backend's product judged by geometry: every observation
of a valid landmark in a valid keyframe reprojected through that
keyframe's pose (float64), the median pixel error.  Triangulation places
the landmarks and local BA adjusts them with the poses; both are judged
by how well the map explains the keypoints it was built from."""

from __future__ import annotations

import numpy as np


def reprojection_px(arrays: dict, camera: dict, dtype=np.float64) -> float:
    """Median reprojection error in pixels; `dtype` rounds the map's poses
    and landmarks first (the control reads them in bfloat16)."""
    kf_valid = arrays["kf_valid"].astype(bool)
    obs = arrays["kf_obs_pt"]
    pt_valid = arrays["pt_valid"].astype(bool)
    pose = _round(arrays["kf_pose"], dtype)
    pos = _round(arrays["pt_pos"], dtype)
    uv = arrays["kf_uv"].astype(np.float64)
    k, n = np.nonzero(kf_valid[:, None] & (obs >= 0))
    if not len(k):
        return float("nan")
    p = obs[k, n]
    keep = pt_valid[p]
    k, n, p = k[keep], n[keep], p[keep]
    X = pos[p]
    R, t = pose[k, :3, :3], pose[k, :3, 3]
    pc = np.einsum("oij,oj->oi", R, X) + t
    front = pc[:, 2] > 1e-6
    pc, k, n = pc[front], k[front], n[front]
    u = camera["fx"] * pc[:, 0] / pc[:, 2] + camera["cx"]
    v = camera["fy"] * pc[:, 1] / pc[:, 2] + camera["cy"]
    e = np.hypot(u - uv[k, n, 0], v - uv[k, n, 1])
    return float(np.median(e)) if len(e) else float("nan")


def _round(a, dtype) -> np.ndarray:
    a = np.asarray(a, np.float64)
    if dtype == "bfloat16":
        import torch
        return torch.as_tensor(a, dtype=torch.float32).to(
            torch.bfloat16).to(torch.float64).numpy()
    return a.astype(dtype).astype(np.float64)
