"""SE3 / SO3 Lie-group operations on tensors (port of coslam_tpu/utils/
geometry.py, the functions the tracker uses).

All functions broadcast over leading batch dimensions; poses are 4x4
float32 world-to-camera matrices (Tcw).  Conventions: x_cam = R @ x_world + t;
Tcw = [[R, t], [0, 1]].
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    return _eye3_like(W) + a[..., None, None] * W \
        + b[..., None, None] * (W @ W)


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rot(T).transpose(-1, -2)
    t = -(Rt @ trans(T)[..., None])[..., 0]
    return se3(Rt, t)


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """Nearest-rotation projection by Gram-Schmidt on (..., 3, 3) ROWS.

    Optimizer boundaries project their output through this: chained f32
    pose compositions drift off SO(3), and since `se3_inverse` uses R^T the
    drift would compound through every velocity-model prediction."""
    r0 = R[..., 0, :]
    r0 = r0 / (torch.linalg.vector_norm(r0, dim=-1, keepdim=True) + 1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / (torch.linalg.vector_norm(r1, dim=-1, keepdim=True) + 1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def project_se3(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block of (..., 4, 4) poses."""
    return se3(project_so3(rot(T)), trans(T))


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se3 exp: (..., 6) twist [rho(3), phi(3)] -> (..., 4, 4), with the
    left-Jacobian V so that translation integrates along rotation."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    W = hat(phi)
    I = _eye3_like(W)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - a) / (theta2 + _EPS))
    WW = W @ W
    R = I + a[..., None, None] * W + b[..., None, None] * WW
    V = I + b[..., None, None] * W + c[..., None, None] * WW
    t = (V @ rho[..., None])[..., 0]
    return se3(R, t)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return pts @ rot(T).transpose(-1, -2) + trans(T)[..., None, :]


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) as (w, x, y, z), any norm and either sign ->
    rotation (..., 3, 3)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z):
    Shepperd's method, branchless (the reference's `rot_to_quat`)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def norm4(w, x, y, z):
        q = torch.stack([w, x, y, z], dim=-1)
        return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)

    # four candidate decompositions; pick the numerically best
    s0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 2
    q0 = norm4(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
               (m10 - m01) / s0)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 2
    q1 = norm4((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
               (m02 + m20) / s1)
    s2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 2
    q2 = norm4((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
               (m12 + m21) / s2)
    s3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 2
    q3 = norm4((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
               0.25 * s3)
    c0 = (tr > 0)[..., None]
    c1 = ((m00 > m11) & (m00 > m22))[..., None]
    c2 = (m11 > m22)[..., None]
    return torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
