"""Closed-form similarity from 3D-3D correspondences (port of
coslam_tpu/ops/sim3.py: `horn_sim3`).

Only the closed form is here: EPnP (ops/pnp.py) aligns its camera-frame
points with it.  `ransac_sim3` and `Sim3Result` belong to loop closing and
wait for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import torch

from coslam_tpu_torch.utils import geometry as geo


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
