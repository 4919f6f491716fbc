"""EPnP + RANSAC camera relocalization (port of coslam_tpu/ops/pnp.py:
`_epnp_minimal`, `ransac_pnp`, `PnPResult`).

A fixed count of hypotheses, each a six-point EPnP: control points from a
PCA of the sample, the 12-vector of camera-frame control points as the null
vector of M^T M (`eigh`), the single-beta scale by least squares over the
control-point distances, and R, t from the closed-form rigid alignment
(`sim3.horn_sim3`).  The reference maps one hypothesis over the samples with
`vmap`; here the hypotheses are a leading batch dimension and the small
decompositions are batched library calls, as they are outside any kernel in
the reference.  The winner is meant to be refined by motion-only BA
(optim/pose_opt.py).

The sample indices are an argument: `draw_samples` draws them from a
`torch.Generator`, and the parity tests inject the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.ops import sim3 as sim3_ops
from coslam_tpu_torch.ops import twoview
from coslam_tpu_torch.utils import geometry as geo

SAMPLE_SIZE = 6     # 2n >= 11 equations for the single-beta case
RANSAC_ITERS = 512  # for an inlier share of ~0.35: 0.35^6 * 512 ~ 0.9


class PnPResult(NamedTuple):
    T: torch.Tensor          # (4, 4) Tcw
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # ()


def draw_samples(valid: torch.Tensor, generator: torch.Generator,
                 iters: int = RANSAC_ITERS) -> torch.Tensor:
    """(iters, 6) indices drawn with replacement, uniformly over `valid`."""
    return twoview.draw_samples(valid, iters, generator, SAMPLE_SIZE)


def _epnp_minimal(X, uvn):
    """EPnP on small samples: X (B, n, 3) world points, uvn (B, n, 2)
    normalized image coordinates.  Returns (R (B, 3, 3), t (B, 3)) with
    x_cam = R x + t."""
    B, n = X.shape[:2]
    dev = X.device
    # control points: centroid + principal axes
    c0 = X.mean(1)
    Xc = X - c0[:, None]
    w, v = torch.linalg.eigh(Xc.transpose(1, 2) @ Xc / n)
    sd = torch.sqrt(torch.clamp(w, min=1e-10))
    C = torch.cat([c0[:, None],
                   c0[:, None] + (v * sd[:, None, :]).transpose(1, 2)], 1)

    # barycentric coordinates: X = alpha @ C with sum(alpha) = 1; a
    # degenerate sample gives a useless hypothesis, not an error
    ones4 = torch.ones((B, 1, 4), dtype=X.dtype, device=dev)
    onesn = torch.ones((B, 1, n), dtype=X.dtype, device=dev)
    alpha = torch.linalg.solve_ex(
        torch.cat([C.transpose(1, 2), ones4], 1),
        torch.cat([X.transpose(1, 2), onesn], 1))[0].transpose(1, 2)  # (B, n, 4)

    # M v = 0 system (2n x 12), v laid out [x0, y0, z0, x1, y1, z1, ...]
    u, vv = uvn[..., 0], uvn[..., 1]
    zero = torch.zeros_like(alpha)
    r1 = torch.stack([alpha, zero, -u[..., None] * alpha], -1).reshape(B, n, 12)
    r2 = torch.stack([zero, alpha, -vv[..., None] * alpha], -1).reshape(B, n, 12)
    M = torch.cat([r1, r2], 1)
    _, evec = torch.linalg.eigh(M.transpose(1, 2) @ M)
    Cc = evec[:, :, 0].reshape(B, 4, 3)

    # single-beta case: scale so pairwise control distances match the world's
    ii, jj = torch.triu_indices(4, 4, 1, device=dev)
    dw = torch.linalg.vector_norm(C[:, ii] - C[:, jj], dim=-1)
    dc = torch.linalg.vector_norm(Cc[:, ii] - Cc[:, jj], dim=-1)
    beta = (dw * dc).sum(-1) / ((dc * dc).sum(-1) + 1e-12)
    Cc = Cc * beta[:, None, None]
    # cheirality: camera points must have positive depth on average (this
    # also settles the eigenvector's free sign)
    Xcam = alpha @ Cc
    Cc = torch.where((Xcam[..., 2].mean(-1) < 0)[:, None, None], -Cc, Cc)
    Xcam = alpha @ Cc

    _, R, t = sim3_ops.horn_sim3(X, Xcam, fix_scale=True)
    return R, t


def ransac_pnp(cam: CameraConfig, X, uv, valid, samples,
               chi2_th: float = 5.991) -> PnPResult:
    """X (N, 3) world points, uv (N, 2) observed (undistorted) pixels,
    samples (iters, 6) indices into them (`draw_samples`).

    Every sample gives one EPnP pose, scored by its count of valid points
    in front of the camera that reproject within 2 * sqrt(chi2_th) px; the
    first hypothesis with the highest count wins."""
    samples = samples.long()
    uvn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                       (uv[:, 1] - cam.cy) / cam.fy], 1)

    def reproj_ok(R, t):
        pc = X @ R.transpose(-1, -2) + t[..., None, :]
        pz = pc[..., 2]
        z = torch.where(pz.abs() < 1e-6, torch.full_like(pz, 1e-6), pz)
        u = pc[..., 0] / z * cam.fx + cam.cx
        v = pc[..., 1] / z * cam.fy + cam.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (pz > 0) & (e2 < chi2_th * 4.0)

    Rs, ts = _epnp_minimal(X[samples], uvn[samples])
    counts = reproj_ok(Rs, ts).sum(-1)
    best = torch.argmax(counts).reshape(1)      # first index among ties
    R, t = Rs.index_select(0, best)[0], ts.index_select(0, best)[0]
    ok = reproj_ok(R, t)
    return PnPResult(T=geo.se3(R, t), inliers=ok, n_inliers=ok.sum())
