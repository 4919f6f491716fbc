"""Pinhole camera with radial-tangential distortion (port of coslam_tpu/
utils/camera.py).  Every function broadcasts over leading dimensions."""

from __future__ import annotations

import torch

from coslam_tpu_torch.config import CameraConfig


def intrinsics_matrix(cam: CameraConfig, device="cpu") -> torch.Tensor:
    return torch.tensor(cam.K, dtype=torch.float32, device=device)


def distort_normalized(cam: CameraConfig, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: CameraConfig, xd: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Invert distortion with a fixed number of fixed-point iterations (the
    semantics of cv::undistortPoints)."""
    if not cam.has_distortion:
        return xd
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        xn = (xd - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    return xn


def pixel_to_normalized(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], dim=-1)


def normalized_to_pixel(cam: CameraConfig, xn: torch.Tensor) -> torch.Tensor:
    u = xn[..., 0] * cam.fx + cam.cx
    v = xn[..., 1] * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def undistort_pixels(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords -> undistorted pixel coords (Frame.cc:405)."""
    if not cam.has_distortion:
        return uv
    return normalized_to_pixel(
        cam, undistort_normalized(cam, pixel_to_normalized(cam, uv)))


def backproject(cam: CameraConfig, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3)
    (reference Frame::UnprojectStereo, Frame.cc:667)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def project(cam: CameraConfig, pts_cam: torch.Tensor,
            distort: bool = False):
    """Camera-frame points (..., 3) -> (pixels (..., 2), depth (...)).
    Points at the camera plane are guarded against division by zero;
    validity is the caller's, through the depth."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-8,
                              torch.full_like(z, 1e-8), z)
    xn = pts_cam[..., :2] * inv_z[..., None]
    if distort and cam.has_distortion:
        xn = distort_normalized(cam, xn)
    return normalized_to_pixel(cam, xn), z


def in_image(cam: CameraConfig, uv: torch.Tensor,
             margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))


def projection_matrix(cam: CameraConfig, Tcw: torch.Tensor) -> torch.Tensor:
    """K @ [R|t] for triangulation: (..., 4, 4) -> (..., 3, 4)."""
    K = intrinsics_matrix(cam, Tcw.device).to(Tcw.dtype)
    return torch.einsum("ij,...jk->...ik", K, Tcw[..., :3, :])
