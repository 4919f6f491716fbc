"""Pinhole camera with radial-tangential distortion (port of coslam_tpu/
utils/camera.py: `undistort_pixels` and what it calls, and `backproject`)."""

from __future__ import annotations

import torch

from coslam_tpu_torch.config import CameraConfig


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
