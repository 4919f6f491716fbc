"""Synthetic scene / trajectory / image generation for tests and benchmarks.

The reference is exercised only against live ROS camera streams or dataset
bags; it ships no fixtures (SURVEY.md section 4).  This module provides the
deterministic ground-truth loop the TPU build is validated against in an
egress-free environment:

  * `make_scene`       — random 3D landmark cloud with per-point appearance
  * `make_trajectory`  — smooth camera path (orbit / arc) as Tcw poses
  * `render_sequence`  — rasterized 8-bit grayscale images with corner-rich
                         texture at landmark projections (drives the real
                         FAST/rBRIEF front end)
  * `feature_tracks`   — feature-level observations (uv + landmark id) that
                         bypass the extractor, for isolating tracking/BA tests
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.utils import evaluation


@dataclass
class Scene:
    points: np.ndarray        # (P, 3) world landmarks
    point_phase: np.ndarray   # (P,) appearance seed per landmark
    point_tex: np.ndarray     # (P, 8, 8) unique asymmetric texture patch


@dataclass
class Trajectory:
    poses_cw: np.ndarray      # (F, 4, 4) world-to-camera (Tcw)

    @property
    def centers(self) -> np.ndarray:
        return np.asarray(evaluation.trajectory_xyz(self.poses_cw))


def make_scene(n_points: int = 2000, seed: int = 0,
               box=((-4.0, 4.0), (-3.0, 3.0), (4.0, 12.0))) -> Scene:
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(lo, hi, n_points) for lo, hi in box], axis=1)
    phase = rng.uniform(0, 2 * np.pi, n_points)
    # Unique high-contrast asymmetric texture per landmark: the descriptor
    # front end needs natural-image-like patches (symmetric blobs make the
    # IC orientation degenerate).
    tex = rng.integers(30, 226, size=(n_points, 8, 8)).astype(np.float32)
    return Scene(points=pts.astype(np.float32),
                 point_phase=phase.astype(np.float32),
                 point_tex=tex)


def _look_at(eye, target, up=(0, -1, 0)):
    """World-to-camera pose looking from eye toward target (z forward)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rwc = np.stack([right, down, fwd], axis=1)  # columns = camera axes in world
    Rcw = Rwc.T
    tcw = -Rcw @ eye
    T = np.eye(4)
    T[:3, :3] = Rcw
    T[:3, 3] = tcw
    return T


def make_cylinder_scene(n_points: int = 1500, radius: float = 10.0,
                        height: float = 4.0, seed: int = 0) -> Scene:
    """Landmarks on the inside of a cylinder — with `make_loop_trajectory`
    each frame sees only a local arc, so a full circle produces a genuine
    loop-closure event (start/end views overlap, middle views do not)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = radius * (1.0 + 0.08 * rng.standard_normal(n_points))
    pts = np.stack([r * np.sin(th), rng.uniform(-height / 2, height / 2,
                                                n_points), r * np.cos(th)], 1)
    phase = rng.uniform(0, 2 * np.pi, n_points)
    tex = rng.integers(30, 226, size=(n_points, 8, 8)).astype(np.float32)
    return Scene(points=pts.astype(np.float32),
                 point_phase=phase.astype(np.float32), point_tex=tex)


def make_loop_trajectory(n_frames: int = 80, cam_radius: float = 3.0,
                         look_radius: float = 10.0, frac: float = 1.0,
                         seed: int = 0) -> Trajectory:
    """Camera on a circle of radius `cam_radius`, looking radially outward
    at the cylinder wall; `frac`=1 closes the full circle back to the start
    pose (monocular drift accumulates along the way -> loop closure)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        eye = np.array([cam_radius * np.sin(a), 0.0, cam_radius * np.cos(a)])
        target = np.array([look_radius * np.sin(a), 0.0,
                           look_radius * np.cos(a)])
        jitter = rng.normal(0, 0.002, 3)
        poses.append(_look_at(eye + jitter, target))
    return Trajectory(poses_cw=np.stack(poses).astype(np.float32))


def make_trajectory(n_frames: int = 60, kind: str = "arc",
                    radius: float = 2.0, seed: int = 0) -> Trajectory:
    """Smooth sideways arc with slight forward drift, always looking at the
    scene centroid region — generates translation + parallax like a handheld
    sweep (TUM fr1_xyz style)."""
    rng = np.random.default_rng(seed)
    poses = []
    target = np.array([0.0, 0.0, 8.0])
    for i in range(n_frames):
        u = i / max(n_frames - 1, 1)
        angle = (u - 0.5) * 1.2
        eye = np.array([
            radius * np.sin(angle),
            0.35 * np.sin(2.0 * np.pi * u),
            0.6 * np.sin(np.pi * u),
        ])
        if kind == "orbit":
            eye = np.array([radius * np.sin(angle), 0.3 * np.sin(4 * angle),
                            radius * (1 - np.cos(angle))])
        jitter = rng.normal(0, 0.002, 3)
        poses.append(_look_at(eye + jitter, target))
    return Trajectory(poses_cw=np.stack(poses).astype(np.float32))


def _project_np(cam: CameraConfig, Tcw: np.ndarray, pts: np.ndarray,
                distort: bool = False):
    """Project world points; with `distort` the camera's radial-tangential
    model is applied FORWARD (rendering the image a real distorted lens
    would produce, so the loader-side undistortion is exercised for real —
    proxy datasets for cameras like EuRoC's strong-barrel lens need this)."""
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = pc[:, 0] / z
        yn = pc[:, 1] / z
        if distort and cam.has_distortion:
            xd, yd = _distort_np(cam, xn, yn)
            xn, yn = xd, yd
        u = xn * cam.fx + cam.cx
        v = yn * cam.fy + cam.cy
    return np.stack([u, v], axis=1), z


def _distort_np(cam: CameraConfig, xn, yn):
    r2 = xn * xn + yn * yn
    rad = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 ** 3
    xd = xn * rad + 2 * cam.p1 * xn * yn + cam.p2 * (r2 + 2 * xn * xn)
    yd = yn * rad + cam.p1 * (r2 + 2 * yn * yn) + 2 * cam.p2 * xn * yn
    return xd, yd


def _distort_jacobians(cam: CameraConfig, uv_ideal: np.ndarray,
                       eps: float = 1e-4) -> np.ndarray:
    """(N, 2, 2) pixel-space Jacobians d(distorted uv)/d(ideal uv) of the
    radial-tangential model, by central differences on normalized coords.
    Splats rendered through this local affine put their CORNERS (what the
    FAST detector finds) where the true distorted projection would — a
    center-only distortion leaves corner geometry inconsistent by the
    distortion gradient times the patch radius (~1-3 px at a strong
    barrel's edge), which breaks sigma=1 reprojection gates downstream."""
    xn = (uv_ideal[:, 0] - cam.cx) / cam.fx
    yn = (uv_ideal[:, 1] - cam.cy) / cam.fy
    J = np.zeros((uv_ideal.shape[0], 2, 2), np.float64)
    xpx, ypx = _distort_np(cam, xn + eps, yn)
    xmx, ymx = _distort_np(cam, xn - eps, yn)
    xpy, ypy = _distort_np(cam, xn, yn + eps)
    xmy, ymy = _distort_np(cam, xn, yn - eps)
    J[:, 0, 0] = (xpx - xmx) / (2 * eps) * cam.fx / cam.fx
    J[:, 1, 0] = (ypx - ymx) / (2 * eps) * cam.fy / cam.fx
    J[:, 0, 1] = (xpy - xmy) / (2 * eps) * cam.fx / cam.fy
    J[:, 1, 1] = (ypy - ymy) / (2 * eps) * cam.fy / cam.fy
    return J


def render_frame(cam: CameraConfig, Tcw: np.ndarray, scene: Scene,
                 patch: int = 9, seed: int = 0,
                 distort: bool = False) -> np.ndarray:
    """Rasterize one 8-bit grayscale frame.

    Each visible landmark is drawn as a bright axis-aligned square whose
    intensity is a deterministic function of the landmark id, on a mid-gray
    background with low-amplitude deterministic noise.  Square corners are
    strong FAST corners and the local patch is stable across small viewpoint
    changes, so the full oriented-BRIEF pipeline can match them across frames.
    """
    h, w = cam.height, cam.width
    rng = np.random.default_rng(seed)  # static background noise (same all frames)
    img = (96 + 8 * rng.standard_normal((h, w))).clip(0, 255)
    uv, z = _project_np(cam, Tcw, scene.points, distort=distort)
    warp = distort and cam.has_distortion
    if warp:
        uv_ideal, _ = _project_np(cam, Tcw, scene.points, distort=False)
        with np.errstate(invalid="ignore"):
            Js = _distort_jacobians(cam, np.nan_to_num(uv_ideal))
    vis = (z > 0.3) & (uv[:, 0] >= -30) & (uv[:, 0] < w + 30) \
        & (uv[:, 1] >= -30) & (uv[:, 1] < h + 30)
    order = np.argsort(-z)  # far first so near landmarks draw on top
    for idx in order:
        if not vis[idx]:
            continue
        cu, cv = float(uv[idx, 0]), float(uv[idx, 1])
        # continuous apparent size + subpixel placement with bilinear
        # texture sampling: appearance varies smoothly with viewpoint, so
        # descriptors are repeatable across views (real-imagery behavior)
        size = float(np.clip(patch * 16.0 / z[idx], 10.0, 44.0))
        half = size / 2.0
        # under a distortion warp the splat may stretch; pad the raster box
        margin = half * (1.4 if warp else 1.0)
        x0 = max(0, int(np.floor(cu - margin)))
        x1 = min(w, int(np.ceil(cu + margin)) + 1)
        y0 = max(0, int(np.floor(cv - margin)))
        y1 = min(h, int(np.ceil(cv + margin)) + 1)
        if y1 <= y0 or x1 <= x0:
            continue
        px = np.arange(x0, x1, dtype=np.float64)
        py = np.arange(y0, y1, dtype=np.float64)
        dx = np.broadcast_to(px[None, :] - cu, (len(py), len(px)))
        dy = np.broadcast_to(py[:, None] - cv, (len(py), len(px)))
        if warp:
            # map image offsets back to IDEAL (undistorted) offsets through
            # the local inverse Jacobian, so the splat's corners land where
            # the true distorted projection puts them (first order)
            Jinv = np.linalg.inv(Js[idx])
            ox = Jinv[0, 0] * dx + Jinv[0, 1] * dy
            oy = Jinv[1, 0] * dx + Jinv[1, 1] * dy
        else:
            ox, oy = dx, dy
        tx = (ox + half) / size * 8.0 - 0.5
        ty = (oy + half) / size * 8.0 - 0.5
        inside = (tx > -0.5) & (tx < 7.5) & (ty > -0.5) & (ty < 7.5)
        if not inside.any():
            continue
        txc = np.clip(tx, 0.0, 7.0)
        tyc = np.clip(ty, 0.0, 7.0)
        ix0 = np.minimum(txc.astype(int), 6)
        iy0 = np.minimum(tyc.astype(int), 6)
        fx = txc - ix0
        fy = tyc - iy0
        t = scene.point_tex[idx]
        val = (t[iy0, ix0] * (1 - fy) * (1 - fx)
               + t[iy0, ix0 + 1] * (1 - fy) * fx
               + t[iy0 + 1, ix0] * fy * (1 - fx)
               + t[iy0 + 1, ix0 + 1] * fy * fx)
        region = img[y0:y1, x0:x1]
        img[y0:y1, x0:x1] = np.where(inside, val, region)
    return img.astype(np.uint8)


def render_sequence(cam: CameraConfig, traj: Trajectory, scene: Scene,
                    seed: int = 0) -> np.ndarray:
    return np.stack([render_frame(cam, T, scene, seed=seed)
                     for T in traj.poses_cw])


def render_depth(cam: CameraConfig, Tcw: np.ndarray, scene: Scene,
                 patch: int = 9, distort: bool = False) -> np.ndarray:
    """(H, W) float32 depth map consistent with `render_frame`'s painter
    ordering (landmark squares carry their center depth; background = 0 =
    invalid, like a Kinect hole)."""
    h, w = cam.height, cam.width
    depth = np.zeros((h, w), np.float32)
    uv, z = _project_np(cam, Tcw, scene.points, distort=distort)
    vis = (z > 0.3) & (uv[:, 0] >= -30) & (uv[:, 0] < w + 30) \
        & (uv[:, 1] >= -30) & (uv[:, 1] < h + 30)
    order = np.argsort(-z)
    for idx in order:
        if not vis[idx]:
            continue
        cu, cv = float(uv[idx, 0]), float(uv[idx, 1])
        size = float(np.clip(patch * 16.0 / z[idx], 10.0, 44.0))
        half = size / 2.0
        x0 = max(0, int(np.floor(cu - half + 0.5)))
        x1 = min(w, int(np.ceil(cu + half - 0.5)))
        y0 = max(0, int(np.floor(cv - half + 0.5)))
        y1 = min(h, int(np.ceil(cv + half - 0.5)))
        if y1 > y0 and x1 > x0:
            depth[y0:y1, x0:x1] = z[idx]
    return depth


def render_stereo_frame(cam: CameraConfig, Tcw: np.ndarray, scene: Scene,
                        baseline: float, seed: int = 0):
    """(left, right) grayscale pair; right camera displaced by `baseline`
    along +x of the left camera (rectified geometry)."""
    left = render_frame(cam, Tcw, scene, seed=seed)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -baseline  # x_right = x_left - b
    right = render_frame(cam, (T_rl @ Tcw).astype(np.float32), scene,
                         seed=seed)
    return left, right


def feature_tracks(cam: CameraConfig, traj: Trajectory, scene: Scene,
                   max_obs: int = 512, noise_px: float = 0.3, seed: int = 0):
    """Feature-level observations bypassing the extractor.

    Returns per-frame arrays:
      uv:    (F, max_obs, 2) float32 pixel observations (noisy)
      ids:   (F, max_obs) int32 landmark index, -1 = padding
      valid: (F, max_obs) bool
    """
    rng = np.random.default_rng(seed)
    F = traj.poses_cw.shape[0]
    uv_out = np.zeros((F, max_obs, 2), np.float32)
    id_out = np.full((F, max_obs), -1, np.int32)
    for f, Tcw in enumerate(traj.poses_cw):
        uv, z = _project_np(cam, Tcw, scene.points)
        vis = (z > 0.3) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        idx = np.nonzero(vis)[0]
        if idx.size > max_obs:
            idx = rng.choice(idx, max_obs, replace=False)
        n = idx.size
        uv_out[f, :n] = uv[idx] + rng.normal(0, noise_px, (n, 2))
        id_out[f, :n] = idx
    return uv_out, id_out, id_out >= 0
