"""The benchmark's own copy of the port's synthetic renderer
(coslam_tpu_torch/utils/synthetic.py: `make_cylinder_scene`,
`make_loop_trajectory`, `render_frame` with its lens model), so that the
traffic and the ground truth do not move when the program changes.  NumPy
only; `render_frames` spreads the frames over a pool of processes, and
`fixed_sequences` renders a mix's fixed set of sequences once per checkout
into benchmark/.cache/frames (a fixed path, like the kernel build).

benchmark/tests/test_bench_render.py holds this copy equal to the port's
renderer at a small size.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import multiprocessing
import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Lens:
    """The camera fields the renderer reads."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2,
                                        self.k3))

    @classmethod
    def of(cls, camera: dict) -> "Lens":
        return cls(**{k: camera[k] for k in cls.__dataclass_fields__
                      if k in camera})


@dataclass
class Scene:
    points: np.ndarray        # (P, 3) world landmarks
    point_phase: np.ndarray   # (P,)
    point_tex: np.ndarray     # (P, 8, 8) texture patch


def make_cylinder_scene(n_points: int, radius: float = 10.0,
                        height: float = 4.0, seed: int = 0) -> Scene:
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = radius * (1.0 + 0.08 * rng.standard_normal(n_points))
    pts = np.stack([r * np.sin(th), rng.uniform(-height / 2, height / 2,
                                                n_points), r * np.cos(th)], 1)
    phase = rng.uniform(0, 2 * np.pi, n_points)
    tex = rng.integers(30, 226, size=(n_points, 8, 8)).astype(np.float32)
    return Scene(points=pts.astype(np.float32),
                 point_phase=phase.astype(np.float32), point_tex=tex)


def _look_at(eye, target, up=(0, -1, 0)):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd], axis=1).T
    T = np.eye(4)
    T[:3, :3] = Rcw
    T[:3, 3] = -Rcw @ eye
    return T


def make_loop_trajectory(n_frames: int, cam_radius: float = 3.0,
                         look_radius: float = 10.0, frac: float = 1.0,
                         seed: int = 0) -> np.ndarray:
    """(F, 4, 4) float32 world-to-camera poses on a circle looking out."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        eye = np.array([cam_radius * np.sin(a), 0.0, cam_radius * np.cos(a)])
        target = np.array([look_radius * np.sin(a), 0.0,
                           look_radius * np.cos(a)])
        jitter = rng.normal(0, 0.002, 3)
        poses.append(_look_at(eye + jitter, target))
    return np.stack(poses).astype(np.float32)


def _distort_np(cam: Lens, xn, yn):
    r2 = xn * xn + yn * yn
    rad = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 ** 3
    xd = xn * rad + 2 * cam.p1 * xn * yn + cam.p2 * (r2 + 2 * xn * xn)
    yd = yn * rad + cam.p1 * (r2 + 2 * yn * yn) + 2 * cam.p2 * xn * yn
    return xd, yd


def _project_np(cam: Lens, Tcw, pts, distort: bool = False):
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = pc[:, 0] / z
        yn = pc[:, 1] / z
        if distort and cam.has_distortion:
            xn, yn = _distort_np(cam, xn, yn)
        u = xn * cam.fx + cam.cx
        v = yn * cam.fy + cam.cy
    return np.stack([u, v], axis=1), z


def _distort_jacobians(cam: Lens, uv_ideal, eps: float = 1e-4):
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


def render_frame(cam: Lens, Tcw, scene: Scene, patch: int = 9,
                 seed: int = 0, distort: bool = False) -> np.ndarray:
    """One 8-bit grayscale frame: each visible landmark a textured square
    on a noisy mid-grey background, through the lens when `distort`."""
    h, w = cam.height, cam.width
    rng = np.random.default_rng(seed)
    img = (96 + 8 * rng.standard_normal((h, w))).clip(0, 255)
    uv, z = _project_np(cam, Tcw, scene.points, distort=distort)
    warp = distort and cam.has_distortion
    if warp:
        uv_ideal, _ = _project_np(cam, Tcw, scene.points, distort=False)
        with np.errstate(invalid="ignore"):
            Js = _distort_jacobians(cam, np.nan_to_num(uv_ideal))
    vis = (z > 0.3) & (uv[:, 0] >= -30) & (uv[:, 0] < w + 30) \
        & (uv[:, 1] >= -30) & (uv[:, 1] < h + 30)
    for idx in np.argsort(-z):
        if not vis[idx]:
            continue
        cu, cv = float(uv[idx, 0]), float(uv[idx, 1])
        size = float(np.clip(patch * 16.0 / z[idx], 10.0, 44.0))
        half = size / 2.0
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


_WORKER: dict = {}


def _worker_init(cam: Lens, scenes) -> None:
    _WORKER["cam"], _WORKER["scenes"] = cam, scenes


def _render_one(job) -> np.ndarray:
    i, T = job
    return render_frame(_WORKER["cam"], T, _WORKER["scenes"][i],
                        distort=True)


def render_many(cam: Lens, trajectories, scenes,
                workers: Optional[int] = None):
    """Each trajectory's frames through the lens in its scene, all
    sequences' frames spread over one pool of `workers` processes."""
    n = workers if workers is not None else min(8, os.cpu_count() or 1)
    jobs = [(i, T) for i, poses in enumerate(trajectories) for T in poses]
    if n <= 1:
        _worker_init(cam, list(scenes))
        flat = [_render_one(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(n, initializer=_worker_init,
                      initargs=(cam, list(scenes))) as pool:
            flat = pool.map(_render_one, jobs, chunksize=2)
    out, k = [], 0
    for poses in trajectories:
        out.append(np.stack(flat[k:k + len(poses)]))
        k += len(poses)
    return out


def render_frames(cam: Lens, poses: np.ndarray, scene: Scene,
                  workers: Optional[int] = None) -> np.ndarray:
    """(F, H, W) uint8 frames through the lens, over `workers` spawned
    processes (one per core, at most 8, by default)."""
    return render_many(cam, [poses], [scene], workers)[0]


CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".cache", "frames")


def fixed_sequences(cell, seed: int, workers: Optional[int] = None):
    """([(frames, ground-truth Tcw) per sequence of the mix's set], first
    entry): sequence i from `scene_seeds[i]` and `trajectory_seeds[i]`, the
    entry the first session plays drawn from the seed.  The set does not
    depend on the seed, so it is rendered once and read from the cache
    after that."""
    t = cell.traffic
    sc, tj = t["scene"], t["trajectory"]
    lens = Lens.of(cell.config["system"]["camera"])
    pool = list(zip(t["scene_seeds"], t["trajectory_seeds"]))
    first = int(np.random.default_rng(seed).integers(len(pool)))
    trajs = [make_loop_trajectory(t["frames"], tj["cam_radius_m"],
                                  tj["look_radius_m"], tj["frac"], seed=ts)
             for _s, ts in pool]
    key = hashlib.sha256(json.dumps(
        [lens.__dict__, sc, tj, t["frames"], pool,
         inspect.getsource(sys.modules[__name__])],
        sort_keys=True).encode()).hexdigest()
    paths = [os.path.join(CACHE, f"{key[:24]}-{i}.npy")
             for i in range(len(pool))]
    if all(os.path.isfile(p) for p in paths):
        frames = [np.load(p) for p in paths]
    else:
        scenes = [make_cylinder_scene(sc["n_points"], sc["radius_m"],
                                      sc["height_m"], seed=ss)
                  for ss, _t in pool]
        frames = render_many(lens, trajs, scenes, workers)
        os.makedirs(CACHE, exist_ok=True)
        for p, f in zip(paths, frames):
            tmp = f"{p}.{os.getpid()}.tmp"
            with open(tmp, "wb") as fh:
                np.save(fh, f)
            os.replace(tmp, p)
    return list(zip(frames, trajs)), first
