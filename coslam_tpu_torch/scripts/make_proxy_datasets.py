"""Proxy datasets in the TUM RGB-D / KITTI odometry / EuRoC ASL on-disk
layouts, rendered from synthetic scenes (port of
scripts/make_proxy_datasets.py: the same cameras, scenes, trajectories, file
names, header lines and number formats, so both write the same tree for the
same `--frames` and `--seed`).

Without network access the real sequences (TUM fr1_xyz / fr1_desk, KITTI
00, EuRoC MH01; BASELINE.md) cannot be downloaded.  These directories
drive the real dataset path end to end: image files on disk, timestamp
association, ground-truth quaternion parsing, the CLI, trajectory
export and ATE.  With the real sequences (scripts/fetch_datasets.sh) the same
CLI commands run on them unchanged.

Layouts (read by coslam_tpu_torch/utils/io.py):
  tum_proxy/     rgb/*.png depth/*.png rgb.txt depth.txt groundtruth.txt
  kitti_proxy/   sequences/00/{image_0,image_1}/*.png times.txt poses/00.txt
  euroc_proxy/   mav0/cam0/{data/*.png,data.csv,sensor.yaml}
                 mav0/state_groundtruth_estimate0/data.csv

The ground-truth quaternions come from `geometry.rot_to_quat` in float32 on
`--device`.

    python -m coslam_tpu_torch.scripts.make_proxy_datasets [--out datasets] \
        [--frames 120] [--seed 11] [--only tum|kitti|euroc] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.utils import geometry as geo
from coslam_tpu_torch.utils import synthetic
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

FPS = 30.0
DEPTH_FACTOR = 5000.0  # TUM depth png scale


def _save_png(path: str, arr: np.ndarray):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _pose_wc(Tcw: np.ndarray):
    R_wc = Tcw[:3, :3].T
    t_wc = -R_wc @ Tcw[:3, 3]
    return R_wc, t_wc


def _quat_wxyz(R: np.ndarray, dev: torch.device) -> np.ndarray:
    return geo.rot_to_quat(torch.as_tensor(
        R[None], dtype=torch.float32, device=dev))[0].cpu().numpy()


def make_tum(root: str, n_frames: int, seed: int, dev: torch.device):
    cam = CameraConfig(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                       k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026,
                       k3=1.1633, width=640, height=480, fps=FPS)
    scene = synthetic.make_scene(900, seed=seed)
    traj = synthetic.make_trajectory(n_frames, seed=seed)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n_frames):
        t = i / FPS
        img = synthetic.render_frame(cam, traj.poses_cw[i], scene,
                                     distort=True)
        name = f"{t:.6f}.png"
        _save_png(os.path.join(root, "rgb", name), img)
        rgb_lines.append(f"{t:.6f} rgb/{name}")
        depth = synthetic.render_depth(cam, traj.poses_cw[i], scene,
                                       distort=True)
        d16 = np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)
        _save_png(os.path.join(root, "depth", name), d16)
        depth_lines.append(f"{t:.6f} depth/{name}")
        R_wc, t_wc = _pose_wc(traj.poses_cw[i])
        q = _quat_wxyz(R_wc, dev)  # wxyz
        gt_lines.append(f"{t:.6f} {t_wc[0]:.6f} {t_wc[1]:.6f} {t_wc[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    for fn, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                      ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, fn), "w") as f:
            f.write("# proxy dataset (synthetic render, TUM layout)\n")
            f.write("\n".join(lines) + "\n")
    print(f"TUM proxy: {n_frames} frames -> {root}")


def make_kitti(root: str, n_frames: int, seed: int, dev: torch.device):
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                       width=1241, height=376, fps=10.0, bf=386.1448)
    baseline = cam.bf / cam.fx
    scene = synthetic.make_scene(
        1200, seed=seed, box=((-9.0, 9.0), (-3.0, 3.0), (5.0, 20.0)))
    traj = synthetic.make_trajectory(n_frames, seed=seed)
    seq_dir = os.path.join(root, "sequences", "00")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    times, pose_rows = [], []
    for i in range(n_frames):
        left, right = synthetic.render_stereo_frame(
            cam, traj.poses_cw[i], scene, baseline)
        name = f"{i:06d}.png"
        _save_png(os.path.join(seq_dir, "image_0", name), left)
        _save_png(os.path.join(seq_dir, "image_1", name), right)
        times.append(i / 10.0)
        R_wc, t_wc = _pose_wc(traj.poses_cw[i])
        M = np.concatenate([R_wc, t_wc[:, None]], 1)
        pose_rows.append(" ".join(f"{v:.6e}" for v in M.reshape(-1)))
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6e}" for t in times) + "\n")
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        f.write("\n".join(pose_rows) + "\n")
    print(f"KITTI proxy: {n_frames} stereo frames -> {root}")


def make_euroc(root: str, n_frames: int, seed: int, dev: torch.device):
    # mild barrel: the splat renderer is first-order-consistent under
    # distortion, so the proxy uses a gentler lens than the real MH01 and
    # writes the matching calibration to sensor.yaml (which the loader
    # reads, exactly as with real EuRoC data)
    cam = CameraConfig(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                       k1=-0.10, k2=0.01, width=752, height=480, fps=20.0)
    scene = synthetic.make_scene(900, seed=seed)
    # wider sweep: EuRoC's wide FOV halves pixel parallax per meter of
    # translation vs the TUM intrinsics; the real MH01 is translation-rich,
    # so the proxy must clear the initializer's ~1-degree parallax gate
    # comfortably, not marginally
    traj = synthetic.make_trajectory(n_frames, radius=3.5, seed=seed)
    cam_dir = os.path.join(root, "mav0", "cam0", "data")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    cam_lines = ["#timestamp [ns],filename"]
    gt_lines = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i in range(n_frames):
        ns = int(i / 20.0 * 1e9)
        img = synthetic.render_frame(cam, traj.poses_cw[i], scene,
                                     distort=True)
        name = f"{ns}.png"
        _save_png(os.path.join(cam_dir, name), img)
        cam_lines.append(f"{ns},{name}")
        R_wc, t_wc = _pose_wc(traj.poses_cw[i])
        q = _quat_wxyz(R_wc, dev)
        gt_lines.append(f"{ns},{t_wc[0]:.6f},{t_wc[1]:.6f},{t_wc[2]:.6f},"
                        f"{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},{q[3]:.6f}")
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("\n".join(cam_lines) + "\n")
    with open(os.path.join(root, "mav0", "cam0", "sensor.yaml"), "w") as f:
        f.write(
            "sensor_type: camera\n"
            "rate_hz: 20\n"
            f"resolution: [{cam.width}, {cam.height}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{cam.fx}, {cam.fy}, {cam.cx}, {cam.cy}]\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: [{cam.k1}, {cam.k2}, {cam.p1}, "
            f"{cam.p2}]\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    print(f"EuRoC proxy: {n_frames} frames -> {root}")


def make_all(out: str, frames: int = 120, seed: int = 11, only=None,
             device=DEFAULT_DEVICE) -> None:
    dev = resolve_device(device)
    if only in (None, "tum"):
        make_tum(os.path.join(out, "tum_proxy"), frames, seed, dev)
    if only in (None, "kitti"):
        make_kitti(os.path.join(out, "kitti_proxy"), frames, seed, dev)
    if only in (None, "euroc"):
        make_euroc(os.path.join(out, "euroc_proxy"), frames, seed, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="datasets", help="output root")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--only", choices=["tum", "kitti", "euroc"], default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)
    make_all(args.out, args.frames, args.seed, args.only, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
