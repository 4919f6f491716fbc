"""Dataset readers (TUM RGB-D, EuRoC, KITTI odometry), trajectory export,
and writers of the three dataset layouts (port of coslam_tpu/utils/io.py).

Replaces the reference's ROS-topic input (ros_mono.cc:27, /cam2/image_raw)
with offline dataset drivers, and mirrors its trajectory writers:
System::SaveTrajectoryTUM (ORB_SLAM2/src/System.cc:325),
SaveKeyFrameTrajectoryTUM (:386), SaveTrajectoryKITTI (:422).

Host-side only: file IO and Pillow, imported where an image is read or
written.  The layout writers build a dataset directory from arrays (the
tests and chip_smoke.py render synthetic sequences into them); each is the
inverse of its loader.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.utils import geometry as geo


@dataclass
class SequenceFrame:
    timestamp: float
    rgb_path: str
    depth_path: Optional[str] = None
    right_path: Optional[str] = None


@dataclass
class Sequence:
    frames: List[SequenceFrame]
    gt_timestamps: Optional[np.ndarray] = None
    gt_poses_wc: Optional[np.ndarray] = None  # (F, 4, 4) camera-to-world
    depth_factor: float = 1.0
    # calibration read from the dataset itself (EuRoC sensor.yaml); None
    # means "use the preset config" (the reference reads calibration from
    # its settings YAML the same way, Tracking.cc:60-104)
    camera: Optional[CameraConfig] = None


def load_image(path: str) -> np.ndarray:
    """Grayscale uint8 image."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def load_depth(path: str, factor: float) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32) / factor


def _gt_poses(t_wc: np.ndarray, q_wxyz: np.ndarray) -> np.ndarray:
    """(F, 4, 4) float32 camera-to-world poses from positions and (w, x, y,
    z) quaternions, the rotations computed in float32."""
    R = geo.quat_to_rot(torch.as_tensor(q_wxyz, dtype=torch.float32)).numpy()
    poses = np.tile(np.eye(4, dtype=np.float32), (len(t_wc), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t_wc
    return poses


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

def _read_tum_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def load_tum_rgbd(root: str, max_dt: float = 0.02) -> Sequence:
    """TUM RGB-D layout: rgb.txt, depth.txt, groundtruth.txt.  RGB / depth
    associated by the nearest timestamp (the standard associate.py
    policy; the first on ties)."""
    rgb = _read_tum_list(os.path.join(root, "rgb.txt"))
    depth_file = os.path.join(root, "depth.txt")
    depth = _read_tum_list(depth_file) if os.path.exists(depth_file) else []
    frames = []
    d_ts = np.array([t for t, _ in depth]) if depth else None
    for t, rel in rgb:
        dp = None
        if d_ts is not None and len(d_ts):
            j = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[j] - t) <= max_dt:
                dp = os.path.join(root, depth[j][1])
        frames.append(SequenceFrame(t, os.path.join(root, rel), dp))

    gt_path = os.path.join(root, "groundtruth.txt")
    gt_ts, gt_poses = None, None
    if os.path.exists(gt_path):
        rows = []
        with open(gt_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        arr = np.asarray(rows)
        gt_ts = arr[:, 0]
        # TUM: tx ty tz qx qy qz qw (camera-to-world)
        gt_poses = _gt_poses(arr[:, 1:4], np.concatenate(
            [arr[:, 7:8], arr[:, 4:7]], 1))
    return Sequence(frames=frames, gt_timestamps=gt_ts, gt_poses_wc=gt_poses,
                    depth_factor=5000.0)


# ---------------------------------------------------------------------------
# KITTI odometry
# ---------------------------------------------------------------------------

def load_kitti(root: str, sequence: str = "00") -> Sequence:
    """KITTI odometry layout: sequences/<seq>/image_0, image_1, times.txt;
    poses/<seq>.txt (3x4 camera-to-world rows)."""
    seq_dir = os.path.join(root, "sequences", sequence)
    left_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f]
    names = sorted(os.listdir(left_dir))
    frames = [SequenceFrame(
        t, os.path.join(left_dir, n),
        right_path=os.path.join(right_dir, n)
        if os.path.isdir(right_dir) else None)
        for t, n in zip(times, names)]
    gt_ts, gt_poses = None, None
    pose_file = os.path.join(root, "poses", sequence + ".txt")
    if os.path.exists(pose_file):
        rows = np.loadtxt(pose_file).reshape(-1, 3, 4)
        gt_poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
        gt_poses[:, :3, :] = rows
        gt_ts = np.asarray(times[: len(rows)])
    return Sequence(frames=frames, gt_timestamps=gt_ts, gt_poses_wc=gt_poses)


# ---------------------------------------------------------------------------
# EuRoC MAV
# ---------------------------------------------------------------------------

def _parse_euroc_sensor_yaml(path: str) -> Optional[CameraConfig]:
    """Parse the flat fields of EuRoC's mav0/cam0/sensor.yaml (intrinsics
    [fu fv cu cv], distortion_coefficients [k1 k2 p1 p2], resolution) into
    a CameraConfig.  Hand-rolled: the file is simple flow-style YAML and
    this avoids a parser dependency."""
    with open(path) as f:
        txt = f.read()

    def vec(name):
        mm = re.search(name + r":\s*\[([^\]]*)\]", txt)
        return [float(x) for x in mm.group(1).split(",")] if mm else None

    intr = vec("intrinsics")
    dist = vec("distortion_coefficients")
    resol = vec("resolution")
    rate = re.search(r"rate_hz:\s*([0-9.]+)", txt)
    if not intr or not resol:
        return None
    k1, k2, p1, p2 = (dist + [0.0] * 4)[:4] if dist else (0.0,) * 4
    return CameraConfig(
        fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3],
        k1=k1, k2=k2, p1=p1, p2=p2,
        width=int(resol[0]), height=int(resol[1]),
        fps=float(rate.group(1)) if rate else 20.0)


def load_euroc(root: str) -> Sequence:
    """EuRoC layout: mav0/cam0/data/<ns>.png + data.csv;
    mav0/state_groundtruth_estimate0/data.csv.  Calibration is read from
    mav0/cam0/sensor.yaml when present (the dataset's own convention)."""
    cam_dir = os.path.join(root, "mav0", "cam0")
    right_dir = os.path.join(root, "mav0", "cam1", "data")
    has_right = os.path.isdir(right_dir)
    frames = []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            ns, name = line.strip().split(",")[:2]
            right = os.path.join(right_dir, name) if has_right else None
            if right is not None and not os.path.exists(right):
                right = None
            frames.append(SequenceFrame(
                float(ns) * 1e-9, os.path.join(cam_dir, "data", name),
                right_path=right))
    gt_ts, gt_poses = None, None
    gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                          "data.csv")
    if os.path.exists(gt_csv):
        rows = []
        with open(gt_csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.strip().split(",")[:8]])
        arr = np.asarray(rows)
        gt_ts = arr[:, 0] * 1e-9
        gt_poses = _gt_poses(arr[:, 1:4], arr[:, 4:8])  # EuRoC: qw qx qy qz
    yaml_path = os.path.join(cam_dir, "sensor.yaml")
    camera = _parse_euroc_sensor_yaml(yaml_path) \
        if os.path.exists(yaml_path) else None
    return Sequence(frames=frames, gt_timestamps=gt_ts, gt_poses_wc=gt_poses,
                    camera=camera)


# ---------------------------------------------------------------------------
# Trajectory export (reference System.cc:325-470)
# ---------------------------------------------------------------------------

def save_trajectory_tum(path: str, timestamps, poses_cw) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` of camera-to-world."""
    poses_cw = np.asarray(poses_cw)
    R_wc = np.swapaxes(poses_cw[:, :3, :3], 1, 2)
    t_wc = -np.einsum("nij,nj->ni", R_wc, poses_cw[:, :3, 3])
    q = geo.rot_to_quat(torch.as_tensor(R_wc, dtype=torch.float32)).numpy()
    with open(path, "w") as f:
        for ts, t, qq in zip(timestamps, t_wc, q):
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{qq[1]:.7f} {qq[2]:.7f} {qq[3]:.7f} {qq[0]:.7f}\n")


def save_trajectory_kitti(path: str, poses_cw) -> None:
    """KITTI format: 12 values per row of the 3x4 camera-to-world matrix."""
    poses_cw = np.asarray(poses_cw)
    with open(path, "w") as f:
        for T in poses_cw:
            R_wc = T[:3, :3].T
            t_wc = -R_wc @ T[:3, 3]
            M = np.concatenate([R_wc, t_wc[:, None]], 1)
            f.write(" ".join(f"{v:.7e}" for v in M.reshape(-1)) + "\n")


def load_trajectory_tum(path: str):
    """Inverse of save_trajectory_tum -> (timestamps, poses_cw)."""
    rows = np.loadtxt(path).reshape(-1, 8)
    ts = rows[:, 0]
    q_wxyz = np.concatenate([rows[:, 7:8], rows[:, 4:7]], 1)
    R_wc = geo.quat_to_rot(torch.as_tensor(q_wxyz, dtype=torch.float32)
                           ).numpy()
    poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
    R_cw = np.swapaxes(R_wc, 1, 2)
    poses[:, :3, :3] = R_cw
    poses[:, :3, 3] = -np.einsum("nij,nj->ni", R_cw, rows[:, 1:4])
    return ts, poses


# ---------------------------------------------------------------------------
# Layout writers (the loaders' inverses)
# ---------------------------------------------------------------------------

def save_image(path: str, img: np.ndarray) -> None:
    """PNG of a uint8 (H, W) gray or (H, W, 3) RGB image, or of a uint16
    (H, W) depth image, with Pillow's default encoder."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.ascontiguousarray(img)).save(path)


def _quat_rows(poses_wc: np.ndarray) -> np.ndarray:
    """(F, 7) rows tx ty tz qw qx qy qz of camera-to-world poses (the
    quaternions in float64)."""
    P = np.asarray(poses_wc, np.float64)
    q = geo.rot_to_quat(torch.as_tensor(P[:, :3, :3])).numpy()
    return np.concatenate([P[:, :3, 3], q], 1)


def write_tum_rgbd(root: str, timestamps, images, depths=None,
                   depth_timestamps=None, poses_wc=None) -> None:
    """TUM RGB-D layout: rgb/<t>.png, depth/<t>.png (uint16 arrays as
    stored: metres times 5000), rgb.txt, depth.txt and groundtruth.txt
    (poses at the rgb timestamps), each list under TUM's comment lines."""

    def write_list(name, kind, stamps, rels):
        with open(os.path.join(root, name), "w") as f:
            f.write(f"# {kind}\n# file: 'synthetic'\n# timestamp filename\n")
            for t, rel in zip(stamps, rels):
                f.write(f"{t:.6f} {rel}\n")

    os.makedirs(root, exist_ok=True)
    rels = [f"rgb/{t:.6f}.png" for t in timestamps]
    for rel, img in zip(rels, images):
        save_image(os.path.join(root, rel), img)
    write_list("rgb.txt", "color images", timestamps, rels)
    if depths is not None:
        d_rels = [f"depth/{t:.6f}.png" for t in depth_timestamps]
        for rel, d in zip(d_rels, depths):
            save_image(os.path.join(root, rel), d)
        write_list("depth.txt", "depth maps", depth_timestamps, d_rels)
    if poses_wc is not None:
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("# ground truth trajectory\n# file: 'synthetic'\n"
                    "# timestamp tx ty tz qx qy qz qw\n")
            for t, r in zip(timestamps, _quat_rows(poses_wc)):
                vals = list(r[:3]) + list(r[4:]) + [r[3]]
                f.write(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in vals)
                        + "\n")


def write_kitti(root: str, times, left, right=None, poses_wc=None,
                sequence: str = "00") -> None:
    """KITTI odometry layout: sequences/<seq>/image_0 (and image_1) as
    <index>.png, times.txt, and poses/<seq>.txt (3x4 camera-to-world
    rows)."""
    seq_dir = os.path.join(root, "sequences", sequence)
    os.makedirs(seq_dir, exist_ok=True)
    for sub, imgs in (("image_0", left), ("image_1", right)):
        for i, img in enumerate(imgs if imgs is not None else ()):
            save_image(os.path.join(seq_dir, sub, f"{i:06d}.png"), img)
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.writelines(f"{t:.6e}\n" for t in times)
    if poses_wc is not None:
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        with open(os.path.join(root, "poses", sequence + ".txt"), "w") as f:
            for T in np.asarray(poses_wc, np.float64):
                f.write(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1))
                        + "\n")


def write_euroc(root: str, stamps_ns, left, right=None,
                camera: Optional[CameraConfig] = None, poses_wc=None) -> None:
    """EuRoC layout: mav0/cam0/data/<ns>.png with data.csv (cam1 alike),
    mav0/cam0/sensor.yaml with `camera`'s calibration, and
    mav0/state_groundtruth_estimate0/data.csv (poses at the image
    stamps; velocities and biases zero)."""
    mav = os.path.join(root, "mav0")
    for cam, imgs in (("cam0", left), ("cam1", right)):
        if imgs is None:
            continue
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
        for ns, img in zip(stamps_ns, imgs):
            save_image(os.path.join(mav, cam, "data", f"{ns}.png"), img)
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            f.writelines(f"{ns},{ns}.png\n" for ns in stamps_ns)
    if camera is not None:
        c = camera
        with open(os.path.join(mav, "cam0", "sensor.yaml"), "w") as f:
            f.write(
                "# General sensor definitions.\nsensor_type: camera\n"
                "comment: VI-Sensor cam0 (MT9M034)\n\n"
                "# Sensor extrinsics wrt. the body-frame.\nT_BS:\n"
                "  cols: 4\n  rows: 4\n"
                "  data: [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,\n"
                "         0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]\n\n"
                "# Camera specific definitions.\n"
                f"rate_hz: {c.fps!r}\n"
                f"resolution: [{c.width}, {c.height}]\n"
                "camera_model: pinhole\n"
                f"intrinsics: [{c.fx!r}, {c.fy!r}, {c.cx!r}, {c.cy!r}] "
                "#fu, fv, cu, cv\n"
                "distortion_model: radial-tangential\n"
                f"distortion_coefficients: [{c.k1!r}, {c.k2!r}, {c.p1!r}, "
                f"{c.p2!r}]\n")
    if poses_wc is not None:
        d = os.path.join(mav, "state_groundtruth_estimate0")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                    "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], "
                    "v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], "
                    "v_RS_R_z [m s^-1], b_w_RS_S_x [rad s^-1], "
                    "b_w_RS_S_y [rad s^-1], b_w_RS_S_z [rad s^-1], "
                    "b_a_RS_S_x [m s^-2], b_a_RS_S_y [m s^-2], "
                    "b_a_RS_S_z [m s^-2]\n")
            for ns, r in zip(stamps_ns, _quat_rows(poses_wc)):
                f.write(f"{ns}," + ",".join(f"{v:.9f}" for v in r)
                        + ",0,0,0,0,0,0,0,0,0\n")
