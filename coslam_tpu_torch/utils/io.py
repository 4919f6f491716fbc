"""Trajectory export (port of coslam_tpu/utils/io.py: `save_trajectory_tum`
and `save_trajectory_kitti`).  The dataset loaders wait for ROADMAP Queue 1
item 17."""

from __future__ import annotations

import numpy as np
import torch

from coslam_tpu_torch.utils import geometry as geo


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
