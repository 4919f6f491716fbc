"""The flagship per-frame tracking step (port of __graft_entry__.py:20-66).

`entry(device)` returns `(track_step, example_args)`: ORB extraction of one
640x480 frame (kernel K1), windowed matching of its keypoints against the
previous frame's within 20 px with the mutual check (kernel K2, forward and
reverse), and motion-only bundle adjustment on the associated landmarks
(kernel K3) — the tracking hot path.  `extract_step` and
`extract_match_step` are its two nested prefixes, which the bench times to
split the step into stages (bench.py:102-113).

Every function here is safe to capture in a CUDA graph once it has run
(the tables it builds on its first call are cached): nothing reads back to
the host and no Python constant is copied to the device per call.
"""

from __future__ import annotations

import numpy as np
import torch

from coslam_tpu_torch.config import CameraConfig, SystemConfig
from coslam_tpu_torch.models.frame import build_frame
from coslam_tpu_torch.ops import matching
from coslam_tpu_torch.optim import pose_opt
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

WINDOW_PX = 20.0


def hot_path_config() -> SystemConfig:
    """A 640x480 camera (fx = fy = 500, centred) and otherwise the default
    configuration (`__graft_entry__._cfg`)."""
    cam = CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                       width=640, height=480)
    return SystemConfig(camera=cam)


HOT_PATH = hot_path_config()


def _match_previous(frame, prev_uv, prev_desc, prev_valid,
                    cfg: SystemConfig) -> matching.Matches:
    return matching.match_windowed(
        prev_desc, prev_uv, WINDOW_PX, prev_valid, frame.desc, frame.uv,
        frame.valid, cfg.matcher, max_dist=cfg.matcher.th_high, mutual=True)


def track_step(img, prev_uv, prev_desc, prev_valid, prev_level, pt_pos,
               T_pred, cfg: SystemConfig = HOT_PATH):
    """One frame of the tracking hot path: extract ORB features, match them
    to the previous frame's keypoints within a motion window, and run
    motion-only bundle adjustment on the associated landmarks.  Returns
    (T (4, 4), n_inliers (), desc (N, 8) int32).  `prev_level` is taken
    and unused, as in the reference."""
    frame = build_frame(img, cfg)
    mm = _match_previous(frame, prev_uv, prev_desc, prev_valid, cfg)
    X = pt_pos[:cfg.extractor.max_keypoints]
    uv_obs = frame.uv[torch.clamp(mm.idx, min=0).long()]
    res = pose_opt.optimize_pose(cfg.camera, T_pred, X, uv_obs, mm.valid,
                                 frame.inv_sigma2, cfg.tracker)
    return res.T, res.n_inliers, frame.desc


def extract_step(img, cfg: SystemConfig = HOT_PATH):
    """The extraction stage alone: the frame's valid keypoint count."""
    return build_frame(img, cfg).valid.sum()


def extract_match_step(img, prev_uv, prev_desc, prev_valid,
                       cfg: SystemConfig = HOT_PATH):
    """Extraction and matching: the count of mutual matches."""
    frame = build_frame(img, cfg)
    return _match_previous(frame, prev_uv, prev_desc, prev_valid,
                           cfg).valid.sum()


def example_arrays(n: int):
    """The reference's example arguments as numpy arrays, drawn from
    default_rng(0) in its order and dtypes; the uint32 descriptors as their
    int32 view (the port's descriptor layout)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (480, 640), dtype=np.uint8)
    return (
        img,
        rng.uniform(0, 600, (n, 2)).astype(np.float32),
        rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32),
        np.ones(n, bool),
        np.zeros(n, np.int32),
        np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32),
        np.eye(4, dtype=np.float32),
    )


def entry(device=DEFAULT_DEVICE):
    """(track_step, example_args): the step and its example arguments as
    tensors on `device` (the GPU unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in example_arrays(HOT_PATH.extractor.max_keypoints))
    return track_step, args
