"""Frame construction: extraction + undistortion + per-octave information
(port of coslam_tpu/models/frame.py)."""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.ops import orb
from coslam_tpu_torch.utils import camera as cam_mod


class Frame(NamedTuple):
    uv: torch.Tensor          # (N, 2) f32 undistorted keypoint coords
    uv_raw: torch.Tensor      # (N, 2) f32 raw (distorted) coords
    level: torch.Tensor       # (N,) i32
    angle: torch.Tensor       # (N,) f32
    response: torch.Tensor    # (N,) f32
    desc: torch.Tensor        # (N, 8) i32 (uint32 bits)
    valid: torch.Tensor       # (N,) bool
    inv_sigma2: torch.Tensor  # (N,) f32 information by octave


@functools.lru_cache(maxsize=None)
def _inv_sigma2_table(level_sigma2: Tuple[float, ...], device: torch.device):
    return 1.0 / torch.tensor(level_sigma2, dtype=torch.float32, device=device)


def build_frame(img: torch.Tensor, cfg: SystemConfig) -> Frame:
    kp = orb.extract(img, cfg.extractor)
    uv_und = cam_mod.undistort_pixels(cfg.camera, kp["uv"])
    inv_s2 = _inv_sigma2_table(cfg.extractor.level_sigma2,
                               img.device)[kp["level"].long()]
    return Frame(uv=uv_und, uv_raw=kp["uv"], level=kp["level"],
                 angle=kp["angle"], response=kp["response"], desc=kp["desc"],
                 valid=kp["valid"], inv_sigma2=inv_s2)
