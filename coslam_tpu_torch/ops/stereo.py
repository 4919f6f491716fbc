"""Stereo keypoint matching and RGB-D depth association (port of
coslam_tpu/ops/stereo.py, whole).

Reference Frame::ComputeStereoMatches (ORB_SLAM2/src/Frame.cc:467-643) and
Frame::ComputeStereoFromRGBD (:644).  The row-banded candidate search is
the dense (N, N) Hamming matcher with the row band, the disparity range
and the octave gate as masks; sub-pixel refinement is an 11x11 zero-mean
SAD over 11 shifts and a parabola fit.  All plain torch: neither is a
Pallas kernel in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from coslam_tpu_torch.config import CameraConfig, ExtractorConfig, \
    MatcherConfig
from coslam_tpu_torch.ops import matching


class StereoDepth(NamedTuple):
    u_right: torch.Tensor  # (N,) matched right-image x coord (-1 invalid)
    depth: torch.Tensor    # (N,) metric depth (0 invalid)
    valid: torch.Tensor    # (N,) bool


@functools.lru_cache(maxsize=None)
def _scales(scale_factors: Tuple[float, ...], device: torch.device):
    return torch.tensor(scale_factors, dtype=torch.float32, device=device)


def match_stereo(cam: CameraConfig, ecfg: ExtractorConfig,
                 mcfg: MatcherConfig, kpsL, kpsR, img_left=None,
                 img_right=None) -> StereoDepth:
    """kpsL / kpsR: keypoint SoA dicts of the two rectified views (uv /
    level / desc / valid).  Matches along epipolar rows with the disparity
    gated to (0.1, bf / 0.3); returns per-left-keypoint right coordinate
    and depth."""
    uvL, uvR = kpsL["uv"], kpsR["uv"]
    scales = _scales(tuple(ecfg.scale_factors), uvL.device)
    # row band: |vL - vR| <= 2 sigma at the left keypoint's octave
    r = 2.0 * scales[torch.clamp(kpsL["level"], 0,
                                 len(ecfg.scale_factors) - 1).long()]
    row_ok = (uvL[:, 1:2] - uvR[None, :, 1]).abs() <= r[:, None]
    disp = uvL[:, 0:1] - uvR[None, :, 0]
    min_d, max_d = 0.1, (cam.bf / 0.3 if cam.bf > 0 else 1e6)
    disp_ok = (disp > min_d) & (disp < max_d)
    lvl_ok = matching.level_mask(kpsL["level"], kpsR["level"], -1, 1)
    mm = matching.match(kpsL["desc"], kpsL["valid"], kpsR["desc"],
                        kpsR["valid"], mcfg, mask=row_ok & disp_ok & lvl_ok,
                        max_dist=mcfg.th_high, mutual=True)
    uR = uvR[torch.clamp(mm.idx, min=0).long(), 0]
    if img_left is not None and img_right is not None:
        uR = _sad_subpixel(img_left.to(torch.float32),
                           img_right.to(torch.float32), uvL, uR)
    d = uvL[:, 0] - uR
    valid = mm.valid & (d > min_d)
    depth = torch.where(valid, cam.bf / torch.clamp(d, min=1e-6), 0.0)
    return StereoDepth(u_right=torch.where(valid, uR, -1.0), depth=depth,
                       valid=valid)


_SAD_W = 5       # half window (11 x 11), reference Frame.cc:556
_SAD_SHIFT = 5   # +/- search, reference Frame.cc:557


def _sad_windows(imgL: torch.Tensor, imgR: torch.Tensor, uvL, uR):
    """Per keypoint: the 11x11 left patch, the 11 candidate 11x11 right
    windows and the right strip's clipped left column xr0 (window origins
    clipped into the image as the reference's dynamic_slice does)."""
    W, S = _SAD_W, _SAD_SHIFT
    h, w = imgL.shape
    dev = imgL.device
    xL = torch.round(uvL[:, 0]).to(torch.int64)
    yL = torch.round(uvL[:, 1]).to(torch.int64)
    xR = torch.round(uR).to(torch.int64)
    y0 = torch.clamp(yL - W, 0, h - (2 * W + 1))
    xl0 = torch.clamp(xL - W, 0, w - (2 * W + 1))
    xr0 = torch.clamp(xR - W - S, 0, w - (2 * W + 2 * S + 1))
    a_w = torch.arange(2 * W + 1, device=dev)
    a_s = torch.arange(2 * W + 2 * S + 1, device=dev)
    rows = (y0[:, None] + a_w[None])[:, :, None]              # (N, 11, 1)
    pl = imgL[rows, (xl0[:, None] + a_w[None])[:, None, :]]   # (N, 11, 11)
    strip = imgR[rows, (xr0[:, None] + a_s[None])[:, None, :]]  # (N, 11, 21)
    # (N, 11 rows, 11 shifts, 11 cols) -> (N, 11 shifts, 11 rows, 11 cols)
    cands = strip.unfold(2, 2 * W + 1, 1).permute(0, 2, 1, 3)
    return pl, cands, xr0


def _sad_subpixel(imgL: torch.Tensor, imgR: torch.Tensor, uvL, uR):
    """Sub-pixel disparity by an SAD sliding window + parabola fit around
    the descriptor match (reference Frame::ComputeStereoMatches,
    Frame.cc:540-620)."""
    W, S = _SAD_W, _SAD_SHIFT
    pl, cands, xr0 = _sad_windows(imgL, imgR, uvL, uR)
    # zero-mean SAD (robust to brightness offset)
    plz = pl - pl.mean(dim=(1, 2), keepdim=True)
    cz = cands - cands.mean(dim=(2, 3), keepdim=True)
    sad = (cz - plz[:, None]).abs().sum(dim=(2, 3))          # (N, 11)
    best = torch.argmin(sad, dim=1)
    bi = torch.clamp(best, 1, 2 * S - 1)
    sm1 = torch.gather(sad, 1, (bi - 1)[:, None])[:, 0]
    s0 = torch.gather(sad, 1, bi[:, None])[:, 0]
    sp1 = torch.gather(sad, 1, (bi + 1)[:, None])[:, 0]
    denom = sm1 - 2 * s0 + sp1
    delta = torch.where(denom.abs() > 1e-6,
                        0.5 * (sm1 - sp1) / torch.where(
                            denom.abs() < 1e-6, 1.0, denom), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    # window bi's centre column in the right image
    refined = (xr0 + W + bi).to(torch.float32) + delta
    # the raw estimate where the argmin hit the search border
    ok = (best >= 1) & (best <= 2 * S - 1)
    return torch.where(ok, refined, uR)


def rgbd_depth(cam: CameraConfig, uv, kp_valid, depth_img,
               depth_factor: float = 1.0) -> StereoDepth:
    """Associate keypoints with sensor depth (reference
    Frame::ComputeStereoFromRGBD, Frame.cc:644): nearest-pixel lookup with
    a hole mask; the virtual right coordinate is u - bf / d."""
    h, w = depth_img.shape
    x = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_img[y, x].to(torch.float32) * depth_factor
    valid = kp_valid & (d > 0.05)
    if cam.bf > 0:
        u_right = torch.where(valid, uv[:, 0] - cam.bf
                              / torch.clamp(d, min=1e-6), -1.0)
    else:
        u_right = torch.full_like(d, -1.0)
    return StereoDepth(u_right=u_right, depth=torch.where(valid, d, 0.0),
                       valid=valid)
