"""FAST-9/16 corner scoring as whole-image tensor ops (port of coslam_tpu/
ops/fast.py).

score(p) = max over the 16 arc starts of the min signed difference along a
9-long contiguous arc of the radius-3 Bresenham circle, for both signs; > t
<=> p is a FAST corner at threshold t.  NMS keeps a score only where it
equals the 3x3 max.  These are the plain versions of kernel K1
(ops/cuda_kernels.fast_score_nms).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — (dy, dx) clockwise from 12 o'clock.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> (H, W) float32 FAST-9 corner score.  Border pixels
    (3 px) wrap via roll, as in the reference; callers mask borders."""
    circ = torch.stack([torch.roll(img, (-dy, -dx), (0, 1))
                        for dy, dx in CIRCLE])

    def arc_min9(d):
        # circular running min over windows of 9 along axis 0, log-step
        m = torch.minimum(d, torch.roll(d, -1, 0))   # win 2
        m = torch.minimum(m, torch.roll(m, -2, 0))   # win 4
        m = torch.minimum(m, torch.roll(m, -4, 0))   # win 8
        m = torch.minimum(m, torch.roll(d, -8, 0))   # win 9
        return m.amax(0)                             # best arc start

    return torch.maximum(arc_min9(circ - img), arc_min9(img - circ))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep score only at local maxima."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


@functools.lru_cache(maxsize=None)
def border_mask(h: int, w: int, margin: int) -> np.ndarray:
    """1 inside the detection region, 0 in the margin."""
    m = np.zeros((h, w), np.float32)
    m[margin:h - margin, margin:w - margin] = 1.0
    return m
