"""Image pyramid (port of coslam_tpu/ops/pyramid.py: `level_shapes`,
`build_pyramid`).

Each level is resized from level 0 as two matmuls with the reference's
numpy bilinear weight matrices, rebuilt here bit for bit."""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import ExtractorConfig


def level_shapes(h: int, w: int, cfg: ExtractorConfig) -> List[Tuple[int, int]]:
    """Static per-level image shapes (rounded like cv::resize)."""
    shapes = []
    for lvl in range(cfg.n_levels):
        inv = 1.0 / (cfg.scale_factor ** lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 anti-aliased bilinear resize matrix
    (align_corners False; the same numpy code as the reference's)."""
    scale = n_in / n_out          # >1 when downscaling
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    support = max(scale, 1.0)
    dist = np.abs(centers[:, None] - np.arange(n_in)[None, :]) / support
    w = np.clip(1.0 - dist, 0.0, None).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device):
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device)


def build_pyramid(img: torch.Tensor, cfg: ExtractorConfig) -> List[torch.Tensor]:
    """uint8/float (H, W) -> list of float32 levels (level 0 = input):
    R_h @ img @ R_w^T per level."""
    img = img.to(torch.float32)
    h, w = img.shape
    out = [img]
    for (lh, lw) in level_shapes(h, w, cfg)[1:]:
        rh = _resize_weights_on(h, lh, img.device)
        rw = _resize_weights_on(w, lw, img.device)
        out.append((rh @ img) @ rw.T)
    return out
