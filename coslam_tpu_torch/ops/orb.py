"""Oriented-FAST + rotated-BRIEF extraction (port of coslam_tpu/ops/orb.py:
`level_budgets`, `_select_level_keypoints`, `extract_patches`,
`_descriptors_from_patches`, `extract`).

FAST score + NMS + the edge-threshold border mask of every pyramid level in
one call (kernel K1), then per level the per-cell top-2 winners and a top-k
by score.  All levels' 39x39 raw patches then go through two f32 matmuls: IC
orientation and the Gaussian-blurred rBRIEF sample differences for 30
quantized rotations, the keypoint's rotation bin selecting its 8 packed
descriptor words.  The numpy tables (`brief_pattern`, `_patch_matrices`) are
the reference's, rebuilt bit for bit.  Descriptors are (N, 8) int32 holding
the reference's uint32 bits.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from coslam_tpu_torch.config import ExtractorConfig
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops import pyramid as pyr_ops

PATCH_RADIUS = 15  # reference HALF_PATCH_SIZE (ORBextractor.cc:73)
N_BITS = 256
DESC_WORDS = 8  # 256 bits packed into 8 32-bit words
N_ROT_BINS = 30
RAW_PATCH = 39   # radius 19 = cfg.edge_threshold margin
BLUR_PATCH = 33  # central region with valid 7x7 blur support


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) float32: per bit, two (x, y) offsets within radius 13
    (deterministic Gaussian BRIEF layout, norm-clipped)."""
    rng = np.random.default_rng(20160229)
    pts = rng.normal(0.0, PATCH_RADIUS / 2.2, size=(N_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    max_r = 13.0
    scale = np.where(norm > max_r, max_r / (norm + 1e-9), 1.0)
    return (pts * scale).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _patch_matrices():
    """Constant weight matrices of the patch pipeline (host-built once):
    moments (1521, 2), blur (1521, 1089), rotated BRIEF (1089, 30*256)."""
    rp, bp = RAW_PATCH, BLUR_PATCH
    rr, br = rp // 2, bp // 2

    ys, xs = np.mgrid[-rr:rr + 1, -rr:rr + 1]
    circ = ((xs ** 2 + ys ** 2) <= PATCH_RADIUS ** 2).astype(np.float32)
    w_moment = np.stack([(xs * circ).reshape(-1),
                         (ys * circ).reshape(-1)], 1)

    g = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    g /= g.sum()
    k2 = np.outer(g, g)
    w_blur = np.zeros((rp * rp, bp * bp), np.float32)
    for oy in range(bp):
        for ox in range(bp):
            cy, cx = oy + (rr - br), ox + (rr - br)
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    w_blur[(cy + dy) * rp + (cx + dx), oy * bp + ox] += \
                        k2[dy + 3, dx + 3]

    pat = brief_pattern()
    w_bits = np.zeros((bp * bp, N_ROT_BINS * N_BITS), np.float32)
    for b in range(N_ROT_BINS):
        th = 2.0 * np.pi * b / N_ROT_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pat[..., 0] * ca - pat[..., 1] * sa).astype(int) + br
        ry = np.round(pat[..., 0] * sa + pat[..., 1] * ca).astype(int) + br
        flat = ry * bp + rx
        for k in range(N_BITS):
            col = b * N_BITS + k
            w_bits[flat[k, 1], col] += 1.0   # +I(p_b)
            w_bits[flat[k, 0], col] -= 1.0   # -I(p_a);  bit = I(a) < I(b)
    return w_moment, w_blur, w_bits


@functools.lru_cache(maxsize=None)
def _patch_matrices_on(device: torch.device):
    # w_moment is float64 in numpy (int grid x f32 mask); the reference's
    # jax (x64 off) takes it as float32, exactly, since it holds small ints
    return tuple(torch.from_numpy(a).to(device, torch.float32)
                 for a in _patch_matrices())


def level_budgets(cfg: ExtractorConfig) -> List[int]:
    """Geometric per-level feature budgets (reference ORBextractor.cc:410-446)."""
    f = 1.0 / cfg.scale_factor
    n0 = cfg.n_features * (1 - f) / (1 - f ** cfg.n_levels)
    budgets = [int(round(n0 * f ** l)) for l in range(cfg.n_levels - 1)]
    budgets.append(max(cfg.n_features - sum(budgets), 0))
    return budgets


def _select_level_keypoints(score: torch.Tensor, budget: int, cell: int,
                            min_th: float):
    """Top-`budget` corners with per-cell (top-2) spatial capping.

    score: (H, W) NMS'd FAST score map, borders already zeroed.
    Returns (yx (budget, 2) int32, resp (budget,) f32, valid (budget,) bool).
    Ties resolve as in the reference: argmax takes the first index, and the
    top-k is a stable descending sort (lower index first among equals, as
    jax.lax.top_k)."""
    h, w = score.shape
    hc, wc = -(-h // cell), -(-w // cell)
    nc = hc * wc
    dev = score.device
    pad = torch.nn.functional.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cells = pad.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3) \
        .reshape(nc, cell * cell)

    rows = torch.arange(nc, device=dev)
    i1 = torch.argmax(cells, 1)
    m1 = cells[rows, i1]
    # a scatter of the number, not an index_put_ of a host tensor: nothing
    # is copied to the device (safe to capture in a CUDA graph)
    cells2 = cells.scatter(1, i1[:, None], -torch.inf)
    i2 = torch.argmax(cells2, 1)
    m2 = cells2[rows, i2]

    cand_score = torch.cat([m1, m2])
    cand_cell = torch.cat([rows, rows])
    cand_inner = torch.cat([i1, i2])
    cand_score = torch.where(cand_score > min_th, cand_score, -torch.inf)

    k = min(budget, cand_score.shape[0])
    top_score, top_idx = torch.sort(cand_score, descending=True, stable=True)
    top_score, top_idx = top_score[:k], top_idx[:k]
    cell_idx = cand_cell[top_idx]
    inner = cand_inner[top_idx]
    ys = (cell_idx // wc) * cell + inner // cell
    xs = (cell_idx % wc) * cell + inner % cell
    valid = torch.isfinite(top_score)
    if k < budget:
        padn = budget - k
        ys = torch.cat([ys, ys.new_zeros(padn)])
        xs = torch.cat([xs, xs.new_zeros(padn)])
        top_score = torch.cat([top_score, top_score.new_full((padn,), -torch.inf)])
        valid = torch.cat([valid, valid.new_zeros(padn)])
    return (torch.stack([ys, xs], 1).to(torch.int32),
            torch.where(valid, top_score, 0.0), valid)


def extract_patches(img: torch.Tensor, yx: torch.Tensor,
                    patch: int = RAW_PATCH) -> torch.Tensor:
    """(H, W) image + (K, 2) int yx centers -> (K, patch*patch) float32.

    The reference selects patch columns with a bf16 one-hot matmul on the
    TPU; here the patch is a direct f32 gather.  Both read the image as
    bf16: exact for the integer level 0, and the reference's rounding of
    the resampled levels (> 0) is kept so descriptors agree."""
    half = patch // 2
    h, w = img.shape
    src = img.to(torch.bfloat16).to(torch.float32)
    y0 = torch.clamp(yx[:, 0].long() - half, 0, h - patch)
    x0 = torch.clamp(yx[:, 1].long() - half, 0, w - patch)
    ar = torch.arange(patch, device=img.device)
    flat = (y0[:, None, None] + ar[None, :, None]) * w \
        + (x0[:, None, None] + ar[None, None, :])
    return src.reshape(-1)[flat.reshape(yx.shape[0], -1)]


def _descriptors_from_patches(patches: torch.Tensor, valid: torch.Tensor):
    """(K, 1521) raw patches -> (angle (K,), packed desc (K, 8) int32).

    Both contractions are f32 matmuls (TF32 is off package-wide): the BRIEF
    bit test needs ~0.1 intensity accuracy."""
    w_moment, w_blur, w_bits = _patch_matrices_on(patches.device)
    mom = patches @ w_moment
    angle = torch.atan2(mom[:, 1], mom[:, 0])
    diffs = (patches @ w_blur) @ w_bits
    bits = (diffs > 0).reshape(-1, N_ROT_BINS, DESC_WORDS, 32)
    shifts = torch.arange(32, device=patches.device, dtype=torch.int64)
    words = (bits.to(torch.int64) << shifts).sum(-1)     # (K, BINS, 8) < 2^32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)
    tau = 2.0 * np.pi
    bin_f = torch.round(torch.where(angle < 0, angle + tau, angle)
                        * (N_ROT_BINS / tau))
    bin_i = torch.remainder(bin_f.to(torch.int32), N_ROT_BINS)
    rows = torch.arange(words.shape[0], device=patches.device)
    words = words[rows, bin_i.long()]
    return angle, torch.where(valid[:, None], words, 0)


def extract(img: torch.Tensor, cfg: ExtractorConfig) -> Dict[str, torch.Tensor]:
    """uint8 (H, W) -> keypoint SoA (N = cfg.max_keypoints):
      uv (N, 2) f32 level-0 pixel coords (x, y); response (N,) f32 FAST
      score; angle (N,) f32 radians; level (N,) i32; valid (N,) bool;
      desc (N, 8) int32 packed 256-bit rBRIEF."""
    budgets = level_budgets(cfg)
    levels = pyr_ops.build_pyramid(img, cfg)
    N = cfg.max_keypoints
    dev = img.device

    used, offset = [], 0
    for lvl, budget in enumerate(budgets):
        if budget == 0 or offset >= N:
            continue
        budget = min(budget, N - offset)
        used.append((lvl, levels[lvl], budget))
        offset += budget
    scores = ck.fast_score_nms_pyramid([img_l for _, img_l, _ in used],
                                       cfg.edge_threshold)

    uv_l, resp_l, lvl_l, ok_l, patch_l = [], [], [], [], []
    for (lvl, img_l, budget), score in zip(used, scores):
        yx, resp, ok = _select_level_keypoints(
            score, budget, cfg.cell_size, float(cfg.fast_min_threshold))
        scale = cfg.scale_factor ** lvl
        uv_l.append(yx.flip(1).to(torch.float32) * scale)
        resp_l.append(resp)
        lvl_l.append(torch.full((budget,), lvl, dtype=torch.int32, device=dev))
        ok_l.append(ok)
        patch_l.append(extract_patches(img_l, yx))

    valid = torch.cat(ok_l)
    angle, desc = _descriptors_from_patches(torch.cat(patch_l), valid)
    uv = torch.cat(uv_l)
    response = torch.cat(resp_l)
    level = torch.cat(lvl_l)
    if offset < N:
        pad = N - offset
        uv = torch.cat([uv, uv.new_zeros((pad, 2))])
        response = torch.cat([response, response.new_zeros(pad)])
        angle = torch.cat([angle, angle.new_zeros(pad)])
        level = torch.cat([level, level.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
        desc = torch.cat([desc, desc.new_zeros((pad, DESC_WORDS))])
    return {"uv": uv, "response": response, "angle": angle,
            "level": level, "valid": valid, "desc": desc}
