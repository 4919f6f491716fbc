"""The frame layer (what the program's extractor computes, kernel K1
inside it), written plainly: the image pyramid by bilinear resize
matrices, FAST-9 scores with 3x3 non-maximum suppression and the border,
per-level top-k with per-cell capping, IC orientation and the 256-bit
rotated BRIEF descriptors.  A frozen copy of the program's plain
formulation (the reference's numpy tables rebuilt bit for bit); `dtype`
is the precision of the pyramid and of the descriptor contractions
(float32 for the check, bfloat16 for the control)."""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PATCH_RADIUS = 15
N_BITS = 256
DESC_WORDS = 8
N_ROT_BINS = 30
RAW_PATCH = 39
BLUR_PATCH = 33
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    rng = np.random.default_rng(20160229)
    pts = rng.normal(0.0, PATCH_RADIUS / 2.2, size=(N_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.where(norm > 13.0, 13.0 / (norm + 1e-9), 1.0)
    return (pts * scale).astype(np.float32)


@functools.lru_cache(maxsize=1)
def patch_matrices():
    rp, bp = RAW_PATCH, BLUR_PATCH
    rr, br = rp // 2, bp // 2
    ys, xs = np.mgrid[-rr:rr + 1, -rr:rr + 1]
    circ = ((xs ** 2 + ys ** 2) <= PATCH_RADIUS ** 2).astype(np.float32)
    w_moment = np.stack([(xs * circ).reshape(-1), (ys * circ).reshape(-1)], 1)
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
            w_bits[flat[k, 1], col] += 1.0
            w_bits[flat[k, 0], col] -= 1.0
    return w_moment, w_blur, w_bits


def level_budgets(ex: dict) -> List[int]:
    f = 1.0 / ex["scale_factor"]
    n0 = ex["n_features"] * (1 - f) / (1 - f ** ex["n_levels"])
    budgets = [int(round(n0 * f ** l)) for l in range(ex["n_levels"] - 1)]
    budgets.append(max(ex["n_features"] - sum(budgets), 0))
    return budgets


def level_shapes(h: int, w: int, ex: dict) -> List[Tuple[int, int]]:
    out = []
    for lvl in range(ex["n_levels"]):
        inv = 1.0 / (ex["scale_factor"] ** lvl)
        out.append((int(round(h * inv)), int(round(w * inv))))
    return out


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    support = max(scale, 1.0)
    dist = np.abs(centers[:, None] - np.arange(n_in)[None, :]) / support
    w = np.clip(1.0 - dist, 0.0, None).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


def pyramid(img: torch.Tensor, ex: dict, dtype) -> List[torch.Tensor]:
    """Level 0 as given, each further level resized from it in `dtype`,
    returned as float32."""
    img = img.to(torch.float32)
    h, w = img.shape
    out = [img]
    src = img.to(dtype)
    for lh, lw in level_shapes(h, w, ex)[1:]:
        rh = torch.from_numpy(_resize_weights(h, lh)).to(img.device, dtype)
        rw = torch.from_numpy(_resize_weights(w, lw)).to(img.device, dtype)
        out.append(((rh @ src) @ rw.T).to(torch.float32))
    return out


def fast_score(img: torch.Tensor) -> torch.Tensor:
    circ = torch.stack([torch.roll(img, (-dy, -dx), (0, 1))
                        for dy, dx in CIRCLE])

    def arc_min9(d):
        m = torch.minimum(d, torch.roll(d, -1, 0))
        m = torch.minimum(m, torch.roll(m, -2, 0))
        m = torch.minimum(m, torch.roll(m, -4, 0))
        m = torch.minimum(m, torch.roll(d, -8, 0))
        return m.amax(0)

    return torch.maximum(arc_min9(circ - img), arc_min9(img - circ))


def fast_nms_border(img: torch.Tensor, margin: int) -> torch.Tensor:
    score = fast_score(img)
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= pooled, score, torch.zeros_like(score))
    mask = torch.zeros_like(score)
    h, w = score.shape
    mask[margin:h - margin, margin:w - margin] = 1.0
    return score * mask


def _select(score: torch.Tensor, budget: int, cell: int, min_th: float):
    h, w = score.shape
    hc, wc = -(-h // cell), -(-w // cell)
    nc = hc * wc
    dev = score.device
    pad = F.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cells = pad.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3) \
        .reshape(nc, cell * cell)
    rows = torch.arange(nc, device=dev)
    i1 = torch.argmax(cells, 1)
    m1 = cells[rows, i1]
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
        valid = torch.cat([valid, valid.new_zeros(padn)])
    return torch.stack([ys, xs], 1), valid


def _patches(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    half = RAW_PATCH // 2
    h, w = img.shape
    src = img.to(torch.bfloat16).to(torch.float32)
    y0 = torch.clamp(yx[:, 0].long() - half, 0, h - RAW_PATCH)
    x0 = torch.clamp(yx[:, 1].long() - half, 0, w - RAW_PATCH)
    ar = torch.arange(RAW_PATCH, device=img.device)
    flat = (y0[:, None, None] + ar[None, :, None]) * w \
        + (x0[:, None, None] + ar[None, None, :])
    return src.reshape(-1)[flat.reshape(yx.shape[0], -1)]


def _descriptors(patches: torch.Tensor, valid: torch.Tensor, dtype):
    dev = patches.device
    w_moment, w_blur, w_bits = (torch.from_numpy(a).to(dev, dtype)
                                for a in patch_matrices())
    p = patches.to(dtype)
    mom = (p @ w_moment).to(torch.float32)
    angle = torch.atan2(mom[:, 1], mom[:, 0])
    diffs = ((p @ w_blur) @ w_bits).to(torch.float32)
    bits = (diffs > 0).reshape(-1, N_ROT_BINS, DESC_WORDS, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = (bits.to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)
    tau = 2.0 * np.pi
    bin_f = torch.round(torch.where(angle < 0, angle + tau, angle)
                        * (N_ROT_BINS / tau))
    bin_i = torch.remainder(bin_f.to(torch.int32), N_ROT_BINS)
    rows = torch.arange(words.shape[0], device=dev)
    return torch.where(valid[:, None], words[rows, bin_i.long()], 0)


def extract(img: torch.Tensor, ex: dict,
            dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """uint8 (H, W) -> uv (N, 2) level-0 pixels, level (N,), valid (N,),
    desc (N, 8) int32 words, N = ex['max_keypoints']."""
    budgets = level_budgets(ex)
    levels = pyramid(img, ex, dtype)
    N = ex["max_keypoints"]
    dev = img.device
    uv_l, lvl_l, ok_l, patch_l = [], [], [], []
    offset = 0
    for lvl, budget in enumerate(budgets):
        if budget == 0 or offset >= N:
            continue
        budget = min(budget, N - offset)
        offset += budget
        score = fast_nms_border(levels[lvl], ex["edge_threshold"])
        yx, ok = _select(score, budget, ex["cell_size"],
                         float(ex["fast_min_threshold"]))
        uv_l.append(yx.flip(1).to(torch.float32) * ex["scale_factor"] ** lvl)
        lvl_l.append(torch.full((budget,), lvl, dtype=torch.int32,
                                device=dev))
        ok_l.append(ok)
        patch_l.append(_patches(levels[lvl], yx))
    valid = torch.cat(ok_l)
    desc = _descriptors(torch.cat(patch_l), valid, dtype)
    uv, level = torch.cat(uv_l), torch.cat(lvl_l)
    if offset < N:
        pad = N - offset
        uv = torch.cat([uv, uv.new_zeros((pad, 2))])
        level = torch.cat([level, level.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
        desc = torch.cat([desc, desc.new_zeros((pad, DESC_WORDS))])
    return {"uv": uv, "level": level, "valid": valid, "desc": desc}


def mismatch(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
             ) -> Tuple[int, int]:
    """(keypoints of either side that the other does not hold at the same
    slot with the same pixel, level and descriptor, valid keypoints of the
    program)."""
    pv, rv = prog["valid"].bool(), ref["valid"].bool()
    same = (pv == rv) & (prog["level"].to(torch.int64)
                         == ref["level"].to(torch.int64)) \
        & (prog["uv"] == ref["uv"]).all(1) \
        & (prog["desc"].to(torch.int64) == ref["desc"].to(torch.int64)).all(1)
    return int(((pv | rv) & ~same).sum()), int(pv.sum())
