"""Descriptor matching with spatial windows, ratio tests and rotation
consistency (port of coslam_tpu/ops/matching.py).

`match` is the dense (N, M) formulation, used where the target set is a
keyframe's keypoints.  `match_windowed` is the projection search: one pass
of kernel K2 (ops/cuda_kernels.masked_match) forward and, for the mutual
check, one reversed pass with the window and octave gates moved to the
target side — the reference's TPU route (matching.py:146-187), taken on
every device.  Ties resolve to the lowest index everywhere, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from coslam_tpu_torch.config import MatcherConfig
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops import hamming

INF = 1 << 20
TWO_PI = 6.283185307179586


class Matches(NamedTuple):
    """Row-wise matching result: for each query keypoint a target index."""
    idx: torch.Tensor    # (N,) int32 index into target set, -1 if unmatched
    dist: torch.Tensor   # (N,) int32 Hamming distance (INF if unmatched)
    valid: torch.Tensor  # (N,) bool


def masked_distance_matrix(desc_q, valid_q, desc_t, valid_t, mask=None):
    """(..., N, M) Hamming distances with invalid/masked entries set to
    INF (leading batch dimensions broadcast)."""
    d = hamming.pairwise_hamming_pm1(desc_q, desc_t)
    ok = valid_q[..., :, None] & valid_t[..., None, :]
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, d, INF)


def best_two(dmat):
    """Row-wise best and second-best distances + best index (first index
    among equal minima)."""
    best, best_idx = dmat.min(-1)
    d2 = dmat.scatter(-1, best_idx[..., None], INF)
    return best, d2.amin(-1), best_idx


def _top_k_stable(x, k: int):
    """Values and indices of the k largest entries, lower index first among
    equals (the tie order of jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rotation_consistency(angle_q, angle_t, match_idx, match_valid,
                         histo_length: int = 30):
    """Keep only matches whose angle difference falls in the 3 dominant
    orientation-histogram bins (reference ORBmatcher::ComputeThreeMaxima,
    ORBmatcher.cc:1601-1644, incl. the 0.1x maximum cutoffs)."""
    angle_t = angle_t.expand(match_idx.shape[:-1] + angle_t.shape[-1:])
    rot = angle_q - torch.gather(angle_t, -1, match_idx.long())
    rot = torch.where(rot < 0, rot + TWO_PI, rot)
    bins = torch.clamp((rot * (histo_length / TWO_PI)).to(torch.int32),
                       0, histo_length - 1)
    hist = torch.zeros(bins.shape[:-1] + (histo_length,), dtype=torch.int32,
                       device=rot.device)
    hist = hist.scatter_add(-1, bins.long(), match_valid.to(torch.int32))
    top3_val, top3_idx = _top_k_stable(hist, 3)
    top3_val = top3_val.to(torch.float32)[..., None, :]
    top3_idx = top3_idx[..., None, :]
    keep1 = bins == top3_idx[..., 0]
    keep2 = (bins == top3_idx[..., 1]) \
        & (top3_val[..., 1] > 0.1 * top3_val[..., 0])
    keep3 = (bins == top3_idx[..., 2]) \
        & (top3_val[..., 2] > 0.1 * top3_val[..., 0])
    return match_valid & (keep1 | keep2 | keep3)


def mutual_filter(dmat, best_idx, valid):
    """Keep (q -> t) only if q is also t's best among queries."""
    col_best = dmat.argmin(-2)
    n = best_idx.shape[-1]
    return valid & (torch.gather(col_best, -1, best_idx.long())
                    == torch.arange(n, device=dmat.device))


def match(desc_q, valid_q, desc_t, valid_t, cfg: MatcherConfig,
          mask=None, max_dist: Optional[int] = None,
          ratio: Optional[float] = None, mutual: bool = False,
          angle_q=None, angle_t=None) -> Matches:
    """Generic one-shot dense matcher; mask: optional (N, M) bool of
    admissible pairs.  Target-side inputs (and the mask) may carry a
    leading batch dimension: one matcher per target set."""
    dmat = masked_distance_matrix(desc_q, valid_q, desc_t, valid_t, mask)
    best, second, best_idx = best_two(dmat)
    ok = best < (max_dist if max_dist is not None else cfg.th_low)
    if ratio is not None:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        ok = mutual_filter(dmat, best_idx, ok)
    if cfg.check_orientation and angle_q is not None and angle_t is not None:
        ok = rotation_consistency(angle_q, angle_t, best_idx, ok,
                                  cfg.histo_length)
    best_idx = best_idx.to(torch.int32)
    return Matches(idx=torch.where(ok, best_idx, -1),
                   dist=torch.where(ok, best, INF), valid=ok)


def match_windowed(desc_q, uv_pred, radius, valid_q, desc_t, uv_t, valid_t,
                   cfg: MatcherConfig,
                   level_q=None, level_t=None,
                   level_lo: float = -1e9, level_hi: float = 1e9,
                   max_dist: Optional[int] = None,
                   ratio: Optional[float] = None, mutual: bool = False,
                   angle_q=None, angle_t=None) -> Matches:
    """Windowed projection search (the SearchByProjection family): `match`
    with window_mask(uv_pred, uv_t, radius) [+ level gate], computed by the
    streaming matcher without building the (N, M) matrices."""
    N = desc_q.shape[0]
    dev = desc_q.device
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev) \
        .broadcast_to((N,))
    # an absent octave is a null pointer to the kernel, not a tensor of zeros
    lq = level_q.to(torch.float32) if level_q is not None else None
    lt = level_t.to(torch.float32) if level_t is not None else None
    r2 = r * r
    uv_q = uv_pred.to(torch.float32)
    uv_tt = uv_t.to(torch.float32)
    best, second, idx = ck.masked_match(
        desc_q, uv_q, r2, valid_q, desc_t, uv_tt, valid_t,
        level_q=lq, level_t=lt, level_lo=level_lo, level_hi=level_hi)

    ok = best < (max_dist if max_dist is not None else cfg.th_low)
    if ratio is not None:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        # reverse pass: the window/level gates belong to the original query
        # side, so they ride the target-side inputs here
        # (r2_q=None: no window of the reversed queries' own)
        _, _, ridx = ck.masked_match(
            desc_t, uv_tt, None, valid_t, desc_q, uv_q, valid_q,
            level_q=lt, level_t=lq, level_lo=-level_hi, level_hi=-level_lo,
            r2_t=r2)
        safe = torch.clamp(idx, min=0).long()
        ok = ok & (ridx[safe] == torch.arange(N, dtype=torch.int32,
                                              device=dev))
    if cfg.check_orientation and angle_q is not None and angle_t is not None:
        ok = rotation_consistency(angle_q, angle_t, torch.clamp(idx, min=0),
                                  ok, cfg.histo_length)
    return Matches(idx=torch.where(ok, idx, -1),
                   dist=torch.where(ok, best, INF), valid=ok)


def window_mask(uv_pred, uv_t, radius):
    """(N, M) bool: target kp within `radius` px of the predicted location
    (radius scalar or per-query (N,))."""
    d2 = ((uv_pred[:, None, :] - uv_t[None, :, :]) ** 2).sum(-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=uv_pred.device)
    r2 = (r * r) if r.dim() == 0 else (r * r)[:, None]
    return d2 <= r2


def level_mask(level_q, level_t, lo: int = 0, hi: int = 0):
    """(N, M) bool: target octave within [level_q + lo, level_q + hi]."""
    lt = level_t[None, :]
    lq = level_q[:, None]
    return (lt >= lq + lo) & (lt <= lq + hi)
