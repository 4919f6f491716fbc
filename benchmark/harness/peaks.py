"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit) and the operations and bytes a kernel needs, from
the shapes it is given.  A roofline share is the least time these allow
over the time the trace measured."""

from __future__ import annotations

from typing import List, Tuple

PEAK_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3


def level_shapes(h: int, w: int, n_levels: int,
                 scale: float) -> List[Tuple[int, int]]:
    """The extractor's pyramid shapes (rounded as cv::resize rounds)."""
    return [(int(round(h / scale ** l)), int(round(w / scale ** l)))
            for l in range(n_levels)]


def fast_score_nms_bound_s(h: int, w: int, n_levels: int, scale: float,
                           margin: int) -> float:
    """Least seconds for K1 on one frame's pyramid: every pixel read once
    and written once as float32 (8 bytes), and 127 two-input operations on
    every scored pixel (the kept region and its 1-px ring): the arcs'
    minima and maxima from the circle halves' prefix and suffix extrema
    (2 x 42), the best of 16 arcs (2 x 15), two differences and a maximum,
    the 3x3 maximum from shared row maxima (8) and the selection.  The
    larger of the two bounds."""
    shapes = level_shapes(h, w, n_levels, scale)
    px = sum(a * b for a, b in shapes)
    scored = sum((a - 2 * margin + 2) * (b - 2 * margin + 2)
                 for a, b in shapes)
    return max(127.0 * scored / PEAK_F32_OPS_PER_S, 8.0 * px / PEAK_BYTES_PER_S)
