"""Device microseconds of the port's three hand-written kernels (K1
fast_score_nms, K2 masked_match, K3 pose_opt_lm; their durations by name in
the trace) per frame posed in the window."""

NAMES = ("fast_score_nms_kernel", "masked_match_kernel", "pose_opt_lm_kernel")


def read(td):
    ns = [d for n, s, d, _c in td.kernels
          if td.t0_ns <= s < td.t1_ns and any(k in n for k in NAMES)]
    if td.frames <= 0 or not ns:
        return None
    return sum(ns) / 1e3 / td.frames
