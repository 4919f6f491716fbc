"""K1's share of its roofline: the least time the card needs for one
frame's pyramid at the configuration's image size and extractor
(harness/peaks.py, bytes against 3.35 TB/s and operations against 67
TFLOP/s, the larger) over K1's mean duration in the trace, in percent."""

from benchmark.harness import peaks


def read(td):
    ds = [d for n, s, d, _c in td.kernels
          if "fast_score_nms_kernel" in n and td.t0_ns <= s < td.t1_ns]
    if not ds:
        return None
    cam = td.config["system"]["camera"]
    ex = td.config["system"]["extractor"]
    bound_s = peaks.fast_score_nms_bound_s(
        cam["height"], cam["width"], ex["n_levels"], ex["scale_factor"],
        ex["edge_threshold"])
    return 100.0 * bound_s / (sum(ds) / len(ds) / 1e9)
