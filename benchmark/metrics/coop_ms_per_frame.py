"""Milliseconds per frame posed in the window (both agents' frames) spent
in the cooperative layer: the length of the union of the program's
`coop.*` spans (coslam_tpu_torch/utils/profiling.py: packet integration,
merges, realignments, publishing and the bus's drains), over the frames
posed, so that its share of a frame's wall reads beside frames_per_s.
None where the program records no such span."""


def read(td):
    try:
        from coslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or td.frames <= 0:
        return None
    recs = profiling.spans()
    coop = [(recs[i].start_ns, recs[i].end_ns) for i in
            profiling.spans_in_window(recs, td.t0_ns, td.t1_ns)
            if recs[i].name.startswith("coop.")]
    if not coop:
        return None
    return profiling.union_ns(coop) / td.frames / 1e6
