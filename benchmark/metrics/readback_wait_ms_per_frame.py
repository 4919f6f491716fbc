"""Milliseconds per frame posed in the window in which the host waits on
the card: the length of the union of the program's `sync.*` spans
(coslam_tpu_torch/utils/profiling.py), each around a readback or a
pageable upload that blocks until the device's queue drains.  None where
the program records no such span."""


def read(td):
    try:
        from coslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or td.frames <= 0:
        return None
    recs = profiling.spans()
    waits = [(recs[i].start_ns, recs[i].end_ns) for i in
             profiling.spans_in_window(recs, td.t0_ns, td.t1_ns)
             if recs[i].name.startswith("sync.")]
    if not waits:
        return None
    return profiling.union_ns(waits) / td.frames / 1e6
