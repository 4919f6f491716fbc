"""Host milliseconds of the chunk tracker per frame posed in the window:
the self time (a span's length less what its child spans cover) of the
program's `track.chunk` and `track.frame` spans
(coslam_tpu_torch/utils/profiling.py).  Their children are the readbacks
(`sync.*`), the keyframe backend, the flush and loop closing, so what is
left is the host's own tracking work: dispatch, acceptance, bookkeeping.
None where the program records no such span."""

NAMES = ("track.chunk", "track.frame")


def read(td):
    try:
        from coslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or td.frames <= 0:
        return None
    recs = profiling.spans()
    idx = [i for i in profiling.spans_in_window(recs, td.t0_ns, td.t1_ns)
           if recs[i].name in NAMES]
    if not idx:
        return None
    return sum(profiling.self_ns(recs, idx)) / td.frames / 1e6
