"""Host wall milliseconds of one foreign keyframe's integration on the
receiver: the program's `coop.receive_packet` spans
(models/cooperative.CoopAgent.receive_packet: the wire reconstruction of
the keyframe and its landmarks, and the merge attempt or, once merged, the
back-end pass and the realignment attempt), summed over the window, over
their number there (coslam_tpu_torch/utils/profiling.py).  None where the
program records no such span."""


def read(td):
    try:
        from coslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    recs = profiling.spans()
    walls = [recs[i].end_ns - recs[i].start_ns for i in
             profiling.spans_in_window(recs, td.t0_ns, td.t1_ns)
             if recs[i].name == "coop.receive_packet"]
    if not walls:
        return None
    return sum(walls) / len(walls) / 1e6
