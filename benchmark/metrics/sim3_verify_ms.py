"""Host wall milliseconds of Sim3 verification per call of
LoopCloser.on_keyframe: the program's `loop.verify` spans (one candidate
each: pair matching, the RANSAC, the SearchBySim3 expansion, the polish
and their readbacks), summed over the window, over the number of
`loop.on_keyframe` spans there (coslam_tpu_torch/utils/profiling.py).
None where the program records no `loop.on_keyframe` span."""


def read(td):
    try:
        from coslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    recs = profiling.spans()
    idx = profiling.spans_in_window(recs, td.t0_ns, td.t1_ns)
    calls = sum(1 for i in idx if recs[i].name == "loop.on_keyframe")
    if not calls:
        return None
    return sum(recs[i].end_ns - recs[i].start_ns for i in idx
               if recs[i].name == "loop.verify") / calls / 1e6
