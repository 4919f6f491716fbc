"""Host wall milliseconds per call of LoopCloser.on_keyframe (detection,
Sim3 verification and, when it closes, the correction), from the
benchmark's span, averaged over the calls in the window."""


def read(td):
    spans = td.spans_in_window("LoopCloser.on_keyframe")
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
