"""Host waits on the card per frame posed in the window: the CUDA runtime
calls in the trace that block the host (stream, device and event
synchronisations and blocking cudaMemcpy; a device-to-host cudaMemcpyAsync
is followed by a stream synchronisation, counted there)."""

from benchmark.harness.trace import SYNC_CALLS


def read(td):
    if td.frames <= 0 or not td.runtime:
        return None
    n = sum(1 for name, s, _d, _c in td.runtime
            if name in SYNC_CALLS and td.t0_ns <= s < td.t1_ns)
    return n / td.frames
