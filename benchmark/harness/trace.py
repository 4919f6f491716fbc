"""The traced run's device trace: torch.profiler with CUDA activity only
(kernels, copies and the CUDA runtime calls that launched them, each with a
correlation id), kept in memory and read from the profiler's raw events;
no Chrome trace is written.  Host spans come from capture.Spans on the same
clock (time.time_ns)."""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark.harness import window as win

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize")


class Profiler:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> list:
        self.prof.stop()
        return list(self.prof.profiler.kineto_results.events())


@dataclass
class TraceData:
    """Everything a per-layer reader may use."""
    t0_ns: int
    t1_ns: int
    frames: int
    kernels: List[Tuple[str, int, int, int]]      # name, start, dur, corr
    copies: List[Tuple[str, int, int]]            # memcpy / memset
    runtime: List[Tuple[str, int, int, int]]      # name, start, dur, corr
    spans: Dict[str, List[Tuple[int, int]]]
    outcome: object
    config: dict
    busy: List[Tuple[int, int]] = field(default_factory=list)
    # the copies again with their correlation ids
    copies_corr: List[Tuple[str, int, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return win.union_length(self.busy, self.t0_ns, self.t1_ns) / 1e9

    def spans_in_window(self, name: str) -> List[Tuple[int, int]]:
        return [(a, b) for a, b in self.spans.get(name, [])
                if a >= self.t0_ns and b <= self.t1_ns]

    def device_ns_under(self, name: str) -> List[int]:
        """Per span of `name` in the window: device nanoseconds of the work
        launched while it was open (runtime call start inside the span)."""
        dev = collections.Counter()
        for _n, _s, d, c in self.kernels:
            dev[c] += d
        for _n, _s, d, c in self.copies_corr:
            dev[c] += d
        calls = sorted((s, c) for _n, s, _d, c in self.runtime if dev.get(c))
        starts = [s for s, _c in calls]
        out = []
        for a, b in self.spans_in_window(name):
            lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
            out.append(sum(dev[c] for _s, c in calls[lo:hi]))
        return out


def read(events: list, t0_ns: int, t1_ns: int, frames: int, spans, outcome,
         config) -> TraceData:
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    kernels, copies, copies_corr, runtime = [], [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            s, d, c = e.start_ns(), e.duration_ns(), e.correlation_id()
            if name.startswith(("Memcpy", "Memset")):
                copies.append((name, s, d))
                copies_corr.append((name, s, d, c))
            else:
                kernels.append((name, s, d, c))
        elif name.startswith("cu"):
            runtime.append((name, e.start_ns(), e.duration_ns(),
                            e.correlation_id()))
    busy = win.merged([(s, s + d) for _n, s, d, _c in kernels]
                      + [(s, s + d) for _n, s, d in copies])
    return TraceData(t0_ns=t0_ns, t1_ns=t1_ns, frames=frames, kernels=kernels,
                     copies=copies, runtime=runtime, spans=spans,
                     outcome=outcome, config=config, busy=busy,
                     copies_corr=copies_corr)


def breakdown(td: TraceData, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps named by the innermost host span open at the gap."""
    per = collections.Counter()
    for name, s, d, _c in td.kernels:
        if td.t0_ns <= s < td.t1_ns:
            per[name[:160]] += d
    for name, s, d in td.copies:
        if td.t0_ns <= s < td.t1_ns:
            per[name[:160]] += d
    ops = [[n, v / 1e9] for n, v in per.most_common(top)]
    busy = [(max(a, td.t0_ns), min(b, td.t1_ns)) for a, b in td.busy
            if b > td.t0_ns and a < td.t1_ns]
    gaps, prev = [], td.t0_ns
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if td.t1_ns > prev:
        gaps.append((prev, td.t1_ns))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        named.append([f"idle in {_host_at(td, (a + b) // 2)}", (b - a) / 1e9])
    return {"device_ops": ops, "idle_gaps": named}


def _host_at(td: TraceData, t: int) -> str:
    best: Optional[Tuple[int, str]] = None
    for name, spans in td.spans.items():
        for a, b in spans:
            if a <= t < b and (best is None or b - a < best[0]):
                best = (b - a, name)
    return best[1] if best else "the harness or host code outside the spans"
