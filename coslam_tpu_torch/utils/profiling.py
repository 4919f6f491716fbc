"""Per-stage timing, profiler traces and the program's own spans (port of
coslam_tpu/utils/profiling.py, whole, plus `span`).

`StageTimer` wraps pipeline stages with wall timing that waits for the
device's queued work (`torch.cuda.synchronize()` where the device is a GPU)
and aggregates per-stage statistics; `trace()` records a region with
torch.profiler and writes a Chrome trace (`trace.json`) into a directory.

`span(name, **ids)` marks one step of the program.  It records only while a
torch profiler is active in the process (`torch.autograd._profiler_enabled()`
when the span opens): `trace()` (the CLI's `--profile DIR`) and any other
`torch.profiler.profile` turn it on; there is no other switch.  Off, it
returns one shared no-op object and reads no clock.  On, it keeps a record
(`spans()`): the name, `start_ns` / `end_ns` from `time.time_ns()` (the
clock of the profiler's events), the index of the enclosing open span of
the same thread (`parent`, -1 at the top) and the ids of its request
(`kf=` a keyframe slot, `frame=` the first frame of a chunk or step;
`graph=` on `track.chunk`; `gate=` and `packets=` on the coop spans), and
opens a `torch.profiler.record_function(name)` range inside those two
stamps, so a Chrome trace shows the same spans.  A span never synchronises
and never reads a tensor: a `sync.*` span wraps a readback the program
makes anyway, and its length is the host's wait for the device.

The spans, at the layer boundaries of the replay and coop paths:

  session.new          System.__init__ (map, place-recognition DB, loop closer)
  session.run          System.run_sequence, whole
  session.shutdown     System.shutdown
  track.chunk          one chunk of run_sequence (frame; graph, how
                       tracking.track_chunk ran it: capture, replay or
                       eager)
  track.frame          one frame on the per-frame path (frame)
  sync.chunk           the chunk's result readback, the carry's readback
  sync.frame           the per-frame path's first readback (frame)
  backend.insert       each local_mapping.backend_insert call (kf)
  backend.watermark    run_sequence's synchronous insert at a capacity
                       watermark (System._insert_keyframe, compaction
                       inside) (kf)
  flush                System._flush_pending with work pending (kf)
  sync.backend         System._commit_keyframes' readbacks, after the
                       backend of every insert form (kf)
  loop.global_ba       a deferred global BA that runs
  loop.on_keyframe     LoopCloser.on_keyframe (kf)
  loop.detect          KeyFrameDatabase.detect_loop_candidates (kf)
  loop.shortlist       the match-count shortlist and its readback (kf)
  loop.verify          one candidate's Sim3 verification (kf, candidate,
                       inliers)
  loop.correct         correct_loop and the geometry refresh (kf)
  sync.loop            each readback of the loop closer (kf)
  coop.receive_packet  CoopAgent.receive_packet (kf)
  coop.merge           CoopAgent._try_merge (kf; gate, the gate of the
                       cross-agent Sim3 search that ended the attempt:
                       bow, count, pairs, ransac, scale, polish or ok)
  coop.realign         CoopAgent._try_realign (kf; gate, as coop.merge)
  coop.publish         cli.drive_coop: the sender's drain_packets and
                       bus.publish (packets)
  coop.drain           cli.drive_coop: bus.drain, mostly the bus's timed
                       wait (packets)

`spans_in_window`, `self_ns` and `union_ns` are the arithmetic the
benchmark's readers of these spans share.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class StageTimer:
    """Accumulates per-stage wall times, synchronized with `device` (the
    GPU unless the caller passes device="cpu").

    >>> timer = StageTimer(device="cpu")
    >>> with timer("tracking"):
    ...     out = tracking_step(...)
    >>> timer.summary()
    """

    def __init__(self, sync: bool = True, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.sync = sync and self.device.type == "cuda"
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                # wait for the stage's queued device work, so that its time
                # is counted here
                torch.cuda.synchronize(self.device)
            self.times[stage].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.times.items():
            arr = sorted(v)
            n = len(arr)
            out[k] = {
                "count": n,
                "total_s": sum(arr),
                "mean_ms": 1000 * sum(arr) / n,
                "p50_ms": 1000 * arr[n // 2],
                "p95_ms": 1000 * arr[min(n - 1, int(0.95 * n))],
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>7}{'mean ms':>10}{'p50 ms':>10}"
                 f"{'p95 ms':>10}{'total s':>10}"]
        for k, s in sorted(self.summary().items(),
                           key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:<24}{s['count']:>7}{s['mean_ms']:>10.2f}"
                         f"{s['p50_ms']:>10.2f}{s['p95_ms']:>10.2f}"
                         f"{s['total_s']:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the region (host ops, and the GPU's kernels where
    there is one) -> `log_dir`/trace.json, viewable in Perfetto or
    chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Span:
    """One recorded span; `end_ns` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "ids")

    def __init__(self, name: str, parent: int, ids: dict):
        self.name = name
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self.parent = parent
        self.ids = ids


_SPANS: List[Span] = []
_LOCK = threading.Lock()
_OPEN = threading.local()       # .stack: indices of this thread's open spans


class _Off:
    """The span returned while no profiler is active: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **ids) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("rec", "index", "range")

    def __init__(self, name: str, ids: dict):
        self.rec = Span(name, -1, ids)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        rec = self.rec
        rec.parent = stack[-1] if stack else -1
        with _LOCK:
            self.index = len(_SPANS)
            _SPANS.append(rec)
        stack.append(self.index)
        rec.start_ns = time.time_ns()
        self.range = torch.profiler.record_function(rec.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.range.__exit__(*exc)
        self.rec.end_ns = time.time_ns()
        _OPEN.stack.pop()
        return False

    def set(self, **ids) -> None:
        """Add ids known only once the step has run (`inliers=`)."""
        self.rec.ids.update(ids)


def span(name: str, **ids):
    """A context manager around one step of the program (module doc)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _On(name, ids)


def spans() -> List[Span]:
    """The spans recorded in this process since the last `clear_spans()`;
    a span's `parent` indexes this list."""
    return _SPANS


def clear_spans() -> None:
    with _LOCK:
        _SPANS.clear()


def spans_in_window(records: Sequence[Span], t0_ns: int,
                    t1_ns: int) -> List[int]:
    """Indices of the closed spans that lie inside [t0_ns, t1_ns]."""
    return [i for i, r in enumerate(records)
            if r.end_ns is not None and r.start_ns >= t0_ns
            and r.end_ns <= t1_ns]


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_ns(records: Sequence[Span], indices: Iterable[int]) -> List[int]:
    """Per span of `indices`: its duration less the part of it that its
    child spans cover."""
    children: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for r in records:
        if r.parent >= 0 and r.end_ns is not None:
            children[r.parent].append((r.start_ns, r.end_ns))
    out = []
    for i in indices:
        r = records[i]
        covered = union_ns((max(a, r.start_ns), min(b, r.end_ns))
                           for a, b in children.get(i, ())
                           if b > r.start_ns and a < r.end_ns)
        out.append(r.end_ns - r.start_ns - covered)
    return out
