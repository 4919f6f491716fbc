"""Functions captured as CUDA graphs (the torch.cuda.graphs recipe).

`capture` records `fn()` whole, as one graph: the bench's hot path
(`bench.bench_hot_path`).  `capture_segmented` records it as a chain of
graph segments cut at each `host_launch` call, which every replay makes
from the host between the segments: the chunk tracker
(`models/tracking.ChunkGraphs`), whose K3 calls stay visible to what wraps
the kernel's entry point (its launch count, a harness that samples its
calls) as eager calls are.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from coslam_tpu_torch.ops import cuda_kernels as ck


class Graph(NamedTuple):
    replay: Callable[[], None]
    out: object                # the captured outputs, refreshed by replay
    launches: Dict[str, int]   # kernel launches recorded while capturing
    pool_bytes: int            # device memory the graph's private pool took


def _warm_up(fn: Callable, dev: torch.device, warmup: int) -> torch.Stream:
    """`warmup` eager calls on a new capture stream (they build the kernels,
    fill the cached tables and allocate the matcher's per-stream scratch
    before capture)."""
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(dev).wait_stream(s)
    return s


def _reserved(dev: torch.device) -> int:
    """Device memory the caching allocator holds, once its free blocks are
    returned (as torch.cuda.graph returns them before a capture)."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def _launched(before: Dict[str, int]) -> Dict[str, int]:
    return {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES
            if ck.LAUNCHES[k] != before[k]}


def capture(fn: Callable, dev: torch.device, warmup: int = 2) -> Graph:
    """`fn()` captured as one CUDA graph after `warmup` eager calls on the
    capture stream.  A capture that fails raises."""
    s = _warm_up(fn, dev, warmup)
    reserved = _reserved(dev)
    g = torch.cuda.CUDAGraph()
    before = dict(ck.LAUNCHES)
    with torch.cuda.graph(g, stream=s):
        out = fn()
    launched = _launched(before)
    pool = torch.cuda.memory_reserved(dev) - reserved
    torch.cuda.synchronize(dev)
    return Graph(g.replay, out, launched, pool)


# ---------------------------------------------------------------------------
# Segmented capture
# ---------------------------------------------------------------------------

_STATE = threading.local()   # .record: outputs of host_launch calls in a
#                              warm-up; .segments: the capture in progress


def map_tree(f, v):
    """`f` applied to every tensor of a nest of tuples and NamedTuples."""
    if isinstance(v, torch.Tensor):
        return f(v)
    if hasattr(v, "_fields"):                      # a NamedTuple
        return type(v)(*(map_tree(f, x) for x in v))
    return type(v)(map_tree(f, x) for x in v)


def _copy_tree(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_tree(d, s)


def host_launch(owner, name: str, *args, **kw):
    """`getattr(owner, name)(*args, **kw)`: a kernel's Python entry point,
    looked up at each call.  Inside `capture_segmented` the call is not
    recorded: it ends the current graph segment, and every replay makes
    it from the host, on the inputs the segment left, before the next
    segment, which reads its outputs.  Anywhere else, a plain call."""
    segments: Optional[_Segments] = getattr(_STATE, "segments", None)
    if segments is not None:
        return segments.cut(owner, name, args, kw)
    out = getattr(owner, name)(*args, **kw)
    record = getattr(_STATE, "record", None)
    if record is not None:
        record.append(out)
    return out


class _Cut(NamedTuple):
    owner: object
    name: str
    args: tuple
    kw: dict
    out: object        # static outputs, read by the next segment


class _Segments:
    def __init__(self, outs: List[object]):
        self.outs = outs          # a warm-up's host_launch outputs, in order
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.cuts: List[_Cut] = []

    def begin(self) -> None:
        self.graphs.append(torch.cuda.CUDAGraph())
        self.graphs[-1].capture_begin(self.pool)

    def end(self) -> None:
        self.graphs[-1].capture_end()

    def cut(self, owner, name, args, kw):
        self.end()
        # buffers shaped like the warm-up's outputs of this call: nothing
        # runs on the segment's unexecuted inputs
        out = map_tree(torch.empty_like, self.outs[len(self.cuts)])
        self.cuts.append(_Cut(owner, name, args, kw, out))
        self.begin()
        return out

    def replay(self) -> None:
        for g, c in zip(self.graphs, self.cuts):
            g.replay()
            _copy_tree(c.out, getattr(c.owner, c.name)(*c.args, **c.kw))
        self.graphs[-1].replay()


def capture_segmented(fn: Callable, dev: torch.device,
                      warmup: int = 2) -> Graph:
    """`fn()` captured as CUDA graph segments cut at its `host_launch`
    calls (module doc), after `warmup` eager calls on the capture stream;
    its control flow may not depend on device values.  `launches` holds
    the launches inside the segments.  A capture that fails raises."""
    _STATE.record = record = []
    try:
        s = _warm_up(fn, dev, warmup)
    finally:
        _STATE.record = None
    outs = record[len(record) - len(record) // warmup:]   # the last call's
    reserved = _reserved(dev)
    segments = _Segments(outs)
    before = dict(ck.LAUNCHES)
    with torch.cuda.stream(s):
        _STATE.segments = segments
        try:
            segments.begin()
            out = fn()
        finally:
            _STATE.segments = None
            segments.end()
    launched = _launched(before)
    pool = torch.cuda.memory_reserved(dev) - reserved
    torch.cuda.synchronize(dev)
    return Graph(segments.replay, out, launched, pool)
