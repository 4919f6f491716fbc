"""The measured window and the arithmetic the end-to-end and per-layer
metrics share: the window's clock, the frame source that ends it, rates,
percentiles, quartile spreads and the union of device intervals."""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple


class WindowClosed(Exception):
    """Raised where the program asks the harness for input after the
    window's deadline: the window ends there."""


class Clock:
    """The window's deadline.  `pull()` is called wherever the program asks
    the harness for input; the first call after the deadline runs `at_close`
    (which synchronises the device), stamps the window's end and raises
    WindowClosed."""

    def __init__(self, seconds: float, now: Callable[[], float] = time.perf_counter,
                 at_close: Optional[Callable[[], None]] = None):
        self.seconds = float(seconds)
        self.now = now
        self.at_close = at_close
        self.t0: Optional[float] = None
        self.t_end: Optional[float] = None
        self.t0_ns: Optional[int] = None
        self.t_end_ns: Optional[int] = None

    def start(self) -> None:
        self.t0 = self.now()
        self.t0_ns = time.time_ns()

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    def pull(self) -> None:
        if self.t_end is not None:
            raise WindowClosed()
        if self.now() - self.t0 >= self.seconds:
            if self.at_close is not None:
                self.at_close()
            self.t_end = self.now()
            self.t_end_ns = time.time_ns()
            raise WindowClosed()

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0


class FrameSource:
    """The frames handed to `System.run_sequence`: every read of a frame is
    a request for input, so it goes through the clock first."""

    def __init__(self, frames: Sequence, clock: Clock):
        self.frames = frames
        self.clock = clock
        self.pulled: List[int] = []

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int):
        self.clock.pull()
        self.pulled.append(int(i))
        return self.frames[i]


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over all values."""
    if not len(values):
        raise ValueError("percentile of no values")
    xs = sorted(float(v) for v in values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Inter-quartile distance over the median, with the quartiles of
    `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals: Iterable[Tuple[int, int]],
                 lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
