"""The metric arithmetic on synthetic inputs: the rate over the whole
window, the percentile, the quartile spread, the union of overlapping
device intervals and the idle share, and the window ending at the first
request for input after the deadline."""

import statistics

import numpy as np
import pytest

from benchmark.tests import bench_common  # noqa: F401
from benchmark.harness import trace
from benchmark.harness.window import (Clock, FrameSource, WindowClosed,
                                      merged, percentile, rate, spread,
                                      union_length)


def test_rate_is_over_the_whole_window():
    assert rate(120, 40.0) == 3.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


@pytest.mark.parametrize("q", [0, 50, 90, 95, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(3).exponential(200.0, 157)
    assert percentile(list(xs), q) == pytest.approx(np.percentile(xs, q))


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.0, 10.5, 12.0, 9.5]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert union_length(iv) == 15 + 10 + 1
    assert union_length(iv, lo=8, hi=28) == 7 + 8
    assert merged(iv) == [(0, 15), (20, 30), (40, 41)]


def test_idle_share_counts_overlap_once():
    kernels = [("k", 0, 400, 1), ("k", 200, 400, 2), ("k", 900, 100, 3)]
    td = trace.TraceData(t0_ns=0, t1_ns=2000, frames=4, kernels=kernels,
                         copies=[("Memcpy DtoH", 1500, 100)], runtime=[],
                         spans={}, outcome=None, config={},
                         busy=merged([(s, s + d) for _n, s, d, _c in kernels]
                                     + [(1500, 1600)]))
    assert td.busy_s == pytest.approx(800e-9)
    from benchmark.tests.bench_common import spec
    idle = spec.load_module(
        f"{bench_common.ROOT}/benchmark/metrics/device_idle_pct.py", "idle")
    assert idle.read(td) == pytest.approx(60.0)


def test_device_time_under_a_span():
    td = trace.TraceData(
        t0_ns=0, t1_ns=1000, frames=1,
        kernels=[("a", 300, 50, 1), ("b", 700, 20, 2), ("c", 900, 5, 3)],
        copies=[], runtime=[("cudaLaunchKernel", 100, 5, 1),
                            ("cudaLaunchKernel", 150, 5, 2),
                            ("cudaLaunchKernel", 600, 5, 3)],
        spans={"s": [(90, 200), (550, 650)]}, outcome=None, config={})
    assert td.device_ns_under("s") == [70, 5]


class FakeTime:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_ends_at_first_pull_after_deadline():
    now = FakeTime()
    closed = []
    clock = Clock(10.0, now=now, at_close=lambda: closed.append(now.t))
    clock.start()
    src = FrameSource(list(range(100)), clock)
    got = []
    with pytest.raises(WindowClosed):
        for i in range(100):
            now.t += 3.0           # each frame's work takes 3 s
            got.append(src[i])
    assert got == [0, 1, 2]        # pulls at 3, 6 and 9 s; the 12 s one closes
    assert clock.window_s == 12.0 and closed == [12.0]
    with pytest.raises(WindowClosed):
        clock.pull()               # closed stays closed
