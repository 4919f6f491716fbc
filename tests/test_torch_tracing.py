"""The program's spans (coslam_tpu_torch/utils/profiling.py: `span`,
`spans`, the readers' arithmetic) and the four benchmark readers of them
(benchmark/metrics/{tracking_host_ms_per_frame, place_recognition_ms,
sim3_verify_ms, readback_wait_ms_per_frame}.py), on the CPU.

A span records only under a torch profiler, on `time.time_ns()`, around
its own `record_function` range; placed in a short run of the synthetic
scene it nests as the layers do, and the run's trajectory, map and
counters are bit-equal with tracing on and off.  The `cuda` test shows on
the card that a span around a queued kernel and its readback holds the
kernel's launch and its device interval, under the profiler's CUDA-only
setting too; on a GPU machine (which need not have jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_tracing.py
"""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.utils import profiling, synthetic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("tracking_host_ms_per_frame", "place_recognition_ms",
           "sim3_verify_ms", "readback_wait_ms_per_frame")
MS = 1_000_000


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(prof):
    return list(prof.profiler.kineto_results.events())


# -- the recorder ------------------------------------------------------------

def test_span_is_off_outside_a_profiler():
    profiling.clear_spans()
    assert not torch.autograd._profiler_enabled()
    a = profiling.span("track.chunk", frame=3)
    b = profiling.span("loop.verify", kf=7, candidate=2)
    assert a is b
    with a as sp:
        sp.set(inliers=12)
    assert profiling.spans() == []


def test_span_records_names_parents_and_ids():
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        with profiling.span("flush", kf=4):
            with profiling.span("sync.backend", kf=4):
                pass
            with profiling.span("loop.verify", kf=4, candidate=1) as sp:
                sp.set(inliers=25)
        with profiling.span("track.chunk", frame=8):
            pass
    recs = profiling.spans()
    assert [(r.name, r.parent, r.ids) for r in recs] == [
        ("flush", -1, {"kf": 4}),
        ("sync.backend", 0, {"kf": 4}),
        ("loop.verify", 0, {"kf": 4, "candidate": 1, "inliers": 25}),
        ("track.chunk", -1, {"frame": 8})]
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert recs[0].start_ns <= recs[1].start_ns <= recs[1].end_ns \
        <= recs[2].start_ns <= recs[2].end_ns <= recs[0].end_ns
    # off again once the profiler stops
    with profiling.span("session.run"):
        pass
    assert len(profiling.spans()) == 4


def test_span_holds_its_record_function_range():
    """Each span's [start_ns, end_ns] on time.time_ns() contains the
    profiler's timestamps of its record_function range (within 1 ms)."""
    profiling.clear_spans()
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with profiling.span(f"probe.{k}"):
                for _ in range(5):
                    x = x @ x / 64.0
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in _events(prof) if e.name().startswith("probe.")}
    recs = profiling.spans()
    assert sorted(ranges) == [r.name for r in recs]
    for r in recs:
        a, b = ranges[r.name]
        print(f"{r.name}: range starts {(a - r.start_ns) / 1e3:.1f} us "
              f"after the span, ends {(r.end_ns - b) / 1e3:.1f} us before")
        assert r.start_ns - MS <= a <= b <= r.end_ns + MS


def test_window_self_time_and_union():
    S = profiling.Span
    recs = [S("session.run", -1, {}), S("track.chunk", 0, {}),
            S("sync.chunk", 1, {}), S("flush", 1, {}),
            S("sync.backend", 3, {})]
    for r, (a, b) in zip(recs, [(0, 100), (10, 60), (20, 30), (25, 50),
                                (40, 45)]):
        r.start_ns, r.end_ns = a, b
    # the chunk's children cover 20-30 and 25-50: 30 of its 50
    assert profiling.self_ns(recs, [1, 2, 4]) == [20, 10, 5]
    assert profiling.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert profiling.union_ns([]) == 0
    assert profiling.spans_in_window(recs, 5, 60) == [1, 2, 3, 4]
    open_span = S("session.shutdown", -1, {})
    open_span.start_ns = 70                    # still open: never counted
    assert profiling.spans_in_window(recs + [open_span], 0, 200) \
        == [0, 1, 2, 3, 4]


# -- the readers' arithmetic on hand-made spans -------------------------------

def _spans(*rows):
    """(name, parent, start, end) rows -> records; times in ms."""
    out = []
    for name, parent, a, b in rows:
        r = profiling.Span(name, parent, {})
        r.start_ns, r.end_ns = a * MS, b * MS
        out.append(r)
    return out


HAND = _spans(
    ("session.run", -1, 0, 1000),               # 0
    ("track.chunk", 0, 10, 110),                # 1: self 100 - 40 - 20 = 40
    ("sync.chunk", 1, 20, 60),                  # 2
    ("flush", 1, 80, 100),                      # 3
    ("sync.backend", 3, 82, 90),                # 4
    ("loop.on_keyframe", 3, 90, 100),           # 5
    ("loop.detect", 5, 91, 94),                 # 6
    ("loop.verify", 5, 94, 99),                 # 7
    ("track.frame", 0, 200, 230),               # 8: self 30 - 15 = 15
    ("sync.frame", 8, 205, 215),                # 9
    ("sync.upload", 8, 210, 220),               # 10: overlaps 9 by 5
    ("loop.on_keyframe", 0, 300, 310),          # 11
    ("loop.detect", 11, 301, 302),              # 12
    ("track.chunk", 0, 1100, 1200),             # 13: past the window
    ("sync.chunk", 13, 1110, 1120),             # 14
)


@pytest.mark.parametrize("name,window,frames,expect", [
    ("tracking_host_ms_per_frame", (0, 1000), 10, (40 + 15) / 10),
    ("tracking_host_ms_per_frame", (150, 2000), 4, (15 + 90) / 4),
    ("place_recognition_ms", (0, 1000), 10, (3 + 1) / 2),
    ("place_recognition_ms", (250, 1000), 10, 1.0),
    ("sim3_verify_ms", (0, 1000), 10, 5 / 2),
    ("sim3_verify_ms", (250, 1000), 10, 0.0),
    ("readback_wait_ms_per_frame", (0, 1000), 10, (40 + 8 + 15) / 10),
    ("readback_wait_ms_per_frame", (0, 2000), 7, (40 + 8 + 15 + 10) / 7),
])
def test_reader_arithmetic(monkeypatch, name, window, frames, expect):
    monkeypatch.setattr(profiling, "spans", lambda: HAND)
    td = SimpleNamespace(t0_ns=window[0] * MS, t1_ns=window[1] * MS,
                         frames=frames)
    assert _reader(name).read(td) == pytest.approx(expect, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_spans(monkeypatch, name):
    td = SimpleNamespace(t0_ns=0, t1_ns=10 ** 12, frames=10)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _reader(name).read(td) is None
    # spans only outside the window
    monkeypatch.setattr(profiling, "spans", lambda: HAND)
    td = SimpleNamespace(t0_ns=2000 * MS, t1_ns=3000 * MS, frames=10)
    assert _reader(name).read(td) is None


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """A program that predates the spans: the readers return None."""
    td = SimpleNamespace(t0_ns=0, t1_ns=10 ** 12, frames=10)
    for attr in ("spans", "spans_in_window", "self_ns", "union_ns"):
        monkeypatch.delattr(profiling, attr)
    for name in READERS:
        assert _reader(name).read(td) is None


# -- placement in a run, and no side effects ---------------------------------

def _cfg():
    # tests/test_torch_lifecycle.py's configuration
    return tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=260, fy=260, cx=160, cy=120, width=320,
                                 height=240),
        extractor=tcfg.ExtractorConfig(n_features=300, max_keypoints=256),
        mapper=tcfg.MapperConfig(max_keyframes=12, max_points=2048,
                                 triangulation_neighbors=4),
        tracker=tcfg.TrackerConfig(init_min_matches=50, init_min_good=30))


def _session(cfg, seq):
    s = System(cfg, device="cpu")
    s._insert_cost_s = 0.1                      # the mapper cycle pinned
    s._note_insert_cost = lambda dt: None
    s.run_sequence(seq)
    s.shutdown()
    return s


@pytest.fixture(scope="module")
def runs():
    """13 frames (initialisation at frame 3, then chunks with overlapped
    inserts and their flushes), once under the profiler and once not."""
    cfg = _cfg()
    traj = synthetic.make_trajectory(40, seed=7)
    seq = synthetic.render_sequence(cfg.camera, traj,
                                    synthetic.make_scene(500, seed=7))[:13]
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        on = _session(cfg, seq)
    recs = list(profiling.spans())
    off = _session(cfg, seq)
    assert len(profiling.spans()) == len(recs)     # nothing more recorded
    return on, off, recs


def _chain(recs, names):
    """True if some span of names[-1] has the others as its ancestors, in
    order, each interval inside its parent's."""
    for i, r in enumerate(recs):
        if r.name != names[-1]:
            continue
        j, ok = i, True
        for want in reversed(names[:-1]):
            p = recs[j].parent
            ok = p >= 0 and recs[p].name == want \
                and recs[p].start_ns <= recs[j].start_ns \
                and recs[j].end_ns <= recs[p].end_ns
            if not ok:
                break
            j = p
        if ok:
            return True
    return False


def test_spans_placed_at_the_layers(runs):
    on, _off, recs = runs
    names = {r.name for r in recs}
    assert {"session.new", "session.run", "session.shutdown", "track.frame",
            "track.chunk", "sync.chunk", "sync.upload", "sync.frame",
            "backend.insert", "flush", "sync.backend", "loop.on_keyframe",
            "loop.detect", "sync.loop"} <= names
    assert _chain(recs, ["session.run", "track.chunk", "sync.chunk"])
    assert _chain(recs, ["flush", "loop.on_keyframe", "loop.detect"])
    assert _chain(recs, ["session.run", "track.chunk", "backend.insert"])
    assert all(r.end_ns is not None and r.start_ns <= r.end_ns for r in recs)
    # ids: a chunk names its first frame, an insert the keyframe slot it
    # fills, a flush its newest pending keyframe
    chunks = [r.ids["frame"] for r in recs if r.name == "track.chunk"]
    assert chunks == sorted(chunks) and chunks[0] > 0
    # on the CPU every chunk runs eagerly: no CUDA graph
    assert {r.ids["graph"] for r in recs if r.name == "track.chunk"} \
        == {"eager"}
    assert on.n_chunks_graphed == 0
    kfs = [r.ids["kf"] for r in recs if r.name == "backend.insert"]
    assert kfs == list(range(2, 2 + len(kfs)))
    flushed = [r.ids["kf"] for r in recs if r.name == "flush"]
    assert flushed and set(flushed) <= set(kfs)
    assert on.n_frames_chunked > 0


def test_tracing_changes_nothing(runs):
    on, off, _recs = runs
    ids_on, T_on = on.trajectory_poses()
    ids_off, T_off = off.trajectory_poses()
    assert ids_on == ids_off and np.array_equal(T_on, T_off)
    assert on.stats == off.stats
    for k in ("n_frames_chunked", "n_frames_discarded", "n_chunks_graphed",
              "n_loops_closed", "n_frames_tracked", "_host_n_kf",
              "_host_n_pt"):
        assert getattr(on, k) == getattr(off, k), k
    assert on.loop_closer.n_host_syncs == off.loop_closer.n_host_syncs
    assert on.db.n_device_reads == off.db.n_device_reads
    for a, b in zip(on.map, off.map):
        assert torch.equal(a, b)
    assert np.array_equal(on.db.bows, off.db.bows)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_card():
    """A span around a queued kernel and its readback contains the kernel's
    launch call and its device interval in the profiler's trace: the host's
    clock and the trace's agree on the card.  The check is on under the
    benchmark's own setting (CUDA activity only) too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    x = torch.zeros(1, device=dev)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("probe"):
            torch.cuda._sleep(20_000_000)        # spin_kernel, ~10 ms
            y = (x + 1).cpu()
    assert y.item() == 1.0
    (rec,) = profiling.spans()
    evs = _events(prof)
    kernels = {e.correlation_id(): e for e in evs
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()
               and "spin_kernel" in e.name()}
    assert kernels, sorted({e.name() for e in evs})
    launch = [e for e in evs if e.name().startswith("cu")
              and e.correlation_id() in kernels]
    assert launch
    k = next(iter(kernels.values()))
    l0 = launch[0].start_ns()
    k0, k1 = k.start_ns(), k.start_ns() + k.duration_ns()
    print(f"card: launch {(l0 - rec.start_ns) / 1e3:.1f} us after the span "
          f"opens; kernel {(k0 - rec.start_ns) / 1e3:.1f} us after it opens "
          f"and {(rec.end_ns - k1) / 1e3:.1f} us before it closes; "
          f"kernel {k.duration_ns() / 1e3:.1f} us")
    assert rec.start_ns <= l0 <= k0 <= k1 <= rec.end_ns
    assert k.duration_ns() > 1_000_000

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        on = torch.autograd._profiler_enabled()
        with profiling.span("probe.cuda_only"):
            (x + 2).cpu()
    assert on
    assert [r.name for r in profiling.spans()] == ["probe.cuda_only"]
