"""The cooperative cell coop-pair-640x480.merge: its configuration, mix,
driver, limits and readers found by name; the configuration is the
replay cell's system block with the merge's one override; the readers'
arithmetic on recorded spans; no file it adds imports JAX; and a whole run
without the card (the cell cut to the CPU's size) with
`CoopAgent._try_merge` planted out reads `correct` false on `ate_m`, where
the same run unbroken reads it true."""

import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.tests.bench_common import ROOT, full_cell, small_cell
from benchmark.harness import checks, main, window

CELL = "coop-pair-640x480.merge"


def test_the_cell_is_found_by_name():
    cell = full_cell(CELL)
    drv = cell.driver()
    assert cell.config_name == "coop-pair-640x480"
    assert cell.traffic_name == "merge" and cell.traffic["driver"] == "coop"
    assert callable(drv.setup) and callable(drv.run_window) \
        and callable(drv.outcomes)
    assert cell.chips == 1
    # the two coop readers, the five that every frames_per_s cell reports,
    # and two of the replay cell's that read the per-frame path too
    assert {m.name for m in cell.per_layer} == {
        "receive_packet_ms", "coop_ms_per_frame", "device_idle_pct",
        "device_busy_ms_per_frame", "kernel_us_per_frame",
        "fast_score_nms_roofline", "host_syncs_per_frame",
        "readback_wait_ms_per_frame", "backend_insert_ms"}
    assert {m.name for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    assert set(checks.limits(cell)) == {
        "frame_mismatch_pct", "k2_rows_differ", "k3_gap_px",
        "ba_cost_excess_pct", "sim3_gap_px", "ate_m"}
    for m in cell.per_layer:
        assert callable(cell.readers[m.name].read)


def test_the_configuration_is_the_replay_block_and_the_merge_gate():
    coop = full_cell(CELL).config
    replay = full_cell("tum-fr1-mono.replay").config
    want = copy.deepcopy(replay["system"])
    want["loop"]["sim3_min_bow_matches"] = 25
    assert coop["system"] == want
    assert coop["enable_loop_closing"] is False
    assert coop["mapper_cycle_s"] == replay["mapper_cycle_s"] == 0.1
    assert len(coop["source"]) <= 200
    assert set(coop["reduced"]) == {"imagery", "session_frames", "hosts"}
    t = full_cell(CELL).traffic
    assert t["scene_seeds"] == t["trajectory_seeds"] == [1, 2, 7400002,
                                                          7400007]
    assert (t["publish_every"], t["max_batch"]) == (8, 10)
    drv = full_cell(CELL).driver()
    assert drv.split(t) == (65, 43)              # frames 0-64 and 43-129
    assert drv.split(t, warmup=True) == (24, 15)


class _Span:
    def __init__(self, name, a, b, parent=-1):
        self.name, self.start_ns, self.end_ns = name, a, b
        self.parent, self.ids = parent, {}


class _TD:
    def __init__(self, frames):
        self.t0_ns, self.t1_ns, self.frames = 0, 1000, frames


def _readers(monkeypatch, recs):
    from coslam_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    cell = full_cell(CELL)
    return cell.readers["receive_packet_ms"], cell.readers["coop_ms_per_frame"]


def test_the_readers_arithmetic(monkeypatch):
    recs = [_Span("coop.receive_packet", 100, 300),
            _Span("coop.merge", 150, 250, parent=0),
            _Span("coop.receive_packet", 400, 500),
            _Span("coop.drain", 450, 700),
            _Span("coop.publish", 900, 1100),      # leaves the window
            _Span("track.frame", 0, 1000)]
    rp, cm = _readers(monkeypatch, recs)
    assert rp.read(_TD(4)) == pytest.approx((200 + 100) / 2 / 1e6)
    # union: [100, 300) and [400, 700)
    assert cm.read(_TD(4)) == pytest.approx(500 / 4 / 1e6)


def test_the_readers_read_nothing_without_coop_spans(monkeypatch):
    rp, cm = _readers(monkeypatch, [_Span("track.frame", 0, 1000)])
    assert rp.read(_TD(4)) is None and cm.read(_TD(4)) is None
    rp, cm = _readers(monkeypatch, [])
    assert rp.read(_TD(0)) is None and cm.read(_TD(0)) is None


IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness import spec
cell = spec.cell("coop-pair-640x480.merge")
drv = cell.driver()
import benchmark.reference.coop
import coslam_tpu_torch.cli, coslam_tpu_torch.models.cooperative
sys.path.insert(0, {root!r} + "/scripts")
import coop_merge_sweep, coop_reference_check
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_cell_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORTS.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "coslam_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "coslam_tpu"}


def _small():
    """The cell at the CPU's size: 320x240, 500 features, and one short
    scene at the mix's 2 degrees a frame, so that a pair finishes.  An
    ATE scales with the trajectory's extent, so `ate_m`'s limit is the
    cell's scaled by the arc's length (40 of the cell's 130 frames): on
    the CPU a sound pair reads 0.065 m and one with its merge planted out
    0.70 m against 0.246 m."""
    cell = small_cell(CELL)
    t = cell.traffic
    share = 40 / t["frames"]
    t["frames"] = 40
    t["trajectory"] = dict(t["trajectory"],
                           frac=t["trajectory"]["frac"] * share)
    cell.limits = dict(cell.limits, ate_m=cell.limits["ate_m"] * share)
    t["scene_seeds"] = t["trajectory_seeds"] = [1]
    t["receiver_frames"], t["sender_start"] = 20, 13
    t["warmup_frames"] = 12
    t["warmup_receiver_frames"], t["warmup_sender_start"] = 12, 8
    t["drain_timeout_ms"] = 5
    return cell


def _plant_merge(patches):
    from coslam_tpu_torch.models import cooperative
    patches.replace(cooperative.CoopAgent, "_try_merge",
                    lambda inner: lambda self, fk, aid: False)


class _OnePair(window.Clock):
    """The window's clock, closed at the request for the second pair's
    input (its first pull), whatever the time: one whole pair a window."""

    pulls = 0

    def pull(self):
        self.n = getattr(self, "n", 0) + 1
        if self.n >= self.pulls:
            self.seconds = 0.0
        super().pull()


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    cell = _small()
    split0, start1 = cell.driver().split(cell.traffic)
    mp.setattr(_OnePair, "pulls", 2 + split0 + cell.traffic["frames"]
               - start1)
    mp.setattr(window, "Clock", _OnePair)
    out = {}
    try:
        for name, fault in (("sound", None), ("planted", _plant_merge)):
            torch.manual_seed(0)
            out[name] = main.run(_small(), 2**31 + 11, 1e6, False,
                                 time.perf_counter(), device="cpu",
                                 workers=2, faults=fault)
    finally:
        mp.undo()
    return out


def _ate(res):
    return next(r for r in res["checks"] if r[0] == "ate_m")[1]


def test_a_pair_without_its_merge_is_not_correct(runs):
    sound, planted = runs["sound"], runs["planted"]
    for res in (sound, planted):
        assert res["window"]["sessions"] == 2
        assert res["window"]["sessions_finished"] == 2
    recv = [s for s in sound["window"]["per_session"] if s["merges"] or
            s["packets_integrated"]]
    assert recv and all(s["merges"] == 1 for s in recv)
    assert sound["correct"] is True
    assert planted["correct"] is False
    assert _ate(planted) > checks.limits(_small())["ate_m"] >= _ate(sound)
