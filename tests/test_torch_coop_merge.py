"""The cooperative merge on the CPU, end to end: `cli._coop_setup`'s
configuration (320x240, 400 features, the merge's gates; the map's
capacity cut to K=32, P=4096 for the CPU, the mapper cycle pinned at
0.1 s) on three seeded scenes, each a 40-frame arc at the benchmark mix's
2 degrees a frame split as `_coop_setup` splits it, the pair driven by
`cli.drive_coop` over `InMemoryBus` or over `UdpBus` (a port from this
process's pid and a channel named by a nonce, as
tests/test_torch_coop_udp.py keeps them).  About 40 s a pair on one
worker:

  * the finished pair merges, and every keyframe the sender published is
    integrated;
  * every foreign keyframe, as the receiver's wire reconstruction wrote
    it, equals what benchmark/reference/coop.py rebuilds from its packet
    (keypoints, levels, angles, descriptor bits and the landmark dedup
    exactly; the pose and new landmarks under the stored alignment within
    the reference's float32 tolerance), and every verified cross-agent
    Sim3 equals the float64 composition of its own inputs;
  * under a profiler, a `coop.merge` span carries the gate that ended its
    attempt, counted in the agent's `merge_gates`, a `coop.realign` span
    its gate, and the pump's `coop.publish` / `coop.drain` spans their
    packet counts;
  * an unmerged sender's keyframes and landmarks are out of the own
    tracking's map and relocalization's candidates, and back after it."""

import os
import secrets
import shutil
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coslam_tpu_torch import cli
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import cooperative as tcoop
from coslam_tpu_torch.utils import profiling, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from benchmark.harness.capture import Patches  # noqa: E402
from coop_reference_check import Capture  # noqa: E402

torch.set_num_threads(1)

FRAMES = 40
DEG_PER_FRAME = 0.72 / 130          # the benchmark mix's arc a frame
# (scene seed, bus)
PAIRS = [(1, "memory"), (2, "udp"), (3, "memory")]
# a port from this process's pid; the channel's nonce keeps two buses
# that meet on one port apart
PORT = 50000 - 2 * (os.getpid() % 5000)


def _bus(kind):
    if kind == "memory":
        return tcoop.InMemoryBus()
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the UDP transport")
    return tcoop.UdpBus(port=PORT,
                        channel=f"KeyFrame{secrets.token_hex(8)}")


def _run(seed, kind):
    cfg, _traj, _seq, _s0, _s1 = cli._coop_setup(FRAMES, seed)
    cfg = cfg.replace(mapper=tcfg.MapperConfig(max_keyframes=32,
                                               max_points=4096))
    traj = synthetic.make_loop_trajectory(FRAMES, seed=seed,
                                          frac=DEG_PER_FRAME * FRAMES)
    seq = synthetic.render_sequence(
        cfg.camera, traj, synthetic.make_cylinder_scene(700, seed=seed))
    split0 = max(int(FRAMES * 0.50), 12)
    start1 = max(int(FRAMES * 0.33), 8)
    a0 = tcoop.CoopAgent(cfg, 0, device="cpu", enable_loop_closing=False)
    a1 = tcoop.CoopAgent(cfg, 1, device="cpu", enable_loop_closing=False)
    for a in (a0, a1):                   # the mapper cycle pinned
        a._insert_cost_s = 0.1
        a._note_insert_cost = lambda dt: None
    bus = _bus(kind)
    drain_kw = {"timeout_ms": 50} if kind == "udp" else None
    cap, patches = Capture(), Patches()
    cap.install(patches)
    try:
        cli.drive_coop(a0, a1, seq, split0, start1, bus, drain_kw=drain_kw)
    finally:
        patches.restore()
    return a0, a1, cap, bus, drain_kw


@pytest.fixture(scope="module", params=PAIRS,
                ids=[f"scene{s}-{b}" for s, b in PAIRS])
def pair(request):
    out = _run(*request.param)
    yield out
    if request.param[1] == "udp":
        out[3].close()


def test_the_pair_merges_and_integrates_every_packet(pair):
    a0, a1, _cap, _bus, _kw = pair
    assert a0.state == "OK" and a1.state == "OK"
    assert a0.merged_agents == {1: True}
    assert a1._published_kfs > 0
    assert a0.packets_integrated == a1._published_kfs
    assert int((a0.kf_agent[:int(a0.map.n_kf)] == 1).sum()) \
        == a1._published_kfs
    assert a0.merge_gates["ok"] >= 1


def test_the_receiver_holds_what_the_reference_rebuilds(pair):
    a0, a1, cap, _bus, _kw = pair
    verdict = cap.judge()
    assert verdict["packets"] == a0.packets_integrated
    assert verdict["packets_ok"] == verdict["packets"]
    assert verdict["exact_fields_differing"] == 0
    assert verdict["aligned_packets"] >= 1 or a1._published_kfs <= 10
    assert verdict["sim3"] >= 1
    # S_w composed in float32 from the same inputs: a few ulps
    assert verdict["sim3_s_rel_max"] < 1e-5
    assert verdict["sim3_R_deg_max"] < 1e-4
    assert verdict["sim3_t_rel_max"] < 1e-5


def test_each_merge_span_carries_its_gate(pair):
    """Under a profiler (spans record only there): a merge attempt and a
    realignment on the finished pair's receiver, and two more pumps of
    `drive_coop` on the pair's bus."""
    a0, a1, _cap, bus, drain_kw = pair
    own, fore = a0._own_and_foreign(1)
    before = dict(a0.merge_gates)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        a0._try_merge(int(fore[0]), 1)
        a0._try_realign(int(fore[-1]), 1)
        cli.drive_coop(a0, a1, [], 0, 0, bus, drain_kw=drain_kw)
    recs = list(profiling.spans())
    merges = [r for r in recs if r.name == "coop.merge"]
    assert len(merges) == 1 and merges[0].ids["gate"] in tcoop.GATES
    assert merges[0].ids["kf"] == int(fore[0])
    after = dict(before, **{merges[0].ids["gate"]:
                            before[merges[0].ids["gate"]] + 1})
    assert a0.merge_gates == after
    realigns = [r for r in recs if r.name == "coop.realign"]
    assert realigns and all(r.ids.get("gate") in tcoop.GATES
                            for r in realigns)
    pumps = [r for r in recs if r.name in ("coop.publish", "coop.drain")]
    assert sorted(r.name for r in pumps) == ["coop.drain"] * 2 \
        + ["coop.publish"] * 2
    assert all(r.ids["packets"] == 0 for r in pumps)   # nothing left
    assert profiling.span("coop.merge") is profiling.span("coop.drain")


def _packet(rng, agent_id, pt_id):
    """A wire keyframe of `agent_id` observing the landmarks `pt_id` (-1:
    a keypoint without one)."""
    n = len(pt_id)
    return tcoop.KeyFramePacket(
        agent_id, 40, np.eye(4, dtype=np.float32),
        rng.uniform(0, 300, (n, 2)).astype(np.float32),
        rng.integers(0, 8, n).astype(np.int32),
        rng.uniform(-3, 3, n).astype(np.float32),
        rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32),
        np.ones(n, bool), pt_id >= 0,
        np.where((pt_id >= 0)[:, None], rng.normal(0, 3, (n, 3)),
                 0).astype(np.float32), pt_id)


def test_a_young_map_counts_nminobs_without_an_unmerged_sender(monkeypatch):
    """nMinObs is 2 while the map holds at most 2 keyframes: the keyframes
    of a sender not merged yet fill slots of the map but are not counted,
    a merged sender's are.  Slots 0 and 1 hold agent 1's keyframes, which
    observe the same landmarks (each seen twice), slot 2 agent 2's."""
    cfg = tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320,
                                 height=240),
        extractor=tcfg.ExtractorConfig(n_features=100, max_keypoints=128),
        mapper=tcfg.MapperConfig(max_keyframes=8, max_points=1024))
    a = tcoop.CoopAgent(cfg, 0, device="cpu", enable_loop_closing=False)
    rng = np.random.default_rng(0)
    n = 128
    pt_id = np.where(rng.random(n) < 0.5, np.arange(n), -1).astype(np.int64)
    for agent in (1, 1, 2):
        a._foreign_agents.add(agent)
        a._integrate_packet(_packet(rng, agent, pt_id), full_backend=False)
    assert a._host_n_kf == 3 and list(a.kf_agent[:3]) == [1, 1, 2]
    seen = []
    monkeypatch.setattr(tcoop.System, "_need_keyframe",
                        lambda self, n_inl, need_close=False:
                        seen.append(self.ref_kf_matches) or False)
    a.merged_agents[1] = True
    a.last_ref_kf = 0
    a.ref_kf_matches = -1                  # the tracker's count (nMinObs 3)
    a._need_keyframe(100)
    assert seen[-1] == int((pt_id >= 0).sum())
    # no sender left unmerged: the tracker's count stands
    a.merged_agents[2] = True
    a.ref_kf_matches = -1
    a._need_keyframe(100)
    assert seen[-1] == -1
