"""The cooperative pair over the port's UDP bus (models/cooperative.UdpBus
on the native multicast transport) on the CPU: a whole pump of real
keyframe packets published before one drain arrives complete and
byte-equal; `cli.drive_coop` over `UdpBus` leaves the receiver in the same
state as over `InMemoryBus`; `cli.run_coop_role` joins the bus before it
renders.  As in tests/test_torch_native_transport.py, each process takes
ports of its own (from its pid, away from 7667 and from that file's
ports), and each bus publishes on a channel named by a nonce and drains
that channel alone (the bus's wire format stays the reference's), so
that two runs on one host do not see each other's datagrams."""

import dataclasses
import os
import secrets
import shutil

import numpy as np
import pytest
import torch

from coslam_tpu_torch import cli
from coslam_tpu_torch.models import cooperative as tcoop
from coslam_tpu_torch.models import map_state as tms

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ available")

torch.set_num_threads(1)

# two ports a process, clear of test_torch_native_transport.py's four
PORT0 = 60000 - 2 * (os.getpid() % 10000)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "coslam_tpu_torch", "assets")


class Tap:
    """Stands in for a UdpBus's transport and keeps the payloads it sent
    and those it received on the bus's channel."""

    def __init__(self, tp, channel):
        self.tp, self.channel = tp, channel
        self.sent, self.received = [], []

    def publish(self, channel, data):
        self.sent.append(bytes(data))
        self.tp.publish(channel, data)

    def receive(self, timeout_ms=100, **kw):
        got = self.tp.receive(timeout_ms=timeout_ms, **kw)
        if got is not None and got[0] == self.channel:
            self.received.append(got[1])
        return got

    def close(self):
        self.tp.close()


def _bus(port):
    """A UdpBus on `port` and on a channel named by a nonce."""
    bus = tcoop.UdpBus(port=port, channel=f"KeyFrame{secrets.token_hex(8)}")
    bus._tp = Tap(bus._tp, bus.channel)
    return bus


def _merge_map():
    """The JAX run's receiver map before its merge (smoke_coop_merge.npz)."""
    z = np.load(os.path.join(ASSETS, "smoke_coop_merge.npz"))
    f = {}
    for k in tms.MapState._fields:
        a = np.array(z[f"map_{k}"])
        f[k] = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)
    return tms.MapState(**f)


def test_a_full_pump_arrives_complete_and_byte_equal():
    """Ten keyframe packets at 640x480 / 1024 keypoints (a pump's most,
    `drive_coop`'s max_batch) published back to back, then one drain."""
    m = _merge_map()
    valid = np.nonzero(m.kf_valid.numpy())[0]
    assert len(valid) >= 10
    pkts = [tcoop.pack_keyframe(m, int(k), 1) for k in valid[:10]]
    bus = _bus(PORT0)
    try:
        bus.publish(1, pkts)
        got = bus.drain(0, timeout_ms=500)
    finally:
        bus.close()
    tap = bus._tp
    assert len(tap.sent) == 10 and sum(map(len, tap.sent)) > 300_000
    assert sorted(tap.received) == sorted(tap.sent)
    assert [p.frame_id for p in got] == [p.frame_id for p in pkts]
    for a, b in zip(got, pkts):
        for k in tcoop.KeyFramePacket._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                          np.asarray(getattr(b, k)), k)


def test_a_packet_above_the_receive_buffer_arrives_and_grows_it():
    """A packet larger than the bus's receive buffer is taken whole with
    the transport's default buffer, and the buffer grows to it."""
    m = _merge_map()
    k = int(np.nonzero(m.kf_valid.numpy())[0][0])
    pkts = [tcoop.pack_keyframe(m, k, 1)] * 2
    bus = _bus(PORT0)
    bus._buf_len = 1000
    try:
        bus.publish(1, pkts)
        got = bus.drain(0, timeout_ms=500)
    finally:
        bus.close()
    tap = bus._tp
    assert len(tap.sent[0]) > 1000
    assert tap.received == tap.sent
    assert bus._buf_len == len(tap.sent[0])
    assert len(got) == 2
    for k in tcoop.KeyFramePacket._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got[1], k)),
                                      np.asarray(getattr(pkts[1], k)), k)


def test_bus_drains_its_own_channel_alone():
    """Two buses on one port and group, on two channels: each drains the
    packets published on its own channel and none of the other's; the
    default channel is the reference's."""
    m = _merge_map()
    k = [int(i) for i in np.nonzero(m.kf_valid.numpy())[0][:2]]
    assert tcoop.UdpBus.CHANNEL == "KeyFrameexample"
    a = tcoop.UdpBus(port=PORT0 + 2, channel=f"KeyFrame{secrets.token_hex(8)}")
    b = tcoop.UdpBus(port=PORT0 + 2, channel=f"KeyFrame{secrets.token_hex(8)}")
    try:
        a.publish(1, [tcoop.pack_keyframe(m, k[0], 1)])
        b.publish(2, [tcoop.pack_keyframe(m, k[1], 2)])
        got_a = a.drain(0, timeout_ms=500)
        got_b = b.drain(0, timeout_ms=500)
    finally:
        a.close()
        b.close()
    assert [(p.agent_id, p.frame_id) for p in got_a] == \
        [(1, int(m.kf_frame_id[k[0]]))]
    assert [(p.agent_id, p.frame_id) for p in got_b] == \
        [(2, int(m.kf_frame_id[k[1]]))]


def _pair(bus, cfg, seq, split0, start1, drain_kw=None):
    agents = []
    for aid in (0, 1):
        a = tcoop.CoopAgent(cfg, aid, device="cpu",
                            enable_loop_closing=False)
        # the mapper cycle pinned: the InterruptBA window would read the
        # host's clock
        a._insert_cost_s = 0.1
        a._note_insert_cost = lambda dt: None
        agents.append(a)
    received = []
    inner = agents[0].receive_packet

    def receive(pkt):
        received.append(pkt.frame_id)
        return inner(pkt)

    agents[0].receive_packet = receive
    cli.drive_coop(*agents, seq, split0, start1, bus, drain_kw=drain_kw)
    return agents[0], received


def test_drive_coop_over_udp_equals_in_memory():
    """The CLI's 320x240 / 400-feature pair over 50 frames at K=32,
    P=2048: the receiver integrates the same packets in the same order
    over both buses and ends in the same state, bit for bit."""
    cfg, _traj, seq, split0, start1 = cli._coop_setup(50, 5)
    cfg = cfg.replace(mapper=dataclasses.replace(
        cfg.mapper, max_keyframes=32, max_points=2048))
    mem, got_mem = _pair(tcoop.InMemoryBus(), cfg, seq, split0, start1)
    bus = _bus(PORT0 + 1)
    try:
        udp, got_udp = _pair(bus, cfg, seq, split0, start1,
                             {"timeout_ms": 50})
    finally:
        bus.close()
    assert got_mem and got_udp == got_mem
    assert sorted(bus._tp.received) == sorted(bus._tp.sent)
    for k in ("kf_pose", "kf_valid", "kf_frame_id", "kf_obs_pt", "pt_pos",
              "pt_valid"):
        assert torch.equal(getattr(udp.map, k), getattr(mem.map, k)), k
    np.testing.assert_array_equal(udp.kf_agent, mem.kf_agent)
    assert udp.n_merges == mem.n_merges
    assert (udp.kf_agent == 1).sum() > 0


def test_run_coop_role_joins_the_bus_before_rendering(monkeypatch, capsys):
    """A sender's packets published before the receiver has joined the
    group are lost without an error, so the receiver binds first and says
    so before its slow set-up."""
    order = []

    class Bus:
        def __init__(self, **kw):
            order.append("bus")

        def close(self):
            order.append("close")

    def setup(frames, seed):
        order.append("render")
        raise RuntimeError("stop")

    monkeypatch.setattr(tcoop, "UdpBus", Bus)
    monkeypatch.setattr(cli, "_coop_setup", setup)
    with pytest.raises(RuntimeError, match="stop"):
        cli.run_coop_role("receiver", device="cpu")
    assert order == ["bus", "render", "close"]
    assert "receiver: listening on the bus" in capsys.readouterr().out
    with pytest.raises(ValueError, match="role"):
        cli.run_coop_role("observer", device="cpu")
