"""coslam_tpu_torch.cli (the `coop` mode) and utils/profiling against
coslam_tpu's: the two-agent driver's schedule (which agent tracks which
frame, when packets are published, buffered and received) equals the JAX
CLI's `run_coop` on the same recording agents; the CLI runs on the GPU
unless asked for the CPU; StageTimer's summary and trace()'s output.  The
dataset modes: tests/test_torch_cli_datasets.py."""

import json

import numpy as np
import pytest
import torch

from coslam_tpu import cli as jcli
from coslam_tpu.models import cooperative as jcoop
from coslam_tpu.utils import profiling as jprof
from coslam_tpu_torch import cli as tcli
from coslam_tpu_torch.models import cooperative as tcoop
from coslam_tpu_torch.utils import profiling as tprof


class FakeAgent:
    """Records the driver's calls; becomes OK after `init_after` frames."""

    def __init__(self, log, agent_id, init_after):
        self.log, self.agent_id = log, agent_id
        self.init_after, self.seen, self.n_pub = init_after, 0, 0
        self.state = "NOT_INITIALIZED"

    def track_mono(self, img, f):
        self.log.append(("track", self.agent_id, int(f), int(img)))
        self.seen += 1
        if self.seen >= self.init_after:
            self.state = "OK"

    def drain_packets(self, max_batch=10):
        self.n_pub += 1
        self.log.append(("drain", self.agent_id, max_batch))
        return [f"{self.agent_id}.{self.n_pub}.{i}" for i in range(2)]

    def receive_packet(self, pkt):
        self.log.append(("receive", self.agent_id, pkt))
        return False


@pytest.mark.parametrize("frames,bidirectional", [(30, False), (41, True)])
def test_coop_driver_schedule_matches_reference(monkeypatch, frames,
                                                bidirectional):
    seq = np.arange(frames)
    split0 = max(int(frames * 0.50), 12)
    start1 = max(int(frames * 0.33), 8)
    jlog = []
    agents = iter([FakeAgent(jlog, 0, 11), FakeAgent(jlog, 1, 3)])
    monkeypatch.setattr(jcoop, "CoopAgent",
                        lambda cfg, aid, **kw: next(agents))
    monkeypatch.setattr(jcli, "_coop_setup",
                        lambda f, s: (None, None, seq, split0, start1))
    monkeypatch.setattr(jcli, "_coop_report", lambda a0, traj, timer: {})
    jcli.run_coop(frames=frames, publish_every=8, max_batch=10,
                  bidirectional=bidirectional,
                  timer=jprof.StageTimer(sync=False))
    tlog = []
    tcli.drive_coop(FakeAgent(tlog, 0, 11), FakeAgent(tlog, 1, 3), seq,
                    split0, start1, tcoop.InMemoryBus(), publish_every=8,
                    max_batch=10, bidirectional=bidirectional)
    assert tlog == jlog
    assert any(e[0] == "receive" and e[1] == 0 for e in tlog)


def test_cli_needs_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(["coop", "--frames", "12"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tprof.StageTimer()


def test_stage_timer_summary_matches_reference():
    jt, tt = jprof.StageTimer(sync=False), tprof.StageTimer(device="cpu")
    for t in (jt, tt):
        for dt in (0.003, 0.001, 0.002, 0.010):
            t.times["track"].append(dt)
        t.times["exchange"].append(0.5)
        with t("idle"):
            pass
    js, ts = jt.summary(), tt.summary()
    assert js.keys() == ts.keys()
    for k in ("track", "exchange"):
        assert ts[k] == js[k]
    assert tt.report().splitlines()[0] == jt.report().splitlines()[0]
    assert len(tt.report().splitlines()) == 4


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
