"""Closed-loop cooperative pairs: back-to-back sessions, each a fresh
receiver (`CoopAgent` 0) and sender (`CoopAgent` 1) on a `UdpBus` of their
own, driven by the port's own two-agent loop (`cli.drive_coop`) over one of
the mix's fixed set of sequences (`scene_seeds`, `trajectory_seeds`), taken
in turn from an entry drawn from the seed, as drivers/replay.py takes them.
The receiver tracks frames [0, `receiver_frames`), the sender
[`sender_start`, frames) (the warm-up pair: `warmup_receiver_frames`,
`warmup_sender_start`); every `publish_every` steps, and twice at the end, the sender publishes up
to `max_batch` keyframes and the receiver integrates what it drained.  The
window ends at the first frame either agent pulls after the deadline, or at
the start of the next pair.

Each process's bus has a port of its own (from its pid) and a channel named
by a nonce, and drains that channel alone, so no other process on the host
can inject packets.

Per pair, two session records: the sender's own trajectory (every posed
frame), and the receiver's joint keyframe trajectory in its own world
frame: its own keyframes and, in a finished pair, every foreign keyframe it
integrated, merged or not, so that a merge that never came (or a wrong one)
fails `ate_m`; in a pair the window cut, the foreign keyframes of a merged
sender only.  Each record's counters are its agent's: packets published,
packets integrated, merges (first alignments of a sender) and realigns."""

from __future__ import annotations

import os
import secrets
import sys
from dataclasses import dataclass, field
from typing import List

import numpy as np

from benchmark.harness import outcome, program, render
from benchmark.harness.window import Clock, FrameSource, WindowClosed

@dataclass
class State:
    cfg: object
    config: dict
    traffic: dict
    sequences: List[tuple]          # (frames, ground-truth Tcw) per scene
    first: int                      # the pool entry the first pair plays
    device: str
    port: int
    channel: str
    n_sessions: int = 0
    warmup: dict = field(default_factory=dict)


@dataclass
class Pair:
    agents: tuple                   # (receiver, sender)
    gt: np.ndarray
    returned: tuple = field(default_factory=lambda: ([], []))
    finished: bool = False


def split(traffic: dict, warmup: bool = False):
    """(split0, start1) of `cli.drive_coop`: the receiver's frames and the
    sender's first frame, of the sessions or of the warm-up pair."""
    pre = "warmup_" if warmup else ""
    return (int(traffic[pre + "receiver_frames"]),
            int(traffic[pre + "sender_start"]))


def setup(cell, seed: int, device: str = "cuda", workers=None,
          stamp=lambda what: None) -> State:
    from coslam_tpu_torch.models import cooperative
    if not hasattr(cooperative, "GATES"):
        # the program keeps no count of integrated packets, realigns or
        # merge gates: it cannot give this mix's session records
        raise SystemExit("benchmark: this coslam_tpu_torch keeps no "
                         "cooperative counters (CoopAgent.merge_gates); "
                         "the merge mix needs them")
    sequences, first = render.fixed_sequences(cell, seed, workers)
    stamp("inputs")
    t = cell.traffic
    st = State(cfg=program.system_config(cell.config), config=cell.config,
               traffic=t, sequences=sequences, first=first, device=device,
               port=40000 + 2 * (os.getpid() % 5000),
               channel=f"KeyFrame.{os.getpid()}.{secrets.token_hex(6)}")
    # warm-up: a short pair over the first frames of the first sequence on
    # the cell's shapes (both initialisations, tracking, keyframe inserts,
    # pumps over the bus, integration and merge attempts)
    frames = sequences[first][0][:int(t["warmup_frames"])]
    a0, a1 = _pair(st)
    _drive(st, a0, a1, frames, split(t, warmup=True))
    st.warmup = {"merge_attempts": sum(a0.merge_gates.values()),
                 "gates": {k: v for k, v in a0.merge_gates.items() if v},
                 "packets_integrated": a0.packets_integrated}
    print(f"warm-up pair: {st.warmup}", file=sys.stderr)
    del a0, a1
    stamp("warm-up")
    return st


def _pair(st: State):
    from coslam_tpu_torch.models.cooperative import CoopAgent
    out = []
    for aid in (0, 1):
        a = CoopAgent(st.cfg, aid, device=st.device, enable_loop_closing=bool(
            st.config["enable_loop_closing"]))
        program.pin_mapper_cycle(a, st.config["mapper_cycle_s"])
        out.append(a)
    return tuple(out)


def _drive(st: State, a0, a1, frames, arcs) -> None:
    """One pair through `cli.drive_coop` on a bus of its own channel;
    `arcs` is (split0, start1)."""
    from coslam_tpu_torch import cli
    from coslam_tpu_torch.models.cooperative import UdpBus
    t = st.traffic
    split0, start1 = arcs
    bus = UdpBus(port=st.port, channel=f"{st.channel}.{st.n_sessions}")
    st.n_sessions += 1
    try:
        cli.drive_coop(a0, a1, frames, split0, start1, bus,
                       publish_every=int(t["publish_every"]),
                       max_batch=int(t["max_batch"]),
                       drain_kw={"timeout_ms": int(t["drain_timeout_ms"])})
    finally:
        bus.close()


def run_window(st: State, clock: Clock) -> List[Pair]:
    pairs: List[Pair] = []
    try:
        while True:
            clock.pull()                      # the next pair's input
            frames, gt = st.sequences[(st.first + len(pairs))
                                      % len(st.sequences)]
            rec = Pair(agents=_pair(st), gt=gt)
            pairs.append(rec)
            for a, got in zip(rec.agents, rec.returned):
                inner = a.track_mono

                def track_mono(img, frame_id, timestamp=None, _inner=inner,
                               _got=got):
                    out = _inner(img, frame_id, timestamp)
                    _got.append(int(frame_id))
                    return out

                a.track_mono = track_mono
            _drive(st, *rec.agents, FrameSource(frames, clock),
                   split(st.traffic))
            rec.finished = True
    except WindowClosed:
        pass
    return pairs


def _frames(a, returned, finished):
    """(attempted, posed, failed) frame counts of one agent."""
    traj_ids = {int(f) for f, _r, _T in a.trajectory}
    lost = {int(x["frame"]) for x in a.stats if x.get("lost")}
    done = traj_ids | set(returned)
    failed = lost | (done - traj_ids if finished and not traj_ids
                     else set())
    return len(done), len(traj_ids - lost), len(failed)


def counters(a) -> dict:
    return {"packets_published": int(a._published_kfs),
            "packets_integrated": int(a.packets_integrated),
            "merges": int(sum(bool(v) for v in a.merged_agents.values())),
            "realigns": int(a.n_realigns)}


def joint_keyframes(a0, finished: bool):
    """(frame ids, Tcw) of the receiver's own keyframes and of the foreign
    ones the record judges (every one in a finished pair, else those of a
    merged sender)."""
    m = a0.map
    K = int(m.n_kf)
    valid = m.kf_valid[:K].cpu().numpy()
    agent = np.asarray(a0.kf_agent[:K])
    merged = [aid for aid, v in a0.merged_agents.items() if v]
    keep = valid & ((agent == a0.agent_id)
                    | ((agent >= 0) if finished else np.isin(agent, merged)))
    return (m.kf_frame_id[:K].cpu().numpy()[keep].astype(np.int64),
            m.kf_pose[:K].cpu().numpy()[keep])


def outcomes(st: State, pairs: List[Pair]) -> outcome.Outcome:
    """Frames attempted, posed and failed of both agents; per pair the
    sender's trajectory and the receiver's joint keyframe trajectory
    against ground truth, and each agent's map."""
    out = outcome.Outcome()
    for rec in pairs:
        a0, a1 = rec.agents
        attempted, posed, failed = _frames(a1, rec.returned[1], rec.finished)
        ids, T = a1.trajectory_poses()
        out.add_session(
            finished=rec.finished, attempted=attempted, posed=posed,
            failed=failed, role="sender",
            trajectory=(np.asarray(ids, np.int64), np.asarray(T)),
            gt=rec.gt, map_arrays=outcome.map_arrays(a1.map),
            counters=counters(a1))
        attempted, posed, failed = _frames(a0, rec.returned[0], rec.finished)
        out.add_session(
            finished=rec.finished, attempted=attempted, posed=posed,
            failed=failed, role="receiver",
            trajectory=joint_keyframes(a0, rec.finished), gt=rec.gt,
            map_arrays=outcome.map_arrays(a0.map), counters=counters(a0))
    return out
