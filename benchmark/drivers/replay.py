"""Closed-loop replay of recorded sequences: back-to-back sessions, each a
fresh `System` and one `System.run_sequence` (then `shutdown`) over one of
the mix's fixed set of sequences (`scene_seeds`, `trajectory_seeds`),
taken in turn from an entry drawn from the seed.  So every seed plays the
same sequences in another order: the tracker's decisions are chaotic, and
sequences of their own per seed would change the work from seed to seed.
The sequences do not depend on the seed: `render.fixed_sequences` renders
them once per checkout and every later run's set-up reads them from its
cache.  The window ends at
the first frame `run_sequence` pulls after the deadline, or at the start
of the next session."""

from __future__ import annotations

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
    first: int                      # the pool entry the first session plays
    device: str
    n_sessions: int = 0


@dataclass
class Session:
    system: object
    source: FrameSource
    gt: np.ndarray
    returned: List[int] = field(default_factory=list)
    finished: bool = False


def setup(cell, seed: int, device: str = "cuda", workers=None,
          stamp=lambda what: None) -> State:
    sequences, first = render.fixed_sequences(cell, seed, workers)
    stamp("inputs")
    st = State(cfg=program.system_config(cell.config), config=cell.config,
               traffic=cell.traffic, sequences=sequences, first=first,
               device=device)
    # warm-up: the first frames of a session (initialisation, chunked
    # tracking, keyframe inserts, place recognition) on a System of its own
    s = _system(st)
    s.run_sequence(sequences[first][0][:int(cell.traffic["warmup_frames"])])
    s.shutdown()
    stamp("warm-up")
    return st


def _system(st: State):
    from coslam_tpu_torch.models.system import System
    s = System(st.cfg, device=st.device,
               enable_loop_closing=bool(st.config["enable_loop_closing"]))
    program.pin_mapper_cycle(s, st.config["mapper_cycle_s"])
    return s


def run_window(st: State, clock: Clock) -> List[Session]:
    sessions: List[Session] = []
    try:
        while True:
            clock.pull()                      # the next session's input
            s = _system(st)
            frames, gt = st.sequences[(st.first + st.n_sessions)
                                      % len(st.sequences)]
            st.n_sessions += 1
            rec = Session(system=s, source=FrameSource(frames, clock), gt=gt)
            sessions.append(rec)
            inner = s.track_mono

            def track_mono(img, frame_id, timestamp=None, _inner=inner,
                           _rec=rec):
                out = _inner(img, frame_id, timestamp)
                _rec.returned.append(int(frame_id))
                return out

            s.track_mono = track_mono
            s.run_sequence(rec.source)
            s.shutdown()
            rec.finished = True
    except WindowClosed:
        pass
    return sessions


def outcomes(st: State, sessions: List[Session]) -> outcome.Outcome:
    """Frames attempted, posed and failed; per session the trajectory
    against ground truth and the map the reference judges."""
    out = outcome.Outcome()
    for rec in sessions:
        s = rec.system
        traj_ids = {int(f) for f, _r, _T in s.trajectory}
        lost = {int(x["frame"]) for x in s.stats if x.get("lost")}
        done = traj_ids | set(rec.returned)
        initialised = bool(traj_ids)
        failed = lost | (done - traj_ids if rec.finished and not initialised
                         else set())
        posed = traj_ids - lost
        ids, T = s.trajectory_poses()
        out.add_session(
            finished=rec.finished, attempted=len(done), posed=len(posed),
            failed=len(failed),
            trajectory=(np.asarray(ids, np.int64), np.asarray(T)),
            gt=rec.gt,
            map_arrays=outcome.map_arrays(s.map),
            counters={"n_frames_chunked": s.n_frames_chunked,
                      "n_frames_discarded": s.n_frames_discarded,
                      "loops_closed": s.n_loops_closed})
    return out
