"""The chunk tracker as one CUDA graph (`tracking.ChunkGraphs`) on the card.

Over the first sequence of the benchmark's `tum-fr1-mono.replay` cell,
through `System.run_sequence` in two halves (two padded tails), for two
Systems in one process: every chunk's replay equals the eager body
(`tracking.track_chunk_eager`) on the same inputs bit for bit, overlapped
keyframe inserts queued between chunks; a replay writes none of the tensors
the previous chunk handed out; one capture serves both Systems, every
chunk runs as the graph, and counts the kernel launches the eager body
would.  Stereo and RGB-D chunks likewise, on the depth
tests' rendered pairs.

Marked `cuda`: every test skips where torch.cuda.is_available() is False.
On a GPU machine (which need not have jax, so skip tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_chunk_graph.py
"""

import numpy as np
import pytest
import torch

from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import local_mapping, tracking
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda


def _flat(v):
    if isinstance(v, torch.Tensor):
        return [v]
    return [t for x in v for t in _flat(x)]


class Probe:
    """`tracking.track_chunk` and `local_mapping.backend_insert` wrapped
    where System calls them.  Per chunk: how it ran, its outputs against
    the eager body's on the same inputs, whether its images end padded,
    and whether the previous chunk's outputs came through this chunk's
    replay unchanged (snapshot before the call, compared after it)."""

    def __init__(self, mp):
        self.take()
        real, real_insert = tracking.track_chunk, local_mapping.backend_insert

        def chunk(cfg, m, imgs, allow_kf, carry, aux_imgs=None,
                  mapper_latency=None):
            snap = None if self._prev is None \
                else [t.clone() for t in self._prev]
            n0 = dict(ck.LAUNCHES)
            out = real(cfg, m, imgs, allow_kf, carry, aux_imgs,
                       mapper_latency)
            self.modes.append(tracking.CHUNK_GRAPHS.last)
            if snap is not None:
                self.intact.append(all(torch.equal(a, b)
                                       for a, b in zip(self._prev, snap)))
            n1 = dict(ck.LAUNCHES)
            ref = tracking.track_chunk_eager(cfg, m, imgs, allow_kf, carry,
                                             aux_imgs, mapper_latency)
            n2 = dict(ck.LAUNCHES)
            self.launches.append(({k: n1[k] - n0[k] for k in n0},
                                  {k: n2[k] - n1[k] for k in n0}))
            got = _flat(out)
            self.equal.append(all(a.dtype == b.dtype and torch.equal(a, b)
                                  for a, b in zip(got, _flat(ref))))
            self.padded += bool(torch.equal(imgs[-1], imgs[-2]))
            self.events.append("chunk")
            self._prev = got
            return out

        def insert(*args, **kw):
            self.events.append("insert")
            return real_insert(*args, **kw)

        mp.setattr(tracking, "track_chunk", chunk)
        mp.setattr(local_mapping, "backend_insert", insert)

    def take(self) -> dict:
        log = {k: getattr(self, k, None) for k in
               ("modes", "equal", "intact", "padded", "events", "launches")}
        self.modes, self.equal, self.intact, self.events = [], [], [], []
        self.launches = []
        self.padded, self._prev = 0, None
        return log


def _two_halves(s: System, frames, **aux):
    half = len(frames) // 2 + 3
    s.run_sequence(frames[:half], **{k: v[:half] for k, v in aux.items()})
    s.run_sequence(frames[half:], frame_ids=list(range(half, len(frames))),
                   **{k: v[half:] for k, v in aux.items()})
    return s.shutdown()


@pytest.fixture(scope="module")
def replay_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chunk graph is a CUDA graph")
    from benchmark.harness import program, render, spec
    cell = spec.cell("tum-fr1-mono.replay")
    frames, _gt = render.fixed_sequences(cell, 0)[0][0]
    cfg = program.system_config(cell.config)
    tracking.CHUNK_GRAPHS.clear()
    captures = tracking.CHUNK_GRAPHS.captures
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        probe = Probe(mp)
        for _ in range(2):
            s = System(cfg, device="cuda", enable_loop_closing=bool(
                cell.config["enable_loop_closing"]))
            program.pin_mapper_cycle(s, cell.config["mapper_cycle_s"])
            info = _two_halves(s, frames)
            runs.append((s, info, probe.take()))
    return runs, tracking.CHUNK_GRAPHS.captures - captures


def test_replays_equal_eager(replay_runs):
    runs, _captures = replay_runs
    for _s, _info, log in runs:
        assert log["equal"] and all(log["equal"])
        assert log["padded"] >= 1
        ev = log["events"]
        assert any(ev[i - 1:i + 2] == ["chunk", "insert", "chunk"]
                   for i in range(1, len(ev) - 1)), ev


def test_replay_leaves_handed_out_tensors(replay_runs):
    runs, _captures = replay_runs
    for _s, _info, log in runs:
        assert log["intact"] and all(log["intact"])


def test_every_chunk_graphed_one_capture(replay_runs):
    runs, captures = replay_runs
    assert captures == 1
    (_s1, _i1, log1), (_s2, _i2, log2) = runs
    assert log1["modes"][0] == "capture"
    assert set(log1["modes"][1:]) == {"replay"}
    assert set(log2["modes"]) == {"replay"}
    for s, info, log in runs:
        assert s.n_chunks_graphed == info["chunks_graphed"] \
            == len(log["modes"])


def test_replay_counts_the_eager_launches(replay_runs):
    """A replayed chunk adds to cuda_kernels.LAUNCHES what the eager body
    adds: K1 once a frame, K3 four times (two motion-model radii, the
    reference-keyframe candidate, the local map), launched from the host
    between the graph's segments."""
    runs, _captures = replay_runs
    C = runs[0][0].cfg.tracker.chunk_frames
    for _s, _info, log in runs:
        for graphed, eager in log["launches"]:
            assert graphed == eager
            assert graphed["fast_score_nms"] == C
            assert graphed["pose_opt_lm"] == 4 * C


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_depth_sensor_chunks(sensor):
    """The depth tests' workload (tests/torch_depth_common.py: 640x480,
    bf 48, 512 keypoints, K=32, P=8192), 24 frames: each chunk replays
    the graph and equals the eager body."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chunk graph is a CUDA graph")
    from coslam_tpu_torch.utils import synthetic
    cfg = tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                 height=480, bf=48.0),
        extractor=tcfg.ExtractorConfig(n_features=500, max_keypoints=512),
        tracker=tcfg.TrackerConfig(mapper_latency_frames=3),
        mapper=tcfg.MapperConfig(max_keyframes=32, max_points=8192),
        sensor=sensor)
    scene = synthetic.make_scene(600, seed=3)
    poses = synthetic.make_trajectory(36, seed=3).poses_cw[:24]
    if sensor == "stereo":
        pairs = [synthetic.render_stereo_frame(cfg.camera, T, scene,
                                               baseline=0.12) for T in poses]
        frames = np.stack([p[0] for p in pairs])
        aux = {"right_images": np.stack([p[1] for p in pairs])}
    else:
        frames = synthetic.render_sequence(cfg.camera,
                                           synthetic.Trajectory(poses), scene)
        aux = {"depths": np.stack([synthetic.render_depth(cfg.camera, T,
                                                          scene)
                                   for T in poses])}
    with pytest.MonkeyPatch.context() as mp:
        probe = Probe(mp)
        s = System(cfg, device="cuda")
        _two_halves(s, frames, **aux)
        log = probe.take()
    assert log["equal"] and all(log["equal"])
    assert all(log["intact"])
    assert "eager" not in log["modes"]
    assert s.n_chunks_graphed == len(log["modes"])
