"""The fence around the single-agent path: the cooperative layer's merge
policy lives in models/cooperative.py and the coop functions of cli.py
alone, so a single-agent `System` gives the same trajectory and map, bit
for bit, whatever that layer does.

The run is the first frames of the loop workload of
scripts/make_torch_smoke_assets.py (step 5: 640x480, 1000 features, K=96,
P=16384, make_cylinder_scene(700, seed=5), make_loop_trajectory(115,
seed=5, frac=1.25), the keyframe throttle 3, loop closing on), on the CPU,
by two drivers: the chunked `run_sequence` (initialisation, chunked
tracking, overlapped keyframe inserts with the local BA, place
recognition) and a per-frame `track_mono` loop (the synchronous insert
and its commit).  Each driver's digests (sha256 over the trajectory and
the map's arrays) and its span sequence under the profiler (every span's
name, parent and ids, in order) were recorded from these runs before a
change to the keyframe insert's bookkeeping; a change that moves them
changed the single-agent path."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.utils import profiling, synthetic

from torch_mapping_common import digests, span_sequence

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

FRAMES = 12
DRIVERS = ("chunked", "per_frame")
DIGEST = {
    "chunked": {
        "trajectory":
            "0a25ad4b68eae9df4d342c4ecb0f1ab221966a239bcdb36c60b463860b1c2867",
        "map":
            "e377a244f0760e67fe9a79cc6b919ad252f0260a5ee17a4bf30e9544e9747904",
    },
    "per_frame": {
        "trajectory":
            "9f326a2e33d11cf3185f91e5befb01c23d49bd2c4671664649f42a2389d22c57",
        "map":
            "c8b9cf58c20c3b3fa4cf843688667b4805a6e4a2d0792b0df8b27953a8dd3f82",
    },
}
SPANS = {
    "chunked": {
        "n": 39,
        "sha256":
            "6629fcadd1d761458cd81fe972650dd85464480907fa20b6ffce3f4bbf18b4e1",
    },
    "per_frame": {
        "n": 43,
        "sha256":
            "6d1eb56e2f324520fb21176ff9759ea3b0f7090c0cd0a0952b69bac3777466bd",
    },
}


def _loop_config():
    return tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240,
                                 width=640, height=480),
        extractor=tcfg.ExtractorConfig(n_features=1000, max_keypoints=1024),
        tracker=tcfg.TrackerConfig(mapper_latency_frames=3),
        mapper=tcfg.MapperConfig(max_keyframes=96, max_points=16384))


def _run(driver: str) -> System:
    cfg = _loop_config()
    scene = synthetic.make_cylinder_scene(700, seed=5)
    traj = synthetic.make_loop_trajectory(115, seed=5, frac=1.25)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)[:FRAMES]
    s = System(cfg, device="cpu", enable_loop_closing=True)
    if driver == "chunked":
        s.run_sequence(list(seq))
    else:
        for i, img in enumerate(seq):
            s.track_mono(img, i)
    s.shutdown()
    assert s.state == "OK" and int(s.map.n_kf) >= 3
    return s


@pytest.mark.parametrize("driver", DRIVERS)
def test_single_agent_system_is_unchanged(driver):
    assert digests(_run(driver)) == DIGEST[driver]


@pytest.mark.parametrize("driver", DRIVERS)
def test_span_sequence_is_unchanged(driver):
    """The same runs under the CPU profiler: the program's spans open in
    the same order, under the same parents, with the same ids."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        s = _run(driver)
    recs = list(profiling.spans())
    profiling.clear_spans()
    assert span_sequence(recs) == SPANS[driver]
    assert digests(s) == DIGEST[driver]


def test_bow_scores_of_chosen_rows_are_those_of_every_row():
    """`KeyFrameDatabase.scores_against_all`'s `rows` (passed by the
    cooperative layer alone): without it, today's formula over every row;
    with it, the same numbers at those rows, bit for bit."""
    from coslam_tpu_torch.models.keyframe_db import KeyFrameDatabase

    cfg = _loop_config()
    db = KeyFrameDatabase(cfg, device="cpu")
    rng = np.random.default_rng(3)
    for k in range(0, 40, 2):
        row = np.zeros(db.n_words, np.float32)
        hit = rng.choice(db.n_words, 600, replace=False)
        row[hit] = rng.random(600).astype(np.float32)
        db.add_row(k, row / row.sum())
    n = max(int(db.has.sum()), 1)
    idf = np.log(n / (1.0 + (db.bows > 0).sum(0))).clip(min=0.0)
    w = db.bows * idf[None]
    w = w / np.maximum(np.abs(w).sum(1, keepdims=True), 1e-9)
    rows = np.nonzero(db.has)[0][::3]
    for k in (0, 6, 38):
        q = db.bows[k] * idf
        q = q / max(np.abs(q).sum(), 1e-9)
        every = db.scores_against_all(k)
        assert np.array_equal(every, 1.0 - 0.5 * np.abs(w - q[None]).sum(1))
        assert np.array_equal(db.scores_against_all(k, rows), every[rows])
