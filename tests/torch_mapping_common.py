"""Shared pieces of the mapping parity tests (tests/test_torch_mapping.py,
tests/test_torch_compaction.py): the workload, a reference System that
records its initialisation draws, and the run-agreement bars."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import system as jsystem
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.utils import synthetic
from coslam_tpu_torch.utils import evaluation

# The test run splits the cores among its xdist workers; torch's own
# intra-op pool on top of that spins against the other workers' threads.
torch.set_num_threads(1)

FRAMES = 20
CENTRE_BAR = 5e-3


def mapping_cfg(mod, K=32):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        tracker=mod.TrackerConfig(mapper_latency_frames=3),
        mapper=mod.MapperConfig(max_keyframes=K, max_points=4096))


class DrawRecorder(JSystem):
    """The reference System, recording each initialisation attempt's
    draws exactly as `twoview.initialize` makes them."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.draws = {}

    def _try_initialize(self, frame, frame_id):
        if self.ref_frame is not None:
            mm = jsystem._match_for_init(self.cfg, self.ref_frame, frame)
            p = mm.valid.astype(jnp.float32)
            p = p / (p.sum() + 1e-9)
            key = jax.random.fold_in(self._init_key, frame_id)
            self.draws[frame_id] = np.asarray(jax.random.choice(
                key, frame.uv.shape[0], (self.cfg.tracker.ransac_iters, 8),
                replace=True, p=p))
        return super()._try_initialize(frame, frame_id)


def sequence():
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(36, seed=3)
    cam = mapping_cfg(jcfg).camera
    return synthetic.render_sequence(cam, traj, scene)[:FRAMES]


def assert_runs_agree(js, ts):
    jid, jT = js.trajectory_poses()
    tid, tT = ts.trajectory_poses()
    assert tid == jid
    for s in (js, ts):
        assert not any(st.get("lost") for st in s.stats)
    assert [st["frame"] for st in ts.stats] == \
        [st["frame"] for st in js.stats]
    assert [st["frame"] for st in ts.stats if st.get("keyframe")] == \
        [st["frame"] for st in js.stats if st.get("keyframe")]
    ji = np.array([st["inliers"] for st in js.stats])
    ti = np.array([st["inliers"] for st in ts.stats])
    assert (np.abs(ti - ji) <= np.maximum(3, 0.05 * ji)).all(), (ti, ji)
    err = np.linalg.norm(evaluation.trajectory_xyz(tT)
                         - evaluation.trajectory_xyz(jT), axis=1)
    assert err.max() <= CENTRE_BAR, err.max()
    assert int(ts.map.kf_valid.sum()) == int(np.asarray(js.map.kf_valid).sum())
    assert ts._host_n_kf == js._host_n_kf
    assert ts.cfg.mapper.max_keyframes == js.cfg.mapper.max_keyframes
