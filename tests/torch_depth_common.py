"""Shared pieces of the stereo / RGB-D parity tests
(tests/test_torch_stereo.py, tests/test_torch_stereo_system.py): the
workload — tests/test_stereo_rgbd.py's camera (640x480, fx=400, bf=48: a
12 cm baseline), 500 features / 512 keypoints, K=32, P=8192, the keyframe
cadence pinned, 12 frames of make_scene(600, seed=3) /
make_trajectory(36, seed=3) — and the conversions."""

import numpy as np
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.utils import synthetic
from coslam_tpu_torch.models import map_state as tms

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

FRAMES = 12
CENTRE_BAR = 5e-3
BASELINE = 0.12


def _cfg(mod, sensor="stereo", bf=400 * BASELINE):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480, bf=bf),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        tracker=mod.TrackerConfig(mapper_latency_frames=3),
        mapper=mod.MapperConfig(max_keyframes=32, max_points=8192),
        sensor=sensor)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _tkps(kps):
    return {k: _t(v) for k, v in kps.items()}


def _tmap(jm):
    return tms.MapState(**{k: _t(v) for k, v in jm._asdict().items()})


def depth_world():
    cam = _cfg(jcfg).camera
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(36, seed=3)
    left, right, depth = [], [], []
    for T in traj.poses_cw[:FRAMES]:
        lt, rt = synthetic.render_stereo_frame(cam, T, scene,
                                               baseline=BASELINE)
        left.append(lt)
        right.append(rt)
        depth.append(synthetic.render_depth(cam, T, scene))
    return dict(left=np.stack(left), right=np.stack(right),
                depth=np.stack(depth), gt=traj.poses_cw[:FRAMES])


def world_aux(world, sensor):
    return world["depth"] if sensor == "rgbd" else world["right"]
