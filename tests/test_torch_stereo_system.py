"""The stereo and RGB-D `System` of the port against coslam_tpu's: frame
by frame (`track_rgbd` / `track_stereo`) and through `run_sequence` with
`depths` / `right_images`, then `loop_closing.global_ba` on the run's map
with a depth sensor (no monocular scale restore).

The workload of tests/test_torch_stereo.py: its camera (640x480, fx=400,
bf=48), 500 features, K=32, P=8192, the cadence pinned, 12 frames of
make_scene(600, seed=3) / make_trajectory(36, seed=3).  Runs are compared
without a similarity alignment: depth fixes the scale.  Bars: the same
initialisation frame, 0 lost, keyframe count within max(1, 10%), camera
centres within 5e-3 m, metric ATE at most 5e-3 above the reference's."""

import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import loop_closing as jlc
from coslam_tpu.models.system import System as JSystem
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import loop_closing as tlc
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.utils import evaluation
from torch_depth_common import (CENTRE_BAR, FRAMES, _cfg, _tmap,
                                depth_world, world_aux)

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return depth_world()


@pytest.fixture(scope="module", params=["rgbd", "stereo"])
def runs(request, world):
    """Per sensor: the reference System fed frame by frame
    (track_rgbd / track_stereo) and through run_sequence; the port's the
    same way."""
    sensor = request.param
    aux = world_aux(world, sensor)
    kw = "depths" if sensor == "rgbd" else "right_images"
    out = {"sensor": sensor}
    for name, S, c, extra in (
            ("jax", JSystem, _cfg(jcfg, sensor), {}),
            ("port", TSystem, _cfg(tcfg, sensor), {"device": "cpu"})):
        per = S(c, enable_loop_closing=False, **extra)
        step = per.track_rgbd if sensor == "rgbd" else per.track_stereo
        for i in range(FRAMES):
            step(world["left"][i], aux[i], i)
        seq = S(c, enable_loop_closing=False, **extra)
        seq.run_sequence(world["left"], **{kw: aux})
        out[name] = {"frame": per, "seq": seq}
    return out


def _check_runs(js, ts, gt):
    jid, jT = js.trajectory_poses()
    tid, tT = ts.trajectory_poses()
    assert tid == jid and jid[0] == 0 and jid[-1] == FRAMES - 1
    for s in (js, ts):
        assert s.state == "OK"
        assert not any(st.get("lost") for st in s.stats)
    jk, tk = (sum(1 for st in s.stats if st.get("keyframe")) + 1
              for s in (js, ts))
    assert abs(tk - jk) <= max(1, 0.1 * jk), (tk, jk)
    err = np.linalg.norm(evaluation.trajectory_xyz(tT)
                         - evaluation.trajectory_xyz(jT), axis=1)
    assert err.max() <= CENTRE_BAR, err.max()
    # metric scale: no similarity alignment against the ground truth
    gx = evaluation.trajectory_xyz(gt[jid])
    ja = evaluation.ate_rmse(evaluation.trajectory_xyz(jT), gx,
                             with_scale=False)
    ta = evaluation.ate_rmse(evaluation.trajectory_xyz(tT), gx,
                             with_scale=False)
    assert ta <= ja + 5e-3, (ta, ja)


@pytest.mark.parametrize("mode", ["frame", "seq"])
def test_system_matches_reference(runs, world, mode):
    """`track_rgbd` / `track_stereo` frame by frame and `run_sequence`
    with `depths` / `right_images`: initialised on frame 0, 0 lost,
    keyframes within max(1, 10%), centres within 5e-3, metric ATE at most
    5e-3 above the reference's."""
    _check_runs(runs["jax"][mode], runs["port"][mode], world["gt"])


def test_global_ba_keeps_metric_scale(runs):
    """`global_ba` on the run's map with a depth sensor: no monocular
    scale restore, poses within 1e-3 and points within 5e-3 (absolute, or
    0.5% of their coordinates) of the reference's; poses within 2e-3 where
    the map holds two keyframes, so that every point is seen by at most
    two cameras (ROADMAP Queue 3, weakly constrained BA points)."""
    c, t = _cfg(jcfg, runs["sensor"]), _cfg(tcfg, runs["sensor"])
    jm = runs["jax"]["seq"].map
    jout = jlc.global_ba(c, jm)
    tout = tlc.global_ba(t, _tmap(jm))
    kfv = np.asarray(jm.kf_valid)
    np.testing.assert_allclose(tout.kf_pose.numpy()[kfv],
                               np.asarray(jout.kf_pose)[kfv],
                               atol=1e-3 if kfv.sum() > 2 else 2e-3)
    ptv = np.asarray(jm.pt_valid)
    np.testing.assert_allclose(tout.pt_pos.numpy()[ptv],
                               np.asarray(jout.pt_pos)[ptv], rtol=5e-3,
                               atol=5e-3)
