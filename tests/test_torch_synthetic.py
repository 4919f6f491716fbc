"""The port's numpy copies of utils/synthetic.py and utils/evaluation.py give
the reference's output bit for bit."""

import numpy as np
import pytest

from coslam_tpu import config as jcfg
from coslam_tpu.utils import evaluation as jev
from coslam_tpu.utils import synthetic as jsyn
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.utils import evaluation as tev
from coslam_tpu_torch.utils import synthetic as tsyn


@pytest.mark.parametrize("distort", [False, True])
def test_rendered_frames_equal(distort):
    jc = jcfg.tum_fr1_config().camera if distort else jcfg.CameraConfig(
        fx=400, fy=400, cx=320, cy=240, width=640, height=480)
    tc = tcfg.CameraConfig(**{f: getattr(jc, f) for f in
                              jc.__dataclass_fields__})
    js, ts = jsyn.make_scene(300, seed=3), tsyn.make_scene(300, seed=3)
    jt, tt = jsyn.make_trajectory(12, seed=3), tsyn.make_trajectory(12, seed=3)
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(tt.poses_cw, jt.poses_cw)
    for i in (0, 7):
        a = jsyn.render_frame(jc, jt.poses_cw[i], js, distort=distort)
        b = tsyn.render_frame(tc, tt.poses_cw[i], ts, distort=distort)
        np.testing.assert_array_equal(b, a)


def test_sequence_and_evaluation_equal(rng):
    cam_j = jcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=320,
                              height=240)
    cam_t = tcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=320,
                              height=240)
    js, ts = jsyn.make_scene(200, seed=1), tsyn.make_scene(200, seed=1)
    jt = jsyn.make_trajectory(4, seed=1)
    tt = tsyn.make_trajectory(4, seed=1)
    np.testing.assert_array_equal(tsyn.render_sequence(cam_t, tt, ts),
                                  jsyn.render_sequence(cam_j, jt, js))
    est = jt.centers + rng.normal(0, 0.01, jt.centers.shape)
    assert tev.ate_rmse(est, tt.centers) == jev.ate_rmse(est, jt.centers)
    assert tev.rpe(jt.poses_cw, tt.poses_cw) == jev.rpe(jt.poses_cw,
                                                         jt.poses_cw)
