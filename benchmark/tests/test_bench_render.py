"""The harness's renderer copy equals the port's utils/synthetic.py at a
small size: scene, trajectory and frames, with and without a lens."""

import dataclasses

import numpy as np
import pytest

from benchmark.tests import bench_common  # noqa: F401
from benchmark.harness import render


@pytest.mark.parametrize("distorted", [False, True])
def test_renderer_copy_equals_the_port(distorted):
    from coslam_tpu_torch.config import CameraConfig
    from coslam_tpu_torch.utils import synthetic

    cam = CameraConfig(fx=258.65, fy=258.23, cx=159.3, cy=127.7,
                       width=320, height=240,
                       **(dict(k1=0.262383, k2=-0.953104, p1=-0.005358,
                               p2=0.002628, k3=1.163314) if distorted
                          else {}))
    lens = render.Lens.of(dataclasses.asdict(cam))
    a = synthetic.make_cylinder_scene(300, seed=2**31 + 7)
    b = render.make_cylinder_scene(300, seed=2**31 + 7)
    for f in ("points", "point_phase", "point_tex"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    ta = synthetic.make_loop_trajectory(12, seed=5, frac=1.25).poses_cw
    tb = render.make_loop_trajectory(12, seed=5, frac=1.25)
    assert np.array_equal(ta, tb)
    for i in (0, 7):
        assert np.array_equal(
            synthetic.render_frame(cam, ta[i], a, distort=distorted),
            render.render_frame(lens, tb[i], b, distort=distorted))


def test_parallel_rendering_equals_serial():
    lens = render.Lens(fx=200.0, fy=200.0, cx=80.0, cy=60.0, width=160,
                       height=120)
    scene = render.make_cylinder_scene(200, seed=1)
    poses = render.make_loop_trajectory(4, seed=1)
    assert np.array_equal(render.render_frames(lens, poses, scene, 2),
                          render.render_frames(lens, poses, scene, 1))
