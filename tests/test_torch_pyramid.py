"""Port pyramid against coslam_tpu on a rendered frame (atol 1e-4: two f32
matmuls summed in another order)."""

import jax.numpy as jnp
import numpy as np
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.ops import pyramid as jpyr
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.ops import pyramid as tpyr


def test_level_shapes_and_weights_equal():
    jc, tc = jcfg.ExtractorConfig(), tcfg.ExtractorConfig()
    assert tpyr.level_shapes(480, 640, tc) == jpyr.level_shapes(480, 640, jc)
    for n_in, n_out in ((640, 533), (480, 134), (100, 100)):
        np.testing.assert_array_equal(tpyr._resize_weights(n_in, n_out),
                                      jpyr._resize_weights(n_in, n_out))


def test_build_pyramid_matches_reference():
    cam = jcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                            height=480)
    img = synthetic.render_frame(cam, synthetic.make_trajectory(4, seed=3)
                                 .poses_cw[1], synthetic.make_scene(300, seed=3))
    j = jpyr.build_pyramid(jnp.asarray(img), jcfg.ExtractorConfig())
    t = tpyr.build_pyramid(torch.from_numpy(img), tcfg.ExtractorConfig())
    assert len(j) == len(t) == 8
    for a, b in zip(j, t):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
