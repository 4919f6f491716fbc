"""The port's viewer (coslam_tpu_torch/viz) against coslam_tpu/viz on the
same inputs: `draw_frame`, `spanning_tree` and `draw_map` pixel-equal to
the JAX package's, the map carried across by each package's
`checkpoint.load_map` of the JAX run's saved map; then `Viewer.update`
drawing both PNGs from the port's System on the CPU."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from coslam_tpu.utils import checkpoint as jck
from coslam_tpu.viz import draw_frame as j_draw_frame
from coslam_tpu.viz import draw_map as j_draw_map
from coslam_tpu.viz import spanning_tree as j_spanning_tree
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.utils import checkpoint as tck
from coslam_tpu_torch.utils import synthetic
from coslam_tpu_torch.viz import MapViewpoint, Viewer, draw_frame, draw_map, \
    spanning_tree

# The test run splits the cores among its xdist workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_MAP = os.path.join(ROOT, "coslam_tpu_torch", "assets", "smoke_map.npz")


@pytest.mark.parametrize("state,loc", [("OK", False), ("OK", True),
                                       ("NOT_INITIALIZED", False),
                                       ("LOST", False)])
def test_draw_frame_pixel_equal(rng, state, loc):
    img = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    uv = np.concatenate([rng.uniform(-10, 170, (60, 1)),
                         rng.uniform(-10, 130, (60, 1))], 1)
    uv[:8] = np.round(uv[:8]) + 0.5                 # on pixel boundaries
    uv = uv.astype(np.float32)
    valid = rng.uniform(size=60) < 0.85
    tracked = rng.uniform(size=60) < 0.5
    kw = dict(state=state, n_kfs=7, n_points=321, n_matches=42,
              localization_only=loc)
    t = draw_frame(img, uv, valid, tracked, **kw)
    j = j_draw_frame(img, uv, valid, tracked, **kw)
    assert t.shape == j.shape == (138, 160, 3)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(draw_frame(img, uv, valid),
                                  j_draw_frame(img, uv, valid))


def test_spanning_tree_equal(rng):
    covis = rng.integers(0, 60, (24, 24))
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    covis[5, :5] = 0                       # no earlier neighbour: the last
    valid = rng.uniform(size=24) < 0.8
    valid[:2] = True
    np.testing.assert_array_equal(spanning_tree(covis, valid),
                                  j_spanning_tree(covis, valid))


@pytest.fixture(scope="module")
def maps():
    """The JAX run's saved map (K=256, P=32768), loaded by each package."""
    jm, _ = jck.load_map(SMOKE_MAP)
    tm, _ = tck.load_map(SMOKE_MAP, device="cpu")
    return jm, tm


@pytest.mark.parametrize("opts", [
    dict(),
    dict(follow=False, graph_min_weight=20, loop_edges=[(0, 5), (3, 9)]),
    dict(auto_fit=False, show_points=False,
         viewpoint=MapViewpoint(x=1.0, y=-2.0, z=-3.0, width=320,
                                height=240)),
    dict(show_graph=False, show_keyframes=False, kf_size=0.2),
])
def test_draw_map_pixel_equal(maps, opts):
    """On the map's own tensors (kf_centers and covisibility computed by
    each package) the two renderings are pixel-equal."""
    jm, tm = maps
    n_kf = int(tm.kf_valid.sum())
    cur = tm.kf_pose[n_kf - 1].numpy().copy()
    cur[0, 3] += 0.05
    tracked = np.nonzero(tm.pt_valid.numpy())[0][::7]
    kw = dict(current_T_cw=cur, tracked_pt_ids=tracked, **opts)
    t = draw_map(tm, **kw)
    j = j_draw_map(jm, **kw)
    assert t.shape == j.shape
    assert (t < 250).any()
    np.testing.assert_array_equal(t, j)


def test_viewer_update_writes_both_pngs(tmp_path):
    """The port's System resumes the saved map (the bench's 640x480 / 1000
    feature configuration), tracks two frames of its sequence, and the
    viewer draws the frame with its tracked keypoints and the map."""
    cfg = tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                 height=480),
        extractor=tcfg.ExtractorConfig(n_features=1000, max_keypoints=1024),
        tracker=tcfg.TrackerConfig(mapper_latency_frames=3))
    scene = synthetic.make_scene(600, seed=3)
    poses = synthetic.make_trajectory(360, seed=3).poses_cw[80:82]
    seq = synthetic.render_sequence(cfg.camera, synthetic.Trajectory(poses),
                                    scene)
    slam = System(cfg, device="cpu")
    tck.load_system(SMOKE_MAP, slam)
    slam.activate_localization_mode()
    out = str(tmp_path / "viz")
    viewer = Viewer(out, every=1)
    for i, img in enumerate(seq):
        slam.track_mono(img, 80 + i)
        assert slam.state == "OK"
        viewer.update(slam, img, slam.last_frame, 80 + i)
    names = sorted(os.listdir(out))
    assert names == ["frame_000080.png", "frame_000081.png",
                     "map_000080.png", "map_000081.png"]
    fr = np.asarray(Image.open(os.path.join(out, "frame_000081.png")))
    mp = np.asarray(Image.open(os.path.join(out, "map_000081.png")))
    assert fr.shape == (498, 640, 3) and mp.shape == (600, 800, 3)
    n_tracked = int((slam.last_kp_pt >= 0).sum())
    assert n_tracked > 50
    # green overlay on tracked keypoints, and the drawn frame equals
    # draw_frame on the System's own arrays
    expect = draw_frame(seq[1], slam.last_frame.uv.numpy(),
                        slam.last_frame.valid.numpy(),
                        slam.last_kp_pt.numpy() >= 0, state="OK",
                        n_kfs=int(slam.map.kf_valid.sum()),
                        n_points=int(slam.map.pt_valid.sum()),
                        n_matches=n_tracked, localization_only=True)
    np.testing.assert_array_equal(fr, expect)
    assert (mp < 250).any()
