"""coslam_tpu_torch.scripts.pr_quality against the JAX side's
scripts/pr_quality.py (loaded from its file).

The JAX script's own run of cylinder-A (320x240, 400 features, K=192,
P=32768, 140 frames of per-frame `track_mono`) ended in the System saved in
assets/smoke_scripts_expected.npz (`pr_ckpt_*`, written by
scripts/make_torch_smoke_assets.py --scripts-only with its stats and
rows).  The JAX `run_scene` runs again here with the script module's
`System` swapped for one restored from that checkpoint that tracks nothing,
so its query loop runs on the JAX run's end state; the port's
`score_queries` runs on the same checkpoint through `load_system`.  Bars:
keyframes, stats and per-query rows equal (integers exactly), the BoW
scores of each query's ground truth within 1e-6, and both equal to what the
JAX run wrote."""

import os
import sys

import numpy as np
import pytest
import torch

from coslam_tpu.utils import checkpoint as jckpt
from coslam_tpu.utils import synthetic as jsyn
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.scripts import pr_quality as tpq
from coslam_tpu_torch.utils import checkpoint as tckpt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

ASSET = os.path.join(os.path.dirname(__file__), "..", "coslam_tpu_torch",
                     "assets", assets.SCRIPTS_ASSET)
NAME, SEED, N_PTS, RADIUS, FRAMES = tpq.SCENES[0]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    ex = dict(np.load(ASSET))
    path = str(tmp_path_factory.mktemp("pr") / "system.npz")
    np.savez(path, **{k[8:]: v for k, v in ex.items()
                      if k.startswith("pr_ckpt_")})
    return ex, path


@pytest.fixture(scope="module")
def jax_scene(saved):
    """The JAX run_scene's (K, stats, rows) and System on the saved
    state."""
    _, path = saved
    jpq = assets.jax_script("pr_quality")
    made = []

    class Restored(jpq.System):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            jckpt.load_system(path, self)
            made.append(self)

        def track_mono(self, img, frame_id):
            pass

    jpq.System = Restored
    scene = jsyn.make_cylinder_scene(N_PTS, radius=RADIUS, seed=SEED)
    traj = jsyn.make_loop_trajectory(FRAMES, seed=SEED, frac=1.25)
    return (jpq.run_scene(NAME, scene, traj, FRAMES,
                          assets.pr_quality_config()), made[0])


def test_the_jax_query_loop_reproduces_the_jax_run(saved, jax_scene):
    ex, _ = saved
    (K, stats, rows), _ = jax_scene
    assert K == int(ex["pr_K"]) and stats["n_q"] > 0
    assert list(stats) == list(ex["pr_stat_keys"]) == list(tpq.STAT_KEYS)
    assert list(stats.values()) == ex["pr_stats"].tolist()
    assert [list(r[:4]) for r in rows] == ex["pr_rows"].tolist()
    assert [r[4] for r in rows] == ex["pr_top3"].tolist()


def test_score_queries_equal_the_jax_run_scene(saved, jax_scene):
    _, path = saved
    (jK, jstats, jrows), jslam = jax_scene
    cfg = tpq.cfg_for(320, 240)
    slam = TSystem(cfg, device="cpu", enable_loop_closing=False)
    tckpt.load_system(path, slam)
    K, stats, rows = tpq.score_queries(cfg, slam, FRAMES)
    assert (K, stats) == (jK, jstats)
    assert [r[:5] for r in rows] == [r[:5] for r in jrows]
    np.testing.assert_allclose([r[5] for r in rows], [r[5] for r in jrows],
                               rtol=0, atol=1e-6)
    got = [slam.db.scores_against_all(r[0])[r[2]] for r in rows]
    want = [jslam.db.scores_against_all(r[0])[r[2]] for r in jrows]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_run_scene_tracks_on_the_asked_device():
    """The tracking half on the first frames of cylinder-A, on the CPU."""
    name, scene, traj, n, cfg = tpq.scenes()[0]
    assert (name, n, cfg.camera.width, cfg.extractor.n_features) == \
        (NAME, FRAMES, 320, 400)
    slam = tpq.run_scene(name, scene, traj, 3, cfg, "cpu")
    assert slam.device.type == "cpu" and slam.loop_closer is None
    assert slam.stats[-1]["frame"] == 2
